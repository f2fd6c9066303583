"""The benchmark of the PyTorch and CUDA port (``scene_generation_tpu_torch``).

``python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell once; ``BENCHMARK.json`` at the checkout's
root lists the cells. Nothing here imports JAX or the JAX package.
"""
