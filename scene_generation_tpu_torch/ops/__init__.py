"""Tensor ops of the port: sampling matrices, scene-graph gather/pool, the
layout compositor and the generator stem (the last two with CUDA kernels
in ``csrc/``, built by ``_cuda``)."""
