"""Data parallelism across processes (the counterpart of the JAX package's
``parallel/``); see ``data_parallel.py``."""
from scene_generation_tpu_torch.parallel.data_parallel import (
    SINGLE, Collectives, TorchDistributed, all_reduce_sum, any_rank,
    current, gather, init_process_group, reduce_grads, step_shard,
    verify_replicated)

__all__ = ["SINGLE", "Collectives", "TorchDistributed", "all_reduce_sum",
           "any_rank", "current", "gather", "init_process_group",
           "reduce_grads", "step_shard", "verify_replicated"]
