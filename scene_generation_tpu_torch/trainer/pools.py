"""The per-class appearance-vector replay pool on the device (port of the
JAX package's ``trainer/pools.py``).

  vecs   (num_classes, pool_size, rep_size)
  counts (num_classes,) int64

``pool_query`` gives each object a stored vector of its class (its own
vector while the class is empty) and inserts its current vector. The
semantics are the JAX package's: below capacity, a within-batch rank gives
each same-class object a distinct append slot; at capacity, the read slot
is (per-class random base + rank) mod count, so same-class objects read
and overwrite distinct slots; invalid slots neither read nor write. The
random base is drawn by ``draw_base`` and passed in, so a test can inject
the JAX package's draw.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from scene_generation_tpu_torch.parallel.data_parallel import (Collectives,
                                                               gather)


class VectorPool(NamedTuple):
    vecs: torch.Tensor      # (C, P, R)
    counts: torch.Tensor    # (C,) int64


def create_pool(num_classes: int, pool_size: int, rep_size: int,
                device=None, dtype: torch.dtype = torch.float32
                ) -> VectorPool:
    return VectorPool(
        torch.zeros((num_classes, pool_size, rep_size), dtype=dtype,
                    device=device),
        torch.zeros((num_classes,), dtype=torch.long, device=device))


def draw_base(pool: VectorPool, gen: torch.Generator) -> torch.Tensor:
    """Per-class uniform integer in [0, max(count, 1)), on the pool's
    device, without a host sync."""
    high = torch.clamp(pool.counts, min=1)
    u = torch.rand(high.shape, generator=gen, device=high.device)
    return torch.minimum((u * high).long(), high - 1)


@torch.no_grad()
def pool_query(pool: VectorPool, base: torch.Tensor, objs: torch.Tensor,
               reprs: torch.Tensor, obj_mask: torch.Tensor
               ) -> Tuple[torch.Tensor, VectorPool]:
    """Query and update the pool for a flat batch of objects.

    Args:
      base: (C,) int per-class random read base (``draw_base``).
      objs: (B,) int class ids.
      reprs: (B, R) current appearance vectors (taken without gradient).
      obj_mask: (B,) validity; invalid slots neither read nor write.
    Returns:
      (wrong_reprs (B, R), the updated pool).
    """
    num_classes, pool_size, _ = pool.vecs.shape
    objs = objs.long()
    valid = obj_mask.bool()
    counts_per_obj = pool.counts[objs]                              # (B,)
    one_hot = F.one_hot(objs, num_classes) * valid[:, None].long()
    rank = torch.gather(torch.cumsum(one_hot, 0) - one_hot, 1,
                        objs[:, None])[:, 0]                        # (B,)
    read_slot = (base.long()[objs] + rank) % torch.clamp(counts_per_obj,
                                                          min=1)
    read_slot = torch.clamp(read_slot, 0, pool_size - 1)
    stored = pool.vecs[objs, read_slot]                             # (B, R)
    wrong = torch.where((counts_per_obj == 0)[:, None], reprs, stored)

    # Append below capacity (rank keeps same-class slots distinct), else
    # overwrite the read slot.
    append_slot = counts_per_obj + rank
    write_slot = torch.clamp(
        torch.where(append_slot < pool_size, append_slot, read_slot),
        0, pool_size - 1)
    # Invalid objects write into a spare class row that is dropped.
    write_cls = torch.where(valid, objs, num_classes)
    vecs = torch.cat([pool.vecs, pool.vecs.new_zeros(pool.vecs[:1].shape)])
    vecs[write_cls, write_slot] = reprs.to(vecs.dtype)
    counts = torch.clamp(pool.counts + one_hot.sum(0), max=pool_size)
    return wrong.to(reprs.dtype), VectorPool(vecs[:num_classes], counts)


@torch.no_grad()
def pool_query_gathered(comm: Collectives, pool: VectorPool,
                        base: torch.Tensor, objs: torch.Tensor,
                        reprs: torch.Tensor, obj_mask: torch.Tensor
                        ) -> Tuple[torch.Tensor, VectorPool]:
    """``pool_query`` of the global batch under data parallelism: every
    rank's objects, vectors and mask gathered in rank order (one
    collective), queried alike on every rank, so the pool stays
    replicated; returns this rank's rows of ``wrong_reprs`` (in one
    process, ``pool_query`` of the batch)."""
    packed = torch.cat([objs.float()[:, None], obj_mask.float()[:, None],
                        reprs.float()], 1)
    every = gather(comm, packed)
    wrong, pool = pool_query(pool, base, every[:, 0].long(),
                             every[:, 2:].to(reprs.dtype), every[:, 1])
    n = objs.shape[0]
    return wrong[comm.rank * n:(comm.rank + 1) * n], pool
