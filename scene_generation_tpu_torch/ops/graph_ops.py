"""Scene-graph gather / pool primitives on the padded (N, O) / (N, T) axes
(port of the JAX package's ``ops/graph_ops.py``)."""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def triple_gather(obj_vecs: torch.Tensor, edges: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, O, D) vectors, (N, T, 2) local [s, o] indices -> two (N, T, D)."""
    d = obj_vecs.shape[-1]
    s_idx = edges[..., 0].long()[..., None].expand(-1, -1, d)
    o_idx = edges[..., 1].long()[..., None].expand(-1, -1, d)
    return (torch.gather(obj_vecs, 1, s_idx),
            torch.gather(obj_vecs, 1, o_idx))


def segment_pool_objects(new_s: torch.Tensor, new_o: torch.Tensor,
                         edges: torch.Tensor, triple_mask: torch.Tensor,
                         num_objs: int, pooling: str = "avg") -> torch.Tensor:
    """Pool per-triple messages back onto objects (reference graph.py:94-116).

    Each valid triple adds its new subject vector to object ``s`` and its
    new object vector to object ``o``; ``avg`` divides by the per-object
    count clamped at 1, so objects in no triple get zeros.

    Returns (N, O, H).
    """
    dtype = new_s.dtype
    tm = triple_mask.to(dtype)[..., None]                              # (N,T,1)
    onehot_s = F.one_hot(edges[..., 0].long(), num_objs).to(dtype) * tm
    onehot_o = F.one_hot(edges[..., 1].long(), num_objs).to(dtype) * tm
    pooled = (torch.einsum("nto,nth->noh", onehot_s, new_s)
              + torch.einsum("nto,nth->noh", onehot_o, new_o))
    if pooling == "avg":
        counts = onehot_s.sum(dim=1) + onehot_o.sum(dim=1)             # (N,O)
        counts = torch.clamp(counts, min=1.0)
        pooled = pooled / counts[..., None]
    elif pooling != "sum":
        raise ValueError(f"Invalid pooling '{pooling}'")
    return pooled
