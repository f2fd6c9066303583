"""Scene-graph convolution on the padded batch (port of the JAX package's
``models/graph.py``).

One layer gathers the (subject, object) vectors of each triple, runs
``[s, p, o]`` through ``net1``, splits the result into new (s, p, o)
pieces, average-pools s and o back onto the objects and runs ``net2``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from scene_generation_tpu_torch.models.layers import MLP
from scene_generation_tpu_torch.ops.graph_ops import (segment_pool_objects,
                                                      triple_gather)


class GraphTripleConv(nn.Module):
    """One scene-graph conv layer."""

    def __init__(self, input_dim: int, attributes_dim: int = 0,
                 output_dim: Optional[int] = None, hidden_dim: int = 512,
                 pooling: str = "avg", mlp_normalization: str = "none"):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.output_dim = input_dim if output_dim is None else output_dim
        self.pooling = pooling
        h, dout = hidden_dim, self.output_dim
        self.net1 = MLP((3 * input_dim + 2 * attributes_dim, h, 2 * h + dout),
                        batch_norm=mlp_normalization)
        self.net2 = MLP((h, h, dout), batch_norm=mlp_normalization)

    def forward(self, obj_vecs: torch.Tensor, pred_vecs: torch.Tensor,
                edges: torch.Tensor, triple_mask: torch.Tensor,
                obj_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(N, O, Din+A) objects, (N, T, Din) predicates, (N, T, 2) local
        [s, o] edges, (N, T) triple validity -> ((N, O, Dout), (N, T, Dout)).
        ``obj_mask`` weights net2's batch statistics when it normalizes."""
        h, dout = self.hidden_dim, self.output_dim
        n, o = obj_vecs.shape[:2]
        t = pred_vecs.shape[1]
        s_vecs, o_vecs = triple_gather(obj_vecs, edges)
        t_vecs = torch.cat([s_vecs, pred_vecs, o_vecs], dim=-1)
        new_t = self.net1(t_vecs.reshape(n * t, -1),
                          triple_mask.reshape(n * t)).reshape(n, t, -1)
        new_s = new_t[..., :h]
        new_p = new_t[..., h:h + dout]
        new_o = new_t[..., h + dout:2 * h + dout]
        pooled = segment_pool_objects(new_s, new_o, edges, triple_mask, o,
                                      pooling=self.pooling)
        ow = obj_mask.reshape(n * o) if obj_mask is not None else None
        new_obj = self.net2(pooled.reshape(n * o, -1), ow).reshape(n, o, -1)
        return new_obj, new_p


class GraphTripleConvNet(nn.Module):
    """A stack of identical ``GraphTripleConv`` layers."""

    def __init__(self, input_dim: int, num_layers: int = 5,
                 hidden_dim: int = 512, pooling: str = "avg",
                 mlp_normalization: str = "none"):
        super().__init__()
        self.layers = nn.ModuleList(
            GraphTripleConv(input_dim, hidden_dim=hidden_dim, pooling=pooling,
                            mlp_normalization=mlp_normalization)
            for _ in range(num_layers))

    def forward(self, obj_vecs, pred_vecs, edges, triple_mask, obj_mask=None):
        for layer in self.layers:
            obj_vecs, pred_vecs = layer(obj_vecs, pred_vecs, edges,
                                        triple_mask, obj_mask)
        return obj_vecs, pred_vecs
