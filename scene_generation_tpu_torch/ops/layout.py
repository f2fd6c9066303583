"""Layout composition: per-object vectors + boxes + masks -> spatial layout
(port of the JAX package's ``ops/layout.py``).

The mask is resampled once per object (``ry @ mask @ rx^T``) and contracted
with the object's vector afterwards, instead of resampling all D channels.
Test mode composites by occlusion: objects sorted by sampled mass,
ascending, each claims the still-unclaimed pixels where its resampled mask
is above 0.5.

Shapes follow the padded batch contract: leading (N, O) with a validity
mask. Layouts are NHWC, as in the JAX package.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from scene_generation_tpu_torch.ops.compositor import composite
from scene_generation_tpu_torch.ops.sampling import (box_sample_matrices,
                                                      exact_f32_matmul)


def _sample_masks(boxes: torch.Tensor, masks: torch.Tensor, h: int,
                  w: int) -> torch.Tensor:
    """Resample (N, O, M, M) masks into image space -> (N, O, H, W)."""
    m = masks.shape[-1]
    ry, rx = box_sample_matrices(boxes, h, w, m)        # (N,O,H,M), (N,O,W,M)
    with exact_f32_matmul():
        return ry @ masks.to(ry.dtype) @ rx.transpose(-1, -2)


def masks_to_layout_weights(vecs: torch.Tensor, boxes: torch.Tensor,
                            masks: torch.Tensor, obj_mask: torch.Tensor,
                            h: int, w: Optional[int] = None,
                            test_mode: bool = False,
                            occlusion_impl: str = "matrix") -> torch.Tensor:
    """Per-object weights of the layout's rank-O factorization.

    ``layout[n,y,x,:] = sum_o weights[n,o,y,x] * vecs[n,o,:]`` in both
    modes; train mode sums the resampled masks, test mode keeps only each
    object's occlusion claims. Returns (N, O, H, W) in the original slot
    order; invalid slots are all zero.

    ``occlusion_impl`` picks the test-mode form: ``matrix`` (a precedence
    matrix, ties in mass broken by slot index) or ``sort`` (argsort and an
    exclusive cumulative claim); both give the same weights.
    """
    w = h if w is None else w
    dtype = vecs.dtype
    sampled = _sample_masks(boxes, masks.to(dtype), h, w)
    valid = obj_mask.to(dtype)[:, :, None, None]
    sampled = sampled * valid
    if not test_mode:
        return sampled

    mass = vecs.sum(-1) * sampled.sum((-1, -2))                      # (N,O)
    mass = torch.where(obj_mask.bool(), mass, torch.finfo(dtype).max)
    binm = (sampled > 0.5).to(dtype) * valid                         # (N,O,H,W)

    if occlusion_impl == "matrix":
        # precede[n,p,o] = 1 iff p comes before o in the stable
        # mass-ascending order; the claimed-before count is then one
        # (O, O) x (O, HW) product of 0/1 values, exact in any precision.
        o_idx = torch.arange(mass.shape[1], device=mass.device)
        lt = mass[:, :, None] < mass[:, None, :]
        tie = ((mass[:, :, None] == mass[:, None, :])
               & (o_idx[:, None] < o_idx[None, :]))
        precede = (lt | tie).to(dtype)                               # (N,P,O)
        n, o = mass.shape
        prev_taken = torch.bmm(precede.transpose(1, 2),
                               binm.reshape(n, o, h * w)).reshape(n, o, h, w)
        return sampled * binm * (1.0 - torch.clamp(prev_taken, max=1.0))

    if occlusion_impl != "sort":
        raise ValueError(f"unknown occlusion_impl {occlusion_impl!r}")
    order = torch.argsort(mass, dim=-1, stable=True)                 # (N,O)
    rows = torch.arange(mass.shape[0], device=mass.device)[:, None]
    s = sampled[rows, order]
    b = binm[rows, order]
    prev_taken = torch.clamp(torch.cumsum(b, dim=1) - b, max=1.0)
    claimed = s * b * (1.0 - prev_taken)
    inv = torch.argsort(order, dim=-1)
    return claimed[rows, inv]


def masks_to_layout(vecs: torch.Tensor, boxes: torch.Tensor,
                    masks: torch.Tensor, obj_mask: torch.Tensor, h: int,
                    w: Optional[int] = None,
                    test_mode: bool = False) -> torch.Tensor:
    """Compose per-object vectors into an (N, H, W, D) layout by
    contracting the weight field with the vectors (the JAX package's XLA
    path). ``composite_layout`` is the test-mode form that runs the
    compositor kernel."""
    weights = masks_to_layout_weights(vecs, boxes, masks, obj_mask, h, w,
                                      test_mode=test_mode)
    with exact_f32_matmul():
        return torch.einsum("nohw,nod->nhwd", weights, vecs)


def compositor_inputs(vecs: torch.Tensor, boxes: torch.Tensor,
                      masks: torch.Tensor, obj_mask: torch.Tensor, h: int,
                      w: int) -> Tuple[torch.Tensor, ...]:
    """The compositor's prep: zero invalid slots, build the interpolation
    matrices in the working dtype, and sort the objects by ascending
    sampled mass (stable, so ties keep slot order).

    Returns ``(vecs, ry, rx, masks)`` in composite order.
    """
    dtype = vecs.dtype
    m = masks.shape[-1]
    valid = obj_mask.to(dtype)
    masks = masks.to(dtype) * valid[:, :, None, None]
    vecs = vecs * valid[..., None]
    ry, rx = box_sample_matrices(boxes.to(dtype), h, w, m)
    # The sum of the separable resample factorizes over the marginals of
    # ry and rx, so the mass needs no (N, O, H, W) tensor.
    with exact_f32_matmul():
        sampled_sum = torch.einsum("nom,nomk,nok->no", ry.sum(2), masks,
                                   rx.sum(2))
    mass = vecs.sum(-1) * sampled_sum
    # Invalid slots sort last: any value above every valid mass gives the
    # order of the JAX prep (f32 max there, which bf16 rounds to inf).
    mass = torch.where(valid.bool(), mass, torch.finfo(mass.dtype).max)
    order = torch.argsort(mass, dim=-1, stable=True)
    rows = torch.arange(mass.shape[0], device=mass.device)[:, None]
    return (vecs[rows, order].contiguous(), ry[rows, order].contiguous(),
            rx[rows, order].contiguous(), masks[rows, order].contiguous())


def composite_layout(vecs: torch.Tensor, boxes: torch.Tensor,
                     masks: torch.Tensor, obj_mask: torch.Tensor, h: int,
                     w: Optional[int] = None) -> torch.Tensor:
    """Test-mode (N, H, W, D) layout through the compositor: its kernel on
    a CUDA tensor, its plain version on a CPU tensor."""
    w = h if w is None else w
    return composite(*compositor_inputs(vecs, boxes, masks, obj_mask, h, w))


def boxes_to_layout(vecs: torch.Tensor, boxes: torch.Tensor,
                    obj_mask: torch.Tensor, h: int,
                    w: Optional[int] = None) -> torch.Tensor:
    """Mask-free layout: every object an all-ones 8x8 mask (reference
    ``boxes_to_layout``)."""
    n, o, _ = vecs.shape
    ones = torch.ones((n, o, 8, 8), dtype=vecs.dtype, device=vecs.device)
    return masks_to_layout(vecs, boxes, ones, obj_mask, h, w)
