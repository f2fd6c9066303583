"""Bilinear sampling as small dense matrices (port of the JAX package's
``ops/sampling.py``).

``grid_sample`` with an axis-separable grid is linear in its input, so each
resample factors into two 1-D interpolation matrices:
``sampled = R_y @ input @ R_x^T`` with ``R[p, m] = max(0, 1 - |coord(p) - m|)``.
Out-of-range samples get all-zero rows, which is grid_sample's zero padding.
"""
from __future__ import annotations

import contextlib
from typing import Tuple

import torch


def interp_matrix(coords: torch.Tensor, in_size: int) -> torch.Tensor:
    """(..., P) sample positions in input pixel space -> (..., P, M) weights.

    Where a sample lies on a grid line, or one pixel from one, the hat has
    a kink; the subgradients there are JAX's (``|d|`` has slope 1 at 0,
    ``maximum`` splits a tie), so box gradients agree with the JAX
    package's on such samples too. The values are the same either way."""
    m = torch.arange(in_size, dtype=coords.dtype, device=coords.device)
    d = coords[..., None] - m
    diff = torch.where(d >= 0, d, -d)
    return torch.maximum(1.0 - diff, torch.zeros((), dtype=coords.dtype,
                                                  device=coords.device))


def box_sample_matrices(boxes: torch.Tensor, out_h: int, out_w: int,
                        in_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Interpolation matrices of the reference layout grid.

    Output pixel (h, w) lies at normalized image coords (w/(W-1), h/(H-1));
    its sample location inside the object's M x M mask is
    ``(coord - box_min) / box_extent * (M - 1)``.

    Args:
      boxes: (..., 4) [x0, y0, x1, y1] in [0, 1] image coordinates.
    Returns:
      (ry, rx): (..., H, M) and (..., W, M), ``sampled = ry @ mask @ rx^T``.
    """
    dtype = boxes.dtype
    x0, y0, x1, y1 = boxes.unbind(-1)
    ww = x1 - x0
    hh = y1 - y0
    # Clamp degenerate extents so a predicted zero-size box cannot give NaN
    # (the reference divides by zero, layout.py:117-118).
    ww = torch.where(torch.abs(ww) < 1e-6, 1e-6, ww)
    hh = torch.where(torch.abs(hh) < 1e-6, 1e-6, hh)

    xs = torch.linspace(0.0, 1.0, out_w, dtype=dtype, device=boxes.device)
    ys = torch.linspace(0.0, 1.0, out_h, dtype=dtype, device=boxes.device)
    scale = in_size - 1
    px = (xs - x0[..., None]) / ww[..., None] * scale   # (..., W)
    py = (ys - y0[..., None]) / hh[..., None] * scale   # (..., H)
    return interp_matrix(py, in_size), interp_matrix(px, in_size)


def crop_matrices(boxes: torch.Tensor, out_h: int, out_w: int, in_h: int,
                  in_w: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Interpolation matrices of the reference ROI crop.

    Crop pixel (p, q) samples the image at
    ``x = (x0 + (x1 - x0) * q / (WW - 1)) * (W - 1)`` (align_corners-style).
    Plain torch, so gradients reach the boxes through autograd.

    Args:
      boxes: (..., 4) [x0, y0, x1, y1] in [0, 1] image coordinates.
    Returns:
      (ry, rx): (..., HH, H) and (..., WW, W), ``crop = ry @ image @ rx^T``
      per channel.
    """
    dtype = boxes.dtype
    x0, y0, x1, y1 = boxes.unbind(-1)
    tx = torch.linspace(0.0, 1.0, out_w, dtype=dtype, device=boxes.device)
    ty = torch.linspace(0.0, 1.0, out_h, dtype=dtype, device=boxes.device)
    px = (x0[..., None] + (x1 - x0)[..., None] * tx) * (in_w - 1)
    py = (y0[..., None] + (y1 - y0)[..., None] * ty) * (in_h - 1)
    return interp_matrix(py, in_h), interp_matrix(px, in_w)


def bilinear_sample_gather(img: torch.Tensor, px: torch.Tensor,
                           py: torch.Tensor) -> torch.Tensor:
    """Pure-gather bilinear sampling oracle, zeros outside the image
    (``grid_sample(align_corners=True)`` in pixel coordinates); the tests'
    check of the matrix form.

    Args:
      img: (H, W) or (H, W, C).
      px, py: (HH, WW) pixel-space sample coordinates.
    Returns:
      (HH, WW) or (HH, WW, C).
    """
    squeeze = img.ndim == 2
    if squeeze:
        img = img[..., None]
    h, w, _ = img.shape
    x0f, y0f = torch.floor(px), torch.floor(py)
    wx1, wy1 = px - x0f, py - y0f

    def corner(yf, xf, wgt):
        valid = (xf >= 0) & (xf <= w - 1) & (yf >= 0) & (yf <= h - 1)
        xi = torch.clamp(xf, 0, w - 1).long()
        yi = torch.clamp(yf, 0, h - 1).long()
        return img[yi, xi] * (wgt * valid.to(img.dtype))[..., None]

    out = (corner(y0f, x0f, (1 - wy1) * (1 - wx1))
           + corner(y0f, x0f + 1, (1 - wy1) * wx1)
           + corner(y0f + 1, x0f, wy1 * (1 - wx1))
           + corner(y0f + 1, x0f + 1, wy1 * wx1))
    return out[..., 0] if squeeze else out


@contextlib.contextmanager
def exact_f32_matmul():
    """Run the f32 products inside the block in true f32, never TF32.

    The test-mode claim is ``sampled > 0.5``: TF32 keeps a 10-bit mantissa
    and rounds a resampled ``0.5 + 2**-12`` down to 0.5, so no pixel would
    be claimed (the JAX package pins ``Precision.HIGHEST`` for the same
    reason). The flag is cuBLAS's; CPU products are always full f32.
    """
    flags = torch.backends.cuda.matmul
    prev = flags.allow_tf32
    flags.allow_tf32 = False
    try:
        yield
    finally:
        flags.allow_tf32 = prev
