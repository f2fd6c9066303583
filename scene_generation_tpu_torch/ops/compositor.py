"""The test-mode occlusion compositor: wrapper of the CUDA kernel
``csrc/compositor.cu`` and its plain PyTorch version.

For each image, with the objects already in ascending-mass order, for each
object k:  ``s = ry_k @ mask_k @ rx_k^T``, ``claim = (s > 0.5)(1 - taken)``,
``taken = min(taken + claim, 1)``, ``out += (s * claim) (x) vecs_k``.

It replaces the TPU kernel ``masks_to_layout_pallas`` of the JAX package
(``ops/pallas/compositor.py``). The prep (zeroing invalid slots, the
interpolation matrices and the mass sort) is
``ops/layout.py::compositor_inputs``. ``composite`` launches the kernel for
a CUDA tensor and runs ``composite_plain`` for a CPU tensor.
"""
from __future__ import annotations

import ctypes

import torch

from scene_generation_tpu_torch.ops import _cuda
from scene_generation_tpu_torch.ops.sampling import exact_f32_matmul

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def composite_plain(vecs: torch.Tensor, ry: torch.Tensor, rx: torch.Tensor,
                    masks: torch.Tensor) -> torch.Tensor:
    """Object by object, as the TPU kernel's loop (compositor.py:82-96):
    products and sums in f32 (f64 for f64 inputs), output in the inputs'
    dtype."""
    acc_t = torch.float64 if vecs.dtype == torch.float64 else torch.float32
    n, o, d = vecs.shape
    h, w = ry.shape[2], rx.shape[2]
    acc = torch.zeros((n, h, w, d), dtype=acc_t, device=vecs.device)
    taken = torch.zeros((n, h, w), dtype=acc_t, device=vecs.device)
    with exact_f32_matmul():
        for k in range(o):
            tmp = ry[:, k].to(acc_t) @ masks[:, k].to(acc_t)         # (N,H,M)
            s = tmp @ rx[:, k].to(acc_t).transpose(1, 2)             # (N,H,W)
            claim = (s > 0.5).to(acc_t) * (1.0 - taken)
            taken = torch.clamp(taken + claim, max=1.0)
            acc = acc + (s * claim)[..., None] * vecs[:, k, None, None, :].to(
                acc_t)
    return acc.to(vecs.dtype)


def _launch(vecs, ry, rx, masks) -> torch.Tensor:
    ts = (vecs, ry, rx, masks)
    if vecs.dtype not in _DTYPE_CODES or any(t.dtype != vecs.dtype
                                             for t in ts):
        raise TypeError("compositor kernel takes float32 or bfloat16 of one "
                        f"dtype, got {[t.dtype for t in ts]}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("compositor kernel takes contiguous tensors")
    if any(t.device != vecs.device for t in ts):
        raise ValueError("compositor inputs lie on different devices")
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise RuntimeError("the compositor kernel is forward-only (test "
                           "mode): its output would carry no gradient")
    n, o, d = vecs.shape
    h, m = ry.shape[2], ry.shape[3]
    w = rx.shape[2]
    if (ry.shape != (n, o, h, m) or rx.shape != (n, o, w, m)
            or masks.shape != (n, o, m, m)):
        raise ValueError(
            f"compositor shapes disagree: vecs {tuple(vecs.shape)}, ry "
            f"{tuple(ry.shape)}, rx {tuple(rx.shape)}, masks "
            f"{tuple(masks.shape)}")
    if n * o * max(h, w) * m >= 2 ** 31 or n * h * w * d >= 2 ** 31:
        raise ValueError("compositor kernel indexes with 32-bit ints")
    lib = _cuda.library("compositor")
    fn = lib.sg_compositor
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty((n, h, w, d), dtype=vecs.dtype, device=vecs.device)
    stream = torch.cuda.current_stream(vecs.device).cuda_stream
    rc = fn(vecs.data_ptr(), ry.data_ptr(), rx.data_ptr(), masks.data_ptr(),
            out.data_ptr(), n, o, d, h, w, m, _DTYPE_CODES[vecs.dtype], stream)
    # A shape whose tiles exceed a block's shared memory is refused by the
    # launch and raised here.
    _cuda.check(lib, rc, f"compositor kernel at O={o}, D={d}, W={w}, M={m}")
    _cuda.LAUNCHES["compositor"] += 1
    return out


def composite(vecs: torch.Tensor, ry: torch.Tensor, rx: torch.Tensor,
              masks: torch.Tensor) -> torch.Tensor:
    """Fused occlusion compositor (test mode; not differentiable).

    Args (objects in composite order, invalid slots zeroed):
      vecs: (N, O, D) layout vectors.
      ry: (N, O, H, M) row interpolation matrices.
      rx: (N, O, W, M) column interpolation matrices.
      masks: (N, O, M, M) soft masks.
    Returns:
      (N, H, W, D) layout.
    """
    if vecs.device.type == "cpu":
        return composite_plain(vecs, ry, rx, masks)
    if vecs.device.type != "cuda":
        raise ValueError(f"composite runs on cpu or cuda, not {vecs.device}")
    return _launch(vecs, ry, rx, masks)
