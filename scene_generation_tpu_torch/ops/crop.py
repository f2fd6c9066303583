"""Differentiable ROI cropping for the appearance encoder and the object
discriminator (port of the JAX package's ``ops/crop.py``), with the crop op
``crop`` whose forward and backward are the CUDA kernels of
``csrc/crop.cu``.

    crop[n,o,p,q,c] = sum_{y,x} ry[n,o,p,y] * img[n,y,x,c] * rx[n,o,q,x]

``crop`` replaces the TPU kernels ``_crop_fwd_kernel`` and
``_crop_bwd_kernel`` of the JAX package (``ops/pallas/crop.py``, the
custom VJP of ``crop_pallas``). It is a ``torch.autograd.Function``: on
CUDA tensors its forward and its backward launch the kernels, on CPU
tensors they run ``crop_fwd_plain`` and ``crop_bwd_plain``; neither falls
back from one to the other. The interpolation matrices are built in plain
torch by ``crop_matrices``, so gradients reach the boxes through autograd.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from scene_generation_tpu_torch.ops import _cuda
from scene_generation_tpu_torch.ops.sampling import (crop_matrices,
                                                      exact_f32_matmul,
                                                      interp_matrix)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _acc_dtype(t: torch.Tensor) -> torch.dtype:
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def crop_fwd_plain(imgs: torch.Tensor, ry: torch.Tensor,
                   rx: torch.Tensor) -> torch.Tensor:
    """The two products of the JAX XLA path (``ops/crop.py:54-57``), summed
    in f32 (f64 for f64 inputs) and rounded once to the inputs' dtype.
    imgs (N,H,W,C), ry (N,O,HH,H), rx (N,O,WW,W) -> (N,O,HH,WW,C)."""
    acc = _acc_dtype(imgs)
    with exact_f32_matmul():
        tmp = torch.einsum("nopy,nyxc->nopxc", ry.to(acc), imgs.to(acc))
        out = torch.einsum("nopxc,noqx->nopqc", tmp, rx.to(acc))
    return out.to(imgs.dtype)


def crop_bwd_plain(imgs: torch.Tensor, ry: torch.Tensor, rx: torch.Tensor,
                   u: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The three gradients of the TPU backward kernel
    (``ops/pallas/crop.py:144-152``), written out (not autograd of the
    forward), given ``u = dL/dcrop``:

        t1 = ry_o img_c,  t2 = img_c rx_o^T
        d_rx_o = sum_c u_oc^T t1,  d_ry_o = sum_c u_oc t2^T,
        d_img_c = sum_o ry_o^T (u_oc rx_o)

    Returns (d_imgs, d_ry, d_rx) in the inputs' dtypes."""
    acc = _acc_dtype(imgs)
    img, r_y, r_x, uu = (t.to(acc) for t in (imgs, ry, rx, u))
    with exact_f32_matmul():
        t1 = torch.einsum("nopy,nyxc->nopxc", r_y, img)
        t2 = torch.einsum("nyxc,noqx->noyqc", img, r_x)
        d_rx = torch.einsum("nopqc,nopxc->noqx", uu, t1)
        d_ry = torch.einsum("nopqc,noyqc->nopy", uu, t2)
        ub = torch.einsum("nopqc,noqx->nopxc", uu, r_x)
        d_img = torch.einsum("nopy,nopxc->nyxc", r_y, ub)
    return d_img.to(imgs.dtype), d_ry.to(ry.dtype), d_rx.to(rx.dtype)


def _check(ts, names) -> None:
    dtype = ts[0].dtype
    if dtype not in _DTYPE_CODES or any(t.dtype != dtype for t in ts):
        raise TypeError("crop kernels take float32 or bfloat16 of one dtype, "
                        f"got {[t.dtype for t in ts]}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("crop kernels take contiguous tensors")
    if any(t.device != ts[0].device for t in ts):
        raise ValueError(f"{', '.join(names)} lie on different devices")


def _shapes(imgs, ry, rx):
    if imgs.ndim != 4 or ry.ndim != 4 or rx.ndim != 4:
        raise ValueError("crop takes imgs (N,H,W,C), ry (N,O,HH,H), "
                         "rx (N,O,WW,W)")
    n, h, w, c = imgs.shape
    o, hh = ry.shape[1], ry.shape[2]
    ww = rx.shape[2]
    if ry.shape != (n, o, hh, h) or rx.shape != (n, o, ww, w):
        raise ValueError(f"crop shapes disagree: imgs {tuple(imgs.shape)}, "
                         f"ry {tuple(ry.shape)}, rx {tuple(rx.shape)}")
    return n, h, w, c, o, hh, ww


def _launch_fwd(imgs, ry, rx) -> torch.Tensor:
    _check((imgs, ry, rx), ("imgs", "ry", "rx"))
    n, h, w, c, o, hh, ww = _shapes(imgs, ry, rx)
    lib = _cuda.library("crop")
    fn = lib.sg_crop_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty((n, o, hh, ww, c), dtype=imgs.dtype, device=imgs.device)
    stream = torch.cuda.current_stream(imgs.device).cuda_stream
    rc = fn(imgs.data_ptr(), ry.data_ptr(), rx.data_ptr(), out.data_ptr(),
            n, h, w, c, o, hh, ww, _DTYPE_CODES[imgs.dtype], stream)
    # A shape whose tiles exceed a block's shared memory is refused by the
    # launch and raised here.
    _cuda.check(lib, rc, f"crop forward kernel at W={w}, C={c}, WW={ww}")
    _cuda.LAUNCHES["crop_fwd"] += 1
    return out


def _launch_bwd(imgs, ry, rx, u):
    _check((imgs, ry, rx, u), ("imgs", "ry", "rx", "u"))
    n, h, w, c, o, hh, ww = _shapes(imgs, ry, rx)
    if u.shape != (n, o, hh, ww, c):
        raise ValueError(f"crop gradient {tuple(u.shape)} does not match the "
                         f"crops {(n, o, hh, ww, c)}")
    lib = _cuda.library("crop")
    fn = lib.sg_crop_bwd
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    d_img = torch.empty_like(imgs)
    d_ry = torch.empty_like(ry)
    d_rx = torch.empty_like(rx)
    # f32 scratch: ry_o @ img and u_o . rx_o for every (n, o) row, (N,O,HH,W*C)
    t1 = torch.empty((n, o, hh, w * c), dtype=torch.float32,
                     device=imgs.device)
    ub = torch.empty_like(t1)
    stream = torch.cuda.current_stream(imgs.device).cuda_stream
    rc = fn(imgs.data_ptr(), ry.data_ptr(), rx.data_ptr(), u.data_ptr(),
            d_img.data_ptr(), d_ry.data_ptr(), d_rx.data_ptr(), t1.data_ptr(),
            ub.data_ptr(), n, h, w, c, o, hh, ww, _DTYPE_CODES[imgs.dtype],
            stream)
    _cuda.check(lib, rc, f"crop backward kernels at W={w}, C={c}, O={o}, "
                f"HH={hh}, WW={ww}")
    _cuda.LAUNCHES["crop_bwd"] += 1
    return d_img, d_ry, d_rx


def _on(t: torch.Tensor, what: str) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cpu or cuda, not {t.device}")
    return t.device.type


def crop_fwd(imgs: torch.Tensor, ry: torch.Tensor,
             rx: torch.Tensor) -> torch.Tensor:
    """The forward: its kernel on a CUDA tensor, its plain version on a CPU
    tensor."""
    if _on(imgs, "crop") == "cpu":
        return crop_fwd_plain(imgs, ry, rx)
    return _launch_fwd(imgs, ry, rx)


def crop_bwd(imgs: torch.Tensor, ry: torch.Tensor, rx: torch.Tensor,
             u: torch.Tensor):
    """The backward: its kernels on a CUDA tensor, its plain version on a
    CPU tensor. Returns (d_imgs, d_ry, d_rx)."""
    if _on(imgs, "crop") == "cpu":
        return crop_bwd_plain(imgs, ry, rx, u)
    return _launch_bwd(imgs, ry, rx, u)


class _Crop(torch.autograd.Function):
    @staticmethod
    def forward(ctx, imgs, ry, rx):
        ctx.save_for_backward(imgs, ry, rx)
        return crop_fwd(imgs, ry, rx)

    @staticmethod
    def backward(ctx, u):
        imgs, ry, rx = ctx.saved_tensors
        # One launch computes all three gradients, as the TPU kernel does;
        # those nobody asked for are dropped.
        grads = crop_bwd(imgs, ry, rx, u.contiguous())
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad))


def crop(imgs: torch.Tensor, ry: torch.Tensor,
         rx: torch.Tensor) -> torch.Tensor:
    """The differentiable crop op. imgs (N,H,W,C), ry (N,O,HH,H),
    rx (N,O,WW,W) -> (N,O,HH,WW,C), accumulated in f32."""
    return _Crop.apply(imgs, ry, rx)


def crop_bbox_batch(imgs: torch.Tensor, boxes: torch.Tensor, hh: int,
                    ww: Optional[int] = None) -> torch.Tensor:
    """Crop every object box from its image.

    Args:
      imgs: (N, H, W, C) images.
      boxes: (N, O, 4) [x0, y0, x1, y1] in [0, 1] image coordinates.
      hh, ww: the crops' size (``ww`` defaults to ``hh``).
    Returns:
      (N, O, HH, WW, C) crops in the images' dtype: bilinear,
      align_corners-style, zeros outside the image (the reference's
      grid-sample crop).
    """
    ww = hh if ww is None else ww
    _, h, w, _ = imgs.shape
    ry, rx = crop_matrices(boxes.to(imgs.dtype), hh, ww, h, w)
    return crop(imgs.contiguous(), ry, rx)


def uncrop_bbox(feats: torch.Tensor, boxes: torch.Tensor, h: int,
                w: Optional[int] = None) -> torch.Tensor:
    """Place (N, O, HH, WW, C) crops back into (N, O, H, W, C) frames, zero
    outside each box: the inverse map of ``crop_bbox_batch`` (boxes are
    [x0, y0, x1, y1], as everywhere in the package). Plain torch."""
    w = h if w is None else w
    hh, ww = feats.shape[-3], feats.shape[-2]
    dtype = feats.dtype
    x0, y0, x1, y1 = boxes.to(dtype).unbind(-1)
    bw = torch.where(torch.abs(x1 - x0) < 1e-6, 1e-6, x1 - x0)
    bh = torch.where(torch.abs(y1 - y0) < 1e-6, 1e-6, y1 - y0)
    xs = torch.linspace(0.0, 1.0, w, dtype=dtype, device=feats.device)
    ys = torch.linspace(0.0, 1.0, h, dtype=dtype, device=feats.device)
    px = (xs - x0[..., None]) / bw[..., None] * (ww - 1)
    py = (ys - y0[..., None]) / bh[..., None] * (hh - 1)
    ry = interp_matrix(py, hh)                               # (N,O,H,HH)
    rx = interp_matrix(px, ww)                               # (N,O,W,WW)
    with exact_f32_matmul():
        tmp = torch.einsum("nohp,nopqc->nohqc", ry, feats)
        return torch.einsum("nohqc,nowq->nohwc", tmp, rx)
