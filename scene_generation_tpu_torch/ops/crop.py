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

The forward is one kernel (a block a band of crop rows, the spans found
in-block). The backward computes only the gradients its inputs need:
d_img by a span pass and a gather (counted once in
``LAUNCHES["crop_bwd"]``), d_ry and d_rx, the box gradients, by one banded
kernel launched only when one of them is asked for
(``LAUNCHES["crop_bwd_boxes"]``). The kernels touch only the hats'
nonzeros, so unlike the dense plain versions they do not spread a NaN or
Inf of an image into crops that do not sample it.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from scene_generation_tpu_torch.ops import _cuda
from scene_generation_tpu_torch.ops.sampling import (crop_matrices,
                                                      exact_f32_matmul,
                                                      interp_matrix)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

Needs = Sequence[bool]
Grads = Tuple[Optional[torch.Tensor], Optional[torch.Tensor],
              Optional[torch.Tensor]]


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
                   u: torch.Tensor, needs: Needs = (True, True, True)
                   ) -> Grads:
    """The three gradients of the TPU backward kernel
    (``ops/pallas/crop.py:144-152``), written out (not autograd of the
    forward), given ``u = dL/dcrop``:

        t1 = ry_o img_c,  t2 = img_c rx_o^T
        d_rx_o = sum_c u_oc^T t1,  d_ry_o = sum_c u_oc t2^T,
        d_img_c = sum_o ry_o^T (u_oc rx_o)

    Returns (d_imgs, d_ry, d_rx) in the inputs' dtypes, ``None`` for each
    gradient whose entry of ``needs`` is false."""
    acc = _acc_dtype(imgs)
    img, r_y, r_x, uu = (t.to(acc) for t in (imgs, ry, rx, u))
    d_img = d_ry = d_rx = None
    with exact_f32_matmul():
        if needs[0]:
            ub = torch.einsum("nopqc,noqx->nopxc", uu, r_x)
            d_img = torch.einsum("nopy,nopxc->nyxc", r_y, ub).to(imgs.dtype)
        if needs[1]:
            t2 = torch.einsum("nyxc,noqx->noyqc", img, r_x)
            d_ry = torch.einsum("nopqc,noyqc->nopy", uu, t2).to(ry.dtype)
        if needs[2]:
            t1 = torch.einsum("nopy,nyxc->nopxc", r_y, img)
            d_rx = torch.einsum("nopqc,nopxc->noqx", uu, t1).to(rx.dtype)
    return d_img, d_ry, d_rx


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
    if max(n * o * hh * ww * c, n * h * w * c) >= 2 ** 31 or n * o > 65535:
        raise ValueError("crop kernels index outputs with 32-bit ints and "
                         "take at most 65535 crops (N * O)")
    return n, h, w, c, o, hh, ww


def _entry(symbol: str, n_ptrs: int):
    """The crop library's C function ``symbol``: ``n_ptrs`` pointers, eight
    ints, the stream; typed once (ctypes keeps the function object)."""
    lib = _cuda.library("crop")
    fn = getattr(lib, symbol)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 8 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib, fn


def _launch_fwd(imgs, ry, rx) -> torch.Tensor:
    _check((imgs, ry, rx), ("imgs", "ry", "rx"))
    n, h, w, c, o, hh, ww = _shapes(imgs, ry, rx)
    lib, fn = _entry("sg_crop_fwd", 4)
    out = torch.empty((n, o, hh, ww, c), dtype=imgs.dtype, device=imgs.device)
    stream = torch.cuda.current_stream(imgs.device).cuda_stream
    rc = fn(imgs.data_ptr(), ry.data_ptr(), rx.data_ptr(), out.data_ptr(),
            n, h, w, c, o, hh, ww, _DTYPE_CODES[imgs.dtype], stream)
    _cuda.check(lib, rc, f"crop forward kernel at W={w}, C={c}, WW={ww}")
    _cuda.LAUNCHES["crop_fwd"] += 1
    return out


def _launch_bwd(imgs, ry, rx, u, needs: Needs) -> Grads:
    _check((imgs, ry, rx, u), ("imgs", "ry", "rx", "u"))
    n, h, w, c, o, hh, ww = _shapes(imgs, ry, rx)
    if u.shape != (n, o, hh, ww, c):
        raise ValueError(f"crop gradient {tuple(u.shape)} does not match the "
                         f"crops {(n, o, hh, ww, c)}")
    dtype = _DTYPE_CODES[imgs.dtype]
    stream = torch.cuda.current_stream(imgs.device).cuda_stream
    d_img = d_ry = d_rx = None
    if needs[0]:
        lib, fn = _entry("sg_crop_bwd_img", 5)
        d_img = torch.empty_like(imgs)
        # Each column's span over the rows of ry_o and rx_o and its first
        # two taps: N*O*(H+W) entries of 16 bytes.
        spans = torch.empty((n, o, h + w, 4), dtype=torch.int32,
                            device=imgs.device)
        rc = fn(ry.data_ptr(), rx.data_ptr(), u.data_ptr(), d_img.data_ptr(),
                spans.data_ptr(), n, h, w, c, o, hh, ww, dtype, stream)
        _cuda.check(lib, rc, f"crop d_img kernels at W={w}, O={o}")
        _cuda.LAUNCHES["crop_bwd"] += 1
    if needs[1] or needs[2]:
        lib, fn = _entry("sg_crop_bwd_boxes", 6)
        d_ry = torch.empty_like(ry)
        d_rx = torch.empty_like(rx)
        rc = fn(imgs.data_ptr(), ry.data_ptr(), rx.data_ptr(), u.data_ptr(),
                d_ry.data_ptr(), d_rx.data_ptr(), n, h, w, c, o, hh, ww,
                dtype, stream)
        _cuda.check(lib, rc, f"crop d_ry/d_rx kernels at W={w}, C={c}, "
                    f"HH={hh}, WW={ww}")
        _cuda.LAUNCHES["crop_bwd_boxes"] += 1
        # One launch computes both; only what was asked goes back.
        d_ry = d_ry if needs[1] else None
        d_rx = d_rx if needs[2] else None
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
             u: torch.Tensor, needs: Needs = (True, True, True)) -> Grads:
    """The backward: its kernels on a CUDA tensor, its plain version on a
    CPU tensor. Returns (d_imgs, d_ry, d_rx), ``None`` for each gradient
    whose entry of ``needs`` is false."""
    if len(needs) != 3:
        raise ValueError(f"needs takes three flags (imgs, ry, rx), got "
                         f"{needs}")
    if _on(imgs, "crop") == "cpu":
        return crop_bwd_plain(imgs, ry, rx, u, needs)
    return _launch_bwd(imgs, ry, rx, u, needs)


class _Crop(torch.autograd.Function):
    @staticmethod
    def forward(ctx, imgs, ry, rx):
        ctx.save_for_backward(imgs, ry, rx)
        return crop_fwd(imgs, ry, rx)

    @staticmethod
    def backward(ctx, u):
        imgs, ry, rx = ctx.saved_tensors
        # Only the gradients autograd asks for: in training the boxes are
        # batch constants, so d_ry and d_rx are never launched.
        return crop_bwd(imgs, ry, rx, u.contiguous(), ctx.needs_input_grad)


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
