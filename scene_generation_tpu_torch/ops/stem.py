"""The factored generator stem: wrapper of the CUDA kernel
``csrc/stem.cu`` and its plain PyTorch version.

    out[n,y,x,c] = sum_{dy,dx<7, o} w_pad[n, y+dy, x+dx, o] * g[n, dy, dx, o, c]

It replaces the TPU kernel ``stem_pallas`` of the JAX package
(``ops/pallas/stem.py``). ``stem`` launches the kernel for a CUDA tensor and
runs ``stem_plain`` for a CPU tensor; it never falls back from one to the
other. The dtype picks the kernel, both on Hopper's warpgroup products
(``wgmma.mma_async``) fed through rings of packed rows on mbarriers:
bfloat16 (serving; counted in ``LAUNCHES["stem_tc"]`` too, or, where a ring
of whole packed rows does not fit, as at 256 px, by the same products in
bands of 128, 64 or 32 pixels in ``LAUNCHES["stem_tc_banded"]``) and float32
in 3xTF32 (each operand split into a TF32 high and low part, three products
summed in f32; counted in ``LAUNCHES["stem_f32"]`` too). ``LAUNCHES["stem"]``
counts every launch; ``tc_launch_config`` and ``f32_launch_config``
report each kernel's launch at a shape. The kernels are
forward-only (test mode, serving): the wrapper raises rather than detach a
graph. Training runs ``stem_patches``, the JAX
package's differentiable ``patches`` form, on every device.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from scene_generation_tpu_torch.ops import _cuda

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# The kernel ``sg_stem`` reports it launched (``csrc/stem.cu``,
# ``KernelLaunched``), by its launch counter.
_LAUNCHED = {0: "stem_f32", 1: "stem_tc", 2: "stem_tc_banded"}
_CONFIG_KEYS = {
    "sg_stem_tc_config": ("registers", "dynamic_smem_bytes", "blocks_per_sm",
                          "grid", "ring_rows", "band_rows", "local_bytes",
                          "threads", "band_pixels"),
    "sg_stem_f32_config": ("registers", "dynamic_smem_bytes",
                           "blocks_per_sm", "grid", "band_pixels",
                           "band_rows", "local_bytes", "threads"),
}
_ARGTYPES = {
    "sg_stem": ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
                + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]),
    **{name: [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)]
       for name in _CONFIG_KEYS},
}
_bound: dict = {}


def _fn(name: str):
    """``name`` of the stem library, its argument types set once a
    process."""
    fn = _bound.get(name)
    if fn is None:
        fn = getattr(_cuda.library("stem"), name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _bound[name] = fn
    return fn


def stem_patches(weights: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The JAX package's ``patches`` form, the train path (differentiable):
    im2col of the O-channel field (``F.unfold`` orders features
    (o, ky, kx), as ``conv_general_dilated_patches`` does) and one
    per-image product."""
    n, hp, wp, o = weights.shape
    k, c = g.shape[1], g.shape[-1]
    h, w = hp - k + 1, wp - k + 1
    patches = F.unfold(weights.permute(0, 3, 1, 2), k)       # (N, O*k*k, HW)
    g_okk = g.permute(0, 3, 1, 2, 4).reshape(n, o * k * k, c)
    return torch.bmm(patches.transpose(1, 2), g_okk).reshape(n, h, w, c)


def stem_plain(weights: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The kernel's plain version: the ``patches`` form."""
    return stem_patches(weights, g)


def _launch(weights: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    if weights.dtype not in _DTYPE_CODES or g.dtype != weights.dtype:
        raise TypeError(f"stem kernel takes float32 or bfloat16 of one dtype, "
                        f"got {weights.dtype} and {g.dtype}")
    if not (weights.is_contiguous() and g.is_contiguous()):
        raise ValueError("stem kernel takes contiguous tensors")
    if g.device != weights.device:
        raise ValueError(f"weights on {weights.device}, g on {g.device}")
    if torch.is_grad_enabled() and (weights.requires_grad or g.requires_grad):
        raise RuntimeError("the stem kernel is forward-only: its output would "
                           "carry no gradient (train with stem_patches, or "
                           "run under torch.no_grad())")
    n, hp, wp, o = weights.shape
    if g.ndim != 5 or g.shape[:4] != (n, 7, 7, o):
        raise ValueError(f"g {tuple(g.shape)} does not match weights "
                         f"{tuple(weights.shape)} (want (N, 7, 7, O, C))")
    c = g.shape[4]
    h, w = hp - 6, wp - 6
    if h < 1 or w < 1:
        raise ValueError(f"weights {tuple(weights.shape)} smaller than 7x7")
    fn = _fn("sg_stem")
    out = torch.empty((n, h, w, c), dtype=weights.dtype,
                      device=weights.device)
    stream = torch.cuda.current_stream(weights.device).cuda_stream
    launched = ctypes.c_int(-1)
    rc = fn(weights.data_ptr(), g.data_ptr(), out.data_ptr(), n, h, w, o, c,
            _DTYPE_CODES[weights.dtype], stream, ctypes.byref(launched))
    # A shape whose tiles exceed a block's shared memory (in bands too) is
    # refused by the launch and raised here.
    if rc:
        _cuda.check(_cuda.library("stem"), rc,
                    f"stem kernel at W={w}, O={o}, C={c}")
    _cuda.LAUNCHES["stem"] += 1
    _cuda.LAUNCHES[_LAUNCHED[launched.value]] += 1
    return out


def _launch_config(name: str, n: int, h: int, w: int, o: int,
                   c: int) -> dict:
    info = (ctypes.c_int * len(_CONFIG_KEYS[name]))()
    rc = _fn(name)(n, h, w, o, c, info)
    if rc:
        _cuda.check(_cuda.library("stem"), rc,
                    f"stem kernel config at W={w}, O={o}, C={c}")
    return dict(zip(_CONFIG_KEYS[name], info))


def tc_launch_config(n: int, h: int, w: int, o: int, c: int) -> dict:
    """The bf16 launch at output (N, H, W) with O weight channels and C
    channels on the current card, without launching it: registers a
    thread, dynamic shared memory, blocks an SM, grid, packed input rows
    resident, output rows a band, local memory a thread, threads a block
    and pixels a band (0: whole rows, ``stem_tc_kernel``; else
    ``stem_tc_banded_kernel``). Raises where both would refuse the
    shape."""
    return _launch_config("sg_stem_tc_config", n, h, w, o, c)


def f32_launch_config(n: int, h: int, w: int, o: int, c: int) -> dict:
    """The f32 kernel's launch, as ``tc_launch_config`` reports the bf16
    one: registers a thread, dynamic shared memory, blocks an SM, grid,
    pixels and output rows a band, local memory a thread and threads a
    block. Raises where the kernel would refuse the shape."""
    return _launch_config("sg_stem_f32_config", n, h, w, o, c)


def stem(weights: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Fused factored stem, bias excluded.

    Args:
      weights: (N, H+6, W+6, O) reflect-padded per-object weight field.
      g: (N, 7, 7, O, C) per-image taps, ``g = einsum(vecs, kernel)``.
    Returns:
      (N, H, W, C) in the inputs' dtype, accumulated in f32 on the card.
    """
    if weights.device.type == "cpu":
        return stem_plain(weights, g)
    if weights.device.type != "cuda":
        raise ValueError(f"stem runs on cpu or cuda, not {weights.device}")
    return _launch(weights, g)
