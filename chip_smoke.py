#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``scene_generation_tpu_torch/csrc``,
holds each against its plain PyTorch version at the shapes of its path
(the stem and the compositor at the serving shapes, the crop forward and
backward at the train shapes, timed by CUDA events around a call and by
the profiler's device time), checks that the forward-only kernels refuse
inputs that require grad, serves HTTP requests and a batch-16 forward
through the default ``Config()`` (the factored stem, bf16: the
tensor-core stem kernel), runs the dense-stem variant (the compositor
kernel) and the GT-appearance forward (``forward_batch(features=None)``:
the crop forward kernel), compares the card with the CPU in f32, and
times serving (CUDA events, then a ``torch.profiler`` breakdown of the
device's time). Then it trains: a few steps of the default ``Config()``
at batch 12 through the port's train loop (the crop kernels; the box
gradients' kernel must not run), timed and profiled, and one f32 train
step on the card against the same step on the CPU. Every phase prints one
line; any failure raises and the exit code is non-zero. Without a CUDA
device it exits non-zero before printing any result.

The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --only {stem,compositor,crop}

builds and checks one kernel alone (its phase and its device times) and
prints no result line: the quick loop while working on a kernel.
"""
from __future__ import annotations

import argparse
import base64
import contextlib
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
import zlib
from http.server import HTTPServer

import numpy as np
import torch

from scene_generation_tpu_torch.config import Config
from scene_generation_tpu_torch.convert import save_checkpoint
from scene_generation_tpu_torch.data import synthetic_batch, synthetic_vocab
from scene_generation_tpu_torch.entry import build_model, train_entry
from scene_generation_tpu_torch.ops import _cuda
from scene_generation_tpu_torch.ops.compositor import (composite,
                                                       composite_plain)
from scene_generation_tpu_torch.ops.crop import (crop_bwd, crop_bwd_plain,
                                                 crop_fwd, crop_fwd_plain)
from scene_generation_tpu_torch.ops.layout import compositor_inputs
from scene_generation_tpu_torch.ops.sampling import (crop_matrices,
                                                      exact_f32_matmul)
from scene_generation_tpu_torch.ops.stem import stem, stem_plain
from scene_generation_tpu_torch.serve import Server, make_handler
from scene_generation_tpu_torch.train import run as train_run
from scene_generation_tpu_torch.trainer.step import Draws, draw, train_step
from scene_generation_tpu_torch.trainer.train_state import create_train_state

BATCH = 16
SEED = 0
TRACE_STEPS = 5
TRAIN_BATCH = 12
TRAIN_STEPS = 3
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, f32 outside
# them, HBM bandwidth.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + json.dumps(fields), flush=True)


def cuda_ms(fn, warmup: int = 3, reps: int = 20) -> float:
    """Median milliseconds of one call, by CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_kernels_ms(fn, reps: int = 10) -> dict:
    """Device milliseconds of one call by kernel (each kernel's own time
    under torch.profiler, averaged over ``reps`` calls after one warm-up):
    the call's time on the card without the host's launch work, which
    ``cuda_ms`` includes where the host is the slower of the two. Empty
    when the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key[:60]: device_ms(e) / reps for e in device_rows(prof)}


def device_total_ms(kernels: dict):
    return sum(kernels.values()) if kernels else "not measured"


def bound(flops: float, nbytes: float, dtype: torch.dtype):
    """(ms, 'bytes' | 'operations'): the least time the card could take."""
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def smi(query: str) -> str:
    """One ``nvidia-smi --query-gpu`` reading of card 0."""
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]


def sm_clock() -> str:
    """The SM clock now, read beside a device time: under sustained load a
    card may run below its top clock."""
    return smi("clocks.sm")


# --- phase 3: kernels against their plain versions --------------------------

def stem_inputs(cfg: Config, dtype, seed=1):
    """The stem's main-path shapes: the padded weight field (values in
    [0, 1], as claimed mask weights are) and the per-image taps."""
    mc = cfg.model
    h = mc.image_size[0]
    o = cfg.data.max_objs
    gen = torch.Generator().manual_seed(seed)
    w = torch.rand((BATCH, h + 6, h + 6, o), generator=gen)
    g = 0.1 * torch.randn((BATCH, 7, 7, o, mc.ngf), generator=gen)
    return w.to("cuda", dtype), g.to("cuda", dtype)


def stem_library_call(w, g):
    """One grouped conv that computes the stem on the same inputs (never
    called by the port): the library yardstick. Returns NCHW."""
    n, hp, wp, o = w.shape
    c = g.shape[-1]
    x_lib = w.permute(0, 3, 1, 2).reshape(1, n * o, hp, wp).contiguous()
    k_lib = g.permute(0, 4, 3, 1, 2).reshape(n * c, o, 7, 7).contiguous()
    return lambda: torch.nn.functional.conv2d(x_lib, k_lib, groups=n)


def check_stem(cfg: Config) -> dict:
    """The stem kernel against its plain version at the serving shape, f32
    (the CUDA-core kernel) and bf16 (the tensor-core kernel, twice, bitwise
    equal), timed by CUDA events beside the plain version and the
    grouped-conv yardstick. Device times come last (``stem_device_times``)."""
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        w, g = stem_inputs(cfg, dtype)
        got = stem(w, g)
        again = stem(w, g)
        want = stem_plain(w, g)
        torch.cuda.synchronize()
        check(torch.equal(got, again),
              f"stem kernel {dtype} is not bitwise repeatable")
        err = float((got.float() - want.float()).abs().max())
        # f32: 441-term sums in another order; bf16: both sum exact bf16
        # products in f32 and round to bf16 once, one ulp apart at most.
        tol = 1e-4 if dtype == torch.float32 else 2 ** -7 * float(
            want.float().abs().max())
        check(err <= tol, f"stem kernel {dtype}: max abs err {err} > {tol}")
        n, hp, wp, o = w.shape
        c = g.shape[-1]
        library = stem_library_call(w, g)
        lib_err = float((library().reshape(n, c, hp - 6, wp - 6).permute(
            0, 2, 3, 1).float() - want.float()).abs().max())
        check(lib_err <= tol, f"grouped-conv yardstick disagrees: {lib_err}")
        flops = 2.0 * n * (hp - 6) * (wp - 6) * c * 49 * o
        b_ms, b_by = bound(flops, nbytes(w, g, got), dtype)
        rows[dtype] = dict(max_abs_err=err, tol=tol,
                           ms=cuda_ms(lambda: stem(w, g)),
                           plain_ms=cuda_ms(lambda: stem_plain(w, g)),
                           library_ms=cuda_ms(library),
                           bound_ms=b_ms, bound_by=b_by)
        say("kernel stem", dtype=str(dtype), **rows[dtype])
    return rows


def compositor_case(cfg: Config, seed=2):
    """Main-path shapes as numpy: synthetic boxes, one-hot + appearance
    vectors, soft masks spread around 0.5; slot 0 of image 0 holds a
    degenerate box and slot 1 a box wholly out of frame."""
    mc = cfg.model
    batch = synthetic_batch(cfg, seed=seed, batch_size=BATCH)
    rng = np.random.RandomState(seed)
    n, o = batch.objs.shape
    vecs = np.concatenate([np.eye(mc.num_objs, dtype=np.float32)[batch.objs],
                           rng.randn(n, o, mc.rep_size).astype(np.float32)],
                          -1)
    boxes = batch.boxes.copy()
    boxes[0, 0] = [0.3, 0.3, 0.3, 0.3]
    boxes[0, 1] = [1.2, 1.1, 1.7, 1.9]
    obj_mask = batch.obj_mask.copy()
    obj_mask[0, :2] = 1.0
    m = mc.mask_size
    masks = (1 / (1 + np.exp(-3 * rng.randn(n, o, m, m)))).astype(np.float32)
    return vecs, boxes, masks, obj_mask


def to_compositor(cfg: Config, case, dtype):
    vecs, boxes, masks, obj_mask = case
    return compositor_inputs(
        *[torch.from_numpy(a).to("cuda", dtype) for a in (vecs, boxes, masks)],
        torch.from_numpy(obj_mask).cuda(), *cfg.model.image_size)


def check_compositor(cfg: Config) -> dict:
    rows = {}
    case = compositor_case(cfg)
    for dtype in (torch.float32, torch.bfloat16):
        inputs = to_compositor(cfg, case, dtype)
        got = composite(*inputs)
        want = composite_plain(*inputs)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), "compositor output not finite")
        diff = (got.float() - want.float()).abs().amax(-1)       # per pixel
        # The claim (s > 0.5) is a step. Both versions sum the same f32
        # products in another order, so where some object's resampled value
        # s lies within rounding of 0.5 the two can claim differently, and
        # that pixel then differs by a whole vector. So the count of such
        # pixels is near zero but not always zero. The kernel does not
        # expose its claims, but no other pixel can flip: every pixel away
        # from the step must agree to rounding of the output dtype.
        v, ry, rx, m = inputs
        with exact_f32_matmul():
            s = ry.float() @ m.float() @ rx.float().transpose(-1, -2)
        near_step = ((s - 0.5).abs() <= 1e-5).any(1)             # (N, H, W)
        tol = 1e-4 if dtype == torch.float32 else 2 ** -7 * float(
            want.float().abs().max())
        off = diff > tol
        flips = int(off.sum())
        check(not bool((off & ~near_step).any()),
              f"compositor {dtype}: pixels away from the 0.5 step differ by "
              f"more than {tol}")
        check(flips <= 16, f"compositor {dtype}: {flips} claim flips")
        err = float(diff.max())                  # every pixel, flips included
        err_off_step = float(diff[~near_step].max())
        flops = 2.0 * v.shape[0] * v.shape[1] * (
            ry.shape[2] * m.shape[2] * m.shape[3]
            + ry.shape[2] * rx.shape[2] * m.shape[3]
            + ry.shape[2] * rx.shape[2] * v.shape[2])
        b_ms, b_by = bound(flops, nbytes(*inputs, got), dtype)
        rows[dtype] = dict(max_abs_err=err, max_abs_err_off_step=err_off_step,
                           tol=tol, claim_flips=flips,
                           pixels_near_step=int(near_step.sum()),
                           ms=cuda_ms(lambda: composite(*inputs)),
                           plain_ms=cuda_ms(lambda: composite_plain(*inputs),
                                            reps=5),
                           library_ms=None, bound_ms=b_ms, bound_by=b_by)
        say("kernel compositor", dtype=str(dtype), **rows[dtype])

    # The degenerate and the out-of-frame box contribute nothing: image 0
    # composites the same without them.
    full = composite(*to_compositor(cfg, case, torch.float32))
    vecs, boxes, masks, obj_mask = case
    obj_mask = obj_mask.copy()
    obj_mask[0, :2] = 0.0
    without = composite(*to_compositor(cfg, (vecs, boxes, masks, obj_mask),
                                       torch.float32))
    edge_err = float((full[0] - without[0]).abs().max())
    check(edge_err <= 1e-6, f"degenerate/out-of-frame boxes leak {edge_err}")

    # An f32 mask of 0.5 + 2^-12 (which TF32 and bf16 round to 0.5) claims.
    probe = compositor_inputs(
        torch.ones((1, 2, 4), device="cuda"),
        torch.tensor([0.1, 0.1, 0.9, 0.9], device="cuda").repeat(1, 2, 1),
        torch.full((1, 2, 8, 8), 0.5 + 2.0 ** -12, device="cuda"),
        torch.ones((1, 2), device="cuda"), 32, 32)
    claimed = float(composite(*probe).abs().sum())
    check(claimed > 0.0, "f32 masks at 0.5 + 2^-12 claimed nothing")
    say("kernel compositor probes", edge_boxes_max_err=edge_err,
        half_threshold_claimed=claimed)
    return rows


def crop_case(cfg: Config, hh: int, dtype, seed=6):
    """The crops' train shapes: 12 images of 128x128x3 in [-1, 1], the
    synthetic batch's 9 boxes an image (slot 0 of image 0 made degenerate,
    slots 1 and 2 of image 1 partly out of frame) and a random gradient."""
    batch = synthetic_batch(cfg, seed=seed, batch_size=TRAIN_BATCH)
    boxes = batch.boxes.copy()
    boxes[0, 0] = [0.4, 0.4, 0.4, 0.7]
    boxes[1, 1] = [-0.2, 0.5, 0.3, 1.3]
    boxes[1, 2] = [0.8, -0.3, 1.4, 0.4]
    boxes = torch.from_numpy(boxes).cuda()
    h, w = cfg.model.image_size
    gen = torch.Generator().manual_seed(seed)
    imgs = torch.rand((TRAIN_BATCH, h, w, 3), generator=gen) * 2 - 1
    u = torch.randn((TRAIN_BATCH, boxes.shape[1], hh, hh, 3), generator=gen)
    ry, rx = crop_matrices(boxes.to(dtype), hh, hh, h, w)
    return (imgs.to("cuda", dtype), ry.contiguous(), rx.contiguous(),
            u.to("cuda", dtype), boxes)


def grid_sample_inputs(imgs, boxes, u):
    """``F.grid_sample``'s form of the same crop (bilinear, zero padding,
    align_corners=True): each image repeated once per object, a grid per
    object, the gradient channels-first."""
    n, h, w, c = imgs.shape
    o, hh, ww = u.shape[1:4]
    x0, y0, x1, y1 = boxes.unbind(-1)
    tx = torch.linspace(0, 1, ww, device=boxes.device)
    ty = torch.linspace(0, 1, hh, device=boxes.device)
    gx = 2 * (x0[..., None] + (x1 - x0)[..., None] * tx) - 1       # (N,O,WW)
    gy = 2 * (y0[..., None] + (y1 - y0)[..., None] * ty) - 1       # (N,O,HH)
    grid = torch.stack(torch.broadcast_tensors(gx[:, :, None, :],
                                               gy[:, :, :, None]), -1)
    inp = imgs.permute(0, 3, 1, 2).repeat_interleave(o, 0).contiguous()
    grad = u.permute(0, 1, 4, 2, 3).reshape(n * o, c, hh, ww).contiguous()
    return inp, grid.reshape(n * o, hh, ww, 2).contiguous(), grad


D_IMG_ONLY = (True, False, False)        # the train path's crop backward
BOXES_ONLY = (False, True, True)         # the box gradients' kernel alone
EVERY_GRAD = (True, True, True)
# The crop rows: the backward of each gradient set, and the suffix of its
# gradients' names in the error records.
CROP_BWD_ROWS = (("crop_bwd", D_IMG_ONLY, "_alone"),
                 ("crop_bwd_boxes", BOXES_ONLY, "_boxes_only"),
                 ("crop_bwd_all", EVERY_GRAD, ""))


def crop_library_calls(imgs, boxes, u) -> dict:
    """One PyTorch call per crop row that computes the same function on the
    same inputs (never called by the port): ``F.grid_sample`` for the
    forward, ``grid_sampler_2d_backward`` with the input gradient only for
    the d_img backward, the grid's only for the box gradients, and both
    for all three gradients."""
    inp, grid, grad = grid_sample_inputs(imgs, boxes, u)

    def backward(with_input, with_grid):
        return lambda: torch.ops.aten.grid_sampler_2d_backward(
            grad, inp, grid, 0, 0, True, [with_input, with_grid])

    return {"crop_fwd": lambda: torch.nn.functional.grid_sample(
                inp, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True),
            "crop_bwd": backward(True, False),
            "crop_bwd_boxes": backward(False, True),
            "crop_bwd_all": backward(True, True)}


def crop_work(imgs, ry, rx, u, out, needs=None):
    """(operations, bytes) that the crop forward (``needs`` None) or
    backward needs on these inputs, ``out`` its outputs: operations from
    the nonzeros of ry and rx (counted on the card), bytes with each input
    read once and each output written once. Per (n, o) and channel, with
    t1 = ry img and t2 = img rx^T restricted to the rows and columns that
    hold a nonzero: forward and d_img 2 (nnz(ry) cols(rx) + rows(ry)
    nnz(rx)); the box gradients add t1 and t2 on every image row and
    column, 2 (nnz(ry) W + nnz(rx) H), then d_ry the dense 2 HH H rows(rx)
    and d_rx the dense 2 WW W rows(ry)."""
    c = imgs.shape[-1]
    hh, h = ry.shape[-2:]
    ww, w = rx.shape[-2:]
    nz_y, nz_x = ry != 0, rx != 0
    nnz_y = nz_y.sum((-1, -2)).double()
    nnz_x = nz_x.sum((-1, -2)).double()
    rows_y = nz_y.any(-1).sum(-1).double()       # crop rows that sample
    rows_x = nz_x.any(-1).sum(-1).double()       # crop columns that sample
    cols_x = nz_x.any(-2).sum(-1).double()       # image columns sampled
    banded = nnz_y * cols_x + rows_y * nnz_x
    if needs is None:
        return float(2 * c * banded.sum()), nbytes(imgs, ry, rx, *out)
    ops = banded if needs[0] else 0.0
    if needs[1] or needs[2]:
        ops = ops + nnz_y * w + nnz_x * h + hh * h * rows_x + ww * w * rows_y
    read = (ry, rx, u) + ((imgs,) if needs[1] or needs[2] else ())
    return float(2 * c * ops.sum()), nbytes(*read, *out)


def dense_crop_flops(imgs, ry, rx, needs=None) -> float:
    """The dense products' operations (the bound PR 2 counted): forward
    ry img then rx; backward ub (d_img and d_ry), d_img, d_ry, t1 and
    d_rx (both box gradients are formed when either is asked for)."""
    n, h, w, c = imgs.shape
    o, hh, ww = ry.shape[1], ry.shape[2], rx.shape[2]
    per = 2.0 * n * o * c
    if needs is None:
        return per * (hh * h * w + hh * w * ww)
    boxes = needs[1] or needs[2]
    return per * hh * w * ((ww if needs[0] or boxes else 0)
                           + (h if needs[0] else 0)
                           + (2 * h + ww if boxes else 0))


def check_crop(cfg: Config) -> dict:
    """Both crop kernels against their plain versions at the train shapes
    (HH = WW = 64, the appearance crops, and 32, D_obj's), f32 and bf16:
    the forward, the main path's backward (d_img only), the box gradients
    alone and the backward of all three gradients, each backward twice,
    bitwise equal, and each gradient bitwise the same in every set that
    holds it. Times by CUDA events against the plain versions, the bound
    (operations counted from the hats' nonzeros; the dense one beside it)
    and, in f32, the library calls (``crop_library_calls``). Their device
    times come last (``crop_device_times``)."""
    rows = {}
    names = ("d_img", "d_ry", "d_rx")
    for hh in (64, 32):
        for dtype in (torch.float32, torch.bfloat16):
            imgs, ry, rx, u, boxes = crop_case(cfg, hh, dtype)
            got = crop_fwd(imgs, ry, rx)
            grads = {nd: crop_bwd(imgs, ry, rx, u, nd)
                     for _, nd, _ in CROP_BWD_ROWS}
            again = {nd: crop_bwd(imgs, ry, rx, u, nd) for nd in grads}
            torch.cuda.synchronize()
            want = crop_fwd_plain(imgs, ry, rx)
            want_grads = crop_bwd_plain(imgs, ry, rx, u)
            errs, tols = {}, {}
            # f32: the same products summed in another order (1e-5 of the
            # largest value); bf16: both round one f32 sum to bf16.
            rel = 1e-5 if dtype == torch.float32 else 2 ** -7
            pairs = [("out", got, want)] + [
                (f"{name}{suffix}", a, b)
                for _, nd, suffix in CROP_BWD_ROWS
                for name, a, b in zip(names, grads[nd], want_grads)
                if a is not None]
            for name, a, b in pairs:
                a, b = a.float(), b.float()
                check(bool(torch.isfinite(a).all()), f"crop {name} not finite")
                errs[name] = float((a - b).abs().max())
                tols[name] = rel * float(b.abs().max())
                check(errs[name] <= tols[name],
                      f"crop {name} {dtype} HH={hh}: max abs err "
                      f"{errs[name]} > {tols[name]}")
            for nd in grads:
                check(all(a is None and b is None or torch.equal(a, b)
                          for a, b in zip(grads[nd], again[nd])),
                      f"crop backward {nd} {dtype} HH={hh} is not bitwise "
                      "repeatable")
                check(all(a is None or torch.equal(a, b) for a, b in zip(
                    grads[nd], grads[EVERY_GRAD])),
                      f"crop backward {nd} {dtype} HH={hh} differs from the "
                      "full backward")
            fwd_bound = bound(*crop_work(imgs, ry, rx, u, (got,)), dtype)
            bwd_bounds = {nd: bound(*crop_work(
                imgs, ry, rx, u, [g for g in grads[nd] if g is not None], nd),
                dtype) for nd in grads}
            dense = {"fwd": bound(dense_crop_flops(imgs, ry, rx),
                                  nbytes(imgs, ry, rx, got), dtype)}
            for nd in grads:
                dense[nd] = bound(dense_crop_flops(imgs, ry, rx, nd),
                                  nbytes(imgs, ry, rx, u, *[
                                      g for g in grads[nd] if g is not None]),
                                  dtype)
            lib = {}
            lib_note = "bf16 not timed"
            if dtype == torch.float32:
                calls = crop_library_calls(imgs, boxes, u)
                n, h, w, c = imgs.shape
                o, ww = ry.shape[1], rx.shape[2]
                lf = calls["crop_fwd"]().reshape(n, o, c, hh, ww).permute(
                    0, 1, 3, 4, 2)
                lb = calls["crop_bwd"]()[0].reshape(n, o, c, h, w).sum(
                    1).permute(0, 2, 3, 1)
                lib_err = (float((lf - want).abs().max()),
                           float((lb - want_grads[0]).abs().max()))
                # Sample coordinates are rounded differently (grid_sample
                # unnormalizes [-1, 1]): ~1e-5 pixel. The grid's gradient
                # is the boxes' in another parametrization: timed only.
                agree = (lib_err[0] <= 1e-4 * float(want.abs().max()) and
                         lib_err[1] <= 1e-4 * float(
                             want_grads[0].abs().max()))
                lib_note = {"max_abs_err_fwd": lib_err[0],
                            "max_abs_err_d_img": lib_err[1],
                            "agrees": agree}
                if agree:
                    lib = {k: cuda_ms(fn) for k, fn in calls.items()}
            key = (hh, dtype)
            rows[("crop_fwd",) + key] = dict(
                max_abs_err=errs["out"], tol=tols["out"],
                ms=cuda_ms(lambda: crop_fwd(imgs, ry, rx)),
                plain_ms=cuda_ms(lambda: crop_fwd_plain(imgs, ry, rx)),
                library_ms=lib.get("crop_fwd"), bound_ms=fwd_bound[0],
                bound_by=fwd_bound[1], dense_bound_ms=dense["fwd"][0],
                dense_bound_by=dense["fwd"][1])
            for name, nd, suffix in CROP_BWD_ROWS:
                mine = {f"{g}{suffix}": errs[f"{g}{suffix}"]
                        for g, on in zip(names, nd) if on}
                rows[(name,) + key] = dict(
                    needs=nd, max_abs_err=max(mine.values()), errs=mine,
                    tols={k: tols[k] for k in mine},
                    ms=cuda_ms(lambda: crop_bwd(imgs, ry, rx, u, nd)),
                    plain_ms=cuda_ms(
                        lambda: crop_bwd_plain(imgs, ry, rx, u, nd)),
                    library_ms=lib.get(name), bound_ms=bwd_bounds[nd][0],
                    bound_by=bwd_bounds[nd][1], dense_bound_ms=dense[nd][0],
                    dense_bound_by=dense[nd][1])
            for name in ("crop_fwd",) + tuple(r[0] for r in CROP_BWD_ROWS):
                say(f"kernel {name}", hh=hh, dtype=str(dtype),
                    library=lib_note, **rows[(name,) + key])
    return rows


def stem_device_times(cfg: Config, rows: dict) -> None:
    """Each stem row's device time per call and its grouped-conv
    yardstick's (the profiler's own kernel times), added to ``rows``; run
    after every end-to-end phase, as ``crop_device_times`` is."""
    for dtype in (torch.float32, torch.bfloat16):
        w, g = stem_inputs(cfg, dtype)
        dev = device_kernels_ms(lambda: stem(w, g))
        lib = device_kernels_ms(stem_library_call(w, g))
        row = rows[dtype]
        row.update(device_ms=device_total_ms(dev), device_kernels=dev,
                   library_device_ms=device_total_ms(lib),
                   library_device_kernels=lib)
        say("kernel stem device", dtype=str(dtype), device_ms=row["device_ms"],
            device_kernels=dev, library_device_ms=row["library_device_ms"],
            library_device_kernels=lib, bound_ms=row["bound_ms"],
            clocks_sm=sm_clock())


def crop_device_times(cfg: Config, rows: dict) -> None:
    """Each crop row's device time per call and its library call's (the
    profiler's own kernel times), added to ``rows``. It runs after every
    end-to-end phase: a profiler session seems to leave host work behind
    that slows the launches after it (NVIDIA H100 80GB HBM3, 700 W: with
    these sessions before it, the factored serving rate read 910-940
    img/s against 1164-1193 without, at the same device busy time)."""
    for hh in (64, 32):
        for dtype in (torch.float32, torch.bfloat16):
            imgs, ry, rx, u, boxes = crop_case(cfg, hh, dtype)
            calls = {"crop_fwd": lambda: crop_fwd(imgs, ry, rx)}
            for name, nd, _ in CROP_BWD_ROWS:
                calls[name] = lambda nd=nd: crop_bwd(imgs, ry, rx, u, nd)
            timed_lib = rows[("crop_fwd", hh, dtype)]["library_ms"] is not None
            libs = crop_library_calls(imgs, boxes, u) if timed_lib else {}
            for name, fn in calls.items():
                dev = device_kernels_ms(fn)
                row = rows[(name, hh, dtype)]
                row.update(device_ms=device_total_ms(dev), device_kernels=dev,
                           library_device_ms=device_total_ms(
                               device_kernels_ms(libs[name]))
                           if name in libs else None)
                say(f"kernel {name} device", hh=hh, dtype=str(dtype),
                    device_ms=row["device_ms"], device_kernels=dev,
                    library_device_ms=row["library_device_ms"],
                    bound_ms=row["bound_ms"], clocks_sm=sm_clock())


def compositor_device_times(cfg: Config, rows: dict) -> None:
    """The compositor's device time per call at the serving shape (the
    profiler's own kernel times), added to ``rows``; run after every
    end-to-end phase, as ``crop_device_times`` is."""
    case = compositor_case(cfg)
    for dtype in (torch.float32, torch.bfloat16):
        inputs = to_compositor(cfg, case, dtype)
        dev = device_kernels_ms(lambda: composite(*inputs))
        row = rows[dtype]
        row.update(device_ms=device_total_ms(dev), device_kernels=dev)
        say("kernel compositor device", dtype=str(dtype),
            device_ms=row["device_ms"], device_kernels=dev,
            bound_ms=row["bound_ms"], clocks_sm=sm_clock())


def check_forward_only_guards() -> None:
    """The stem and compositor kernels are forward-only: their wrappers
    refuse inputs that require grad instead of detaching the graph."""
    w = torch.rand(1, 14, 14, 3, device="cuda", requires_grad=True)
    g = torch.rand(1, 7, 7, 3, 4, device="cuda")
    inputs = compositor_inputs(
        torch.ones((1, 2, 4), device="cuda", requires_grad=True),
        torch.tensor([0.1, 0.1, 0.9, 0.9], device="cuda").repeat(1, 2, 1),
        torch.full((1, 2, 8, 8), 0.7, device="cuda"),
        torch.ones((1, 2), device="cuda"), 32, 32)
    refused = {}
    for name, fn in (("stem", lambda: stem(w, g)),
                     ("compositor", lambda: composite(*inputs))):
        try:
            fn()
            refused[name] = False
        except RuntimeError as e:
            refused[name] = "forward-only" in str(e)
        check(refused[name], f"the {name} kernel took inputs that require "
              "grad")
    say("forward-only guards", refused=refused)


# --- phases 4-7: the model --------------------------------------------------

def with_model(cfg: Config, **kw) -> Config:
    return cfg.replace(model=dataclasses.replace(cfg.model, **kw))


def model_inputs(cfg: Config, n: int, device, seed: int = 3,
                 gt_appearance: bool = False):
    """Batch tensors on ``device``; zero features with a zero mask, so every
    object's appearance comes from repr_net (as bench.py serves), or with
    ``gt_appearance`` the batch's images and no features, so every object's
    appearance encodes its crop of them."""
    mc = cfg.model
    b = synthetic_batch(cfg, seed=seed, batch_size=n)
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    o = b.objs.shape[1]
    inputs = dict(objs=t(b.objs), triples=t(b.triples),
                  attributes=t(b.attributes), obj_mask=t(b.obj_mask),
                  triple_mask=t(b.triple_mask),
                  mask_noise=torch.zeros(mc.mask_noise_dim, device=device),
                  boxes_gt=t(b.boxes))
    if gt_appearance:
        return dict(inputs, imgs=t(b.imgs))
    return dict(inputs,
                features=torch.zeros((n, o, mc.rep_size), device=device),
                features_mask=torch.zeros((n, o), device=device))


def spread_mask_head(model) -> float:
    """Scale the mask net's last 1x1 conv so mask logits have unit spread.

    With seed-initialised weights and BN running statistics of mean 0 /
    var 1, the mask logits shrink to a spread of ~3e-4, so predicted masks
    sit within ~1e-4 of 0.5: bf16 rounds them to exactly 0.5, nothing is
    claimed and every image is constant. A trained model's BN statistics keep masks
    away from 0.5; scaling the (linear) last conv stands in for that."""
    cfg = Config()
    dev = next(model.parameters()).device
    with torch.no_grad():
        out = model(**model_inputs(cfg, 2, dev))
        spread = float(torch.logit(out.masks_pred.double()).std())
        model.mask_net.out.weight.div_(spread)
        model.mask_net.out.bias.div_(spread)
    return spread


def png_pixels(b64: str) -> np.ndarray:
    """Decode an 8-bit RGB, filter-0 PNG as serve.py writes it."""
    raw = base64.b64decode(b64)
    check(raw[:8] == b"\x89PNG\r\n\x1a\n", "response image is not a PNG")
    pos, idat, size = 8, b"", None
    while pos < len(raw):
        length = int.from_bytes(raw[pos:pos + 4], "big")
        tag = raw[pos + 4:pos + 8]
        data = raw[pos + 8:pos + 8 + length]
        if tag == b"IHDR":
            size = (int.from_bytes(data[4:8], "big"),
                    int.from_bytes(data[0:4], "big"))
        elif tag == b"IDAT":
            idat += data
        pos += 12 + length
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(
        size[0], 1 + size[1] * 3)
    return rows[:, 1:].reshape(size[0], size[1], 3)


def check_images(imgs: torch.Tensor, what: str) -> None:
    check(bool(torch.isfinite(imgs).all()), f"{what}: images not finite")
    spread = imgs.flatten(1).std(dim=1)
    check(bool((spread > 0).all()), f"{what}: a constant image "
          f"(per-image std {spread.tolist()})")


def scene_graphs(vocab) -> list:
    names = [n for n in vocab["object_idx_to_name"] if n != "__image__"]
    return [
        {"objects": [names[4], names[16], names[41]],
         "relationships": [[0, "left of", 1], [1, "above", 2]],
         "attributes": {"size": [4, 5, 3], "location": [6, 12, 18]},
         "features": [-1, -1, -1], "image_id": 0},
        {"objects": [names[0], names[99], names[7], names[150], names[63]],
         "relationships": [[0, "inside", 1], [2, "below", 3],
                           [4, "right of", 0]],
         "attributes": {"size": [2, 7, 3, 1, 4],
                        "location": [0, 12, 20, 24, 7]},
         "features": [-1, -1, -1, -1, -1], "image_id": 3},
        {"objects": [names[170], names[22]],
         "relationships": [[0, "surrounding", 1]],
         "attributes": {"size": [8, 2], "location": [12, 13]},
         "image_id": 1},
    ]


def forward_b16(server: Server):
    """A batch-16 ``forward_batch`` with every object's appearance from
    repr_net (zero features under a zero mask, as bench.py serves)."""
    cfg = server.model.cfg
    batch = synthetic_batch(cfg, seed=4, batch_size=BATCH)
    n, o = batch.objs.shape
    out = server.model.forward_batch(
        batch, features=np.zeros((n, o, cfg.model.rep_size), np.float32),
        features_mask=np.zeros((n, o), np.float32))
    torch.cuda.synchronize()
    return out


def serve_and_forward(ckpt: str) -> dict:
    """Phase 4: HTTP serving, then a batch-16 forward, of the default
    Config() in bf16 (factored stem -> the stem kernel)."""
    server = Server(ckpt, device="cuda")
    httpd = HTTPServer(("127.0.0.1", 0), make_handler(server))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        _cuda.LAUNCHES.clear()
        health = json.loads(urllib.request.urlopen(
            base + "/healthz", timeout=60).read())
        check(health["status"] == "ok" and health["device"].startswith(
            "cuda"), f"healthz {health}")
        vocab = json.loads(urllib.request.urlopen(base + "/vocab",
                                                  timeout=60).read())
        check(len(vocab["objects"]) == server.model.cfg.model.num_objs - 1,
              "vocab lists the wrong number of objects")
        graphs = scene_graphs(server.model.vocab)
        for i, sg in enumerate(graphs):
            req = urllib.request.Request(
                base + "/generate",
                data=json.dumps({"scene_graphs": [sg, graphs[0]]}).encode(),
                headers={"Content-Type": "application/json"})
            resp = json.loads(urllib.request.urlopen(req, timeout=300).read())
            check(set(resp) == {"images", "layouts", "boxes_pred"},
                  f"response keys {sorted(resp)}")
            check(len(resp["images"]) == len(resp["layouts"]) == 2,
                  "one image and one layout per scene graph")
            check(len(resp["boxes_pred"][0]) == len(sg["objects"]) + 1,
                  "boxes for every object and __image__")
            for b64 in resp["images"] + resp["layouts"]:
                px = png_pixels(b64)
                check(px.shape[2] == 3, "PNG is not RGB")
            check(png_pixels(resp["images"][0]).std() > 0,
                  f"request {i}: constant image")

        out = forward_b16(server)
        launches = dict(_cuda.LAUNCHES)
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    check(not thread.is_alive(), "HTTP server thread did not stop")
    check(tuple(out.imgs_pred.shape) == (BATCH, 128, 128, 3),
          f"imgs_pred {tuple(out.imgs_pred.shape)}")
    check_images(out.imgs_pred, "serving b16")
    check(launches.get("stem", 0) > 0, f"stem kernel not launched: {launches}")
    check(launches.get("stem_tc", 0) > 0,
          f"bf16 serving did not run the tensor-core stem: {launches}")
    check(launches.get("compositor", 0) == 0,
          f"factored path launched the compositor: {launches}")
    say("serving", requests=len(graphs), batch=BATCH, launches=launches,
        img_std=float(out.imgs_pred.std()))
    return launches


def dense_forward(ckpt: str) -> dict:
    """Phase 5: the dense-stem variant (compositor kernel) at b16 bf16."""
    server = Server(ckpt, device="cuda")
    _cuda.LAUNCHES.clear()
    out = forward_b16(server)
    launches = dict(_cuda.LAUNCHES)
    check_images(out.imgs_pred, "dense b16")
    check(launches.get("compositor", 0) > 0,
          f"compositor kernel not launched: {launches}")
    check(launches.get("stem", 0) == 0,
          f"dense path launched the stem: {launches}")
    say("dense", batch=BATCH, launches=launches,
        img_std=float(out.imgs_pred.std()))
    return launches


def gt_appearance(ckpt: str) -> dict:
    """Phase 5b: the GT-appearance forward (``forward_batch(features=
    None)``, as ``sample_images --use_gt_textures`` serves it) of the
    default Config() at b16 bf16: every object's appearance encoded from
    its crop of the batch's images, through the crop forward kernel."""
    server = Server(ckpt, device="cuda")
    batch = synthetic_batch(server.model.cfg, seed=4, batch_size=BATCH)
    _cuda.LAUNCHES.clear()
    out = server.model.forward_batch(batch)
    torch.cuda.synchronize()
    launches = dict(_cuda.LAUNCHES)
    check(tuple(out.imgs_pred.shape) == (BATCH, 128, 128, 3),
          f"GT appearance imgs_pred {tuple(out.imgs_pred.shape)}")
    check_images(out.imgs_pred, "GT appearance b16")
    check(launches.get("crop_fwd", 0) > 0,
          f"GT appearance did not run the crop forward kernel: {launches}")
    check(launches.get("stem_tc", 0) > 0,
          f"GT appearance did not run the tensor-core stem: {launches}")
    say("GT appearance", batch=BATCH, launches=launches,
        img_std=float(out.imgs_pred.std()),
        obj_repr_std=float(out.obj_repr.std()))
    return launches


def card_vs_cpu(model_cpu) -> None:
    """Phase 6: the same f32 weights on the card (kernels) and on the CPU
    (plain versions), batch 2, TF32 off, both stem variants and the
    GT-appearance forward (factored stem). GT boxes and masks
    of 0.1 / 0.9 keep the layout's claims away from the 0.5 step, so the
    images compare the arithmetic, not rounding at a threshold."""
    cfg = Config()
    model_gpu = build_model(cfg, "cuda", SEED)
    model_gpu.load_state_dict(model_cpu.state_dict())
    rng = np.random.RandomState(5)
    m = cfg.model.mask_size
    masks = np.where(rng.rand(2, cfg.data.max_objs, m, m) > 0.4, 0.9, 0.1)
    # imgs: a deep f32 generator (cuDNN vs oneDNN convs, instance norms)
    # amplifies last-bit differences; boxes / masks: a few f32 layers.
    tols = {"imgs_pred": 2e-3, "boxes_pred": 1e-4, "masks_pred": 1e-5}
    # The GT-appearance variant encodes every object's crop of the batch's
    # images (the crop forward kernel on the card, its plain version on the
    # CPU), as forward_batch(features=None) serves it.
    for factored, gt_appearance in ((True, False), (False, False),
                                    (True, True)):
        errs = {}
        outs = []
        for model, dev in ((model_gpu, "cuda"), (model_cpu, "cpu")):
            # factored_stem picks a path and owns no parameter, so one set
            # of weights serves both variants.
            model.cfg = with_model(cfg, factored_stem=factored).model
            inputs = model_inputs(cfg, 2, dev, gt_appearance=gt_appearance)
            inputs["masks_gt"] = torch.as_tensor(masks, dtype=torch.float32,
                                                 device=dev)
            with torch.no_grad():
                outs.append(model(**inputs, use_gt_box=True))
        for key, tol in tols.items():
            a = getattr(outs[0], key).cpu()
            b = getattr(outs[1], key)
            errs[key] = float((a - b).abs().max())
            check(errs[key] <= tol,
                  f"card vs cpu {key} (factored={factored}): {errs[key]} > {tol}")
        check_images(outs[0].imgs_pred, "card f32")
        say("card vs cpu", factored=factored, gt_appearance=gt_appearance,
            max_abs_diff=errs, tol=tols)
    del model_gpu


@contextlib.contextmanager
def torch_default_tf32():
    """PyTorch's default float32 flags (cuDNN convolutions in TF32, cuBLAS
    matmuls in full f32), which the train CLI runs with; this script turns
    TF32 off everywhere else for its comparisons."""
    flags = (torch.backends.cuda.matmul, torch.backends.cudnn)
    prev = [f.allow_tf32 for f in flags]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        for f, p in zip(flags, prev):
            f.allow_tf32 = p


def device_rows(prof) -> list:
    """The profiler's device-side rows by time: kernels and copies, not
    the device spans of ``record_function`` ranges (such as the
    optimizer's step), which would count their kernels twice."""
    from torch.autograd import DeviceType
    return sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and device_ms(e) > 0
                   and not getattr(e, "is_user_annotation", False)),
                  key=device_ms, reverse=True)


def device_ms(event) -> float:
    us = getattr(event, "self_device_time_total", None)
    return (event.self_cuda_time_total if us is None else us) / 1e3


def serving_rate(ckpts: dict) -> dict:
    """Phase 7 (informational): per variant's checkpoint, the b16 bf16
    forward's time by CUDA events around the whole model call, then
    TRACE_STEPS forwards under torch.profiler: the device's busy time (its
    kernels' and copies' own times; the host-side aten rows would count
    them twice), its idle share over the forward, and the costliest
    kernels."""
    from torch.profiler import ProfilerActivity, profile
    rates = {}
    for variant, ckpt in ckpts.items():
        server = Server(ckpt, device="cuda")
        model = server.model.model
        inputs = model_inputs(server.model.cfg, BATCH, "cuda")

        def fwd():
            with torch.no_grad():
                model(**inputs)

        ms = cuda_ms(fwd, warmup=3, reps=10)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(TRACE_STEPS):
                fwd()
            torch.cuda.synchronize()
        rows = device_rows(prof)
        busy = sum(device_ms(e) for e in rows) / TRACE_STEPS
        rate = dict(ms=ms, img_per_s=BATCH / ms * 1e3)
        if rows:
            check(busy <= ms, f"{variant}: device busy {busy} ms exceeds "
                  f"the forward's {ms} ms")
            rate.update(device_busy_ms=busy, idle_share=1 - busy / ms,
                        kernel_kinds=len(rows),
                        top=[dict(name=e.key[:80],
                                  ms=device_ms(e) / TRACE_STEPS,
                                  calls=e.count / TRACE_STEPS)
                             for e in rows[:8]])
        else:
            rate.update(device_busy_ms="not measured: the profiler saw no "
                        "device time")
        rates[variant] = rate
        del server, model
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    say("serving rate", batch=BATCH, dtype="bfloat16",
        peak_memory_gib=peak_gb, **rates)
    return rates


# --- phases 8-9: training ---------------------------------------------------

def train_on_card() -> dict:
    """Phase 8: the default ``Config()`` (generator f32, discriminators
    and VGG bf16; PyTorch's default TF32 flags, as the train CLI runs) at
    batch 12 through the port's train loop: TRAIN_STEPS steps, every loss
    term finite each step, every parameter tree moved by the first, the
    crop kernels launched; then ms/step by CUDA events (median after
    warm-up), peak device memory, and one step under torch.profiler."""
    fn, (state, batch) = train_entry(batch_size=TRAIN_BATCH, seed=SEED)
    before = {name: [p.detach().clone() for p in m.parameters()]
              for name, m, _ in state.trees()}
    moved = {}

    def on_step(i, metrics):
        if i == 0:
            for name, m, _ in state.trees():
                flags = [not torch.equal(a, p)
                         for a, p in zip(before[name], m.parameters())]
                moved[name] = sum(flags) / len(flags)

    _cuda.LAUNCHES.clear()
    logged = train_run(state, TRAIN_STEPS, print_every=1, on_step=on_step)
    torch.cuda.synchronize()
    launches = dict(_cuda.LAUNCHES)
    del before
    check(len(logged) == TRAIN_STEPS, f"{len(logged)} of {TRAIN_STEPS} "
          "steps logged")           # train_run raises on a non-finite term
    # The box head's gradient is zero on a use_gt = 0 step, so a few
    # leaves may stay; every tree must move almost all of its leaves.
    check(all(v > 0.9 for v in moved.values()),
          f"parameter trees barely moved by the first step: {moved}")
    check(launches.get("crop_fwd", 0) >= 4 * TRAIN_STEPS
          and launches.get("crop_bwd", 0) >= TRAIN_STEPS,
          f"crop kernels not launched on every step: {launches}")
    # Boxes are batch constants: the box gradients' kernels never run.
    check(launches.get("crop_bwd_boxes", 0) == 0,
          f"the train step launched the d_ry / d_rx kernels: {launches}")

    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(lambda: fn(state, batch), warmup=2, reps=6)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn(state, batch)
        torch.cuda.synchronize()
    rows = device_rows(prof)
    busy = sum(device_ms(e) for e in rows)
    # The step's phases (train_step's record_function ranges): host time,
    # and the span each took on the device.
    phases = {}
    for e in prof.key_averages():
        if e.key.startswith("train_step/"):
            ph = phases.setdefault(e.key.split("/", 1)[1], {})
            if getattr(e, "is_user_annotation", False) and e.device_type != \
                    torch.autograd.DeviceType.CPU:
                ph["device_span_ms"] = (getattr(e, "device_time_total", None)
                                        or e.cuda_time_total) / 1e3
            else:
                ph["host_ms"] = e.cpu_time_total / 1e3
    out = dict(batch=TRAIN_BATCH, steps=TRAIN_STEPS, launches=launches,
               leaves_moved=moved, ms_per_step=ms,
               img_per_s=TRAIN_BATCH / ms * 1e3, peak_memory_gib=peak_gb,
               last_losses=logged[-1])
    if rows:
        out.update(device_busy_ms=busy, idle_share=1 - busy / ms,
                   kernel_kinds=len(rows), phases=phases,
                   crop_kernels_ms=sum(device_ms(e) for e in rows
                                       if "crop_" in e.key),
                   top=[dict(name=e.key[:80], ms=device_ms(e),
                             calls=e.count) for e in rows[:10]])
    else:
        out.update(device_busy_ms="not measured: the profiler saw no "
                   "device time")
    say("train", **out)
    return out


def train_card_vs_cpu() -> None:
    """Phase 9: one train step of the full-width default ``Config()`` with
    every dtype f32 (TF32 off), batch 2, from one seed-initialised state
    on the card (kernels) and on the CPU (plain versions), with the same
    draws (use_gt = 1). Compared: every loss term (1e-4 relative), the
    first moment of every parameter of the four Adams (= 0.5 * grad), and
    every batch-norm running statistic (1e-4 relative).

    The moments' tolerance is per leaf 5e-2 of the leaf's max |m| plus
    1e-4 of its tree's max (the second term for leaves whose gradient is
    zero in exact arithmetic, such as a bias before an instance norm). In
    f32 the two devices' last-bit differences move a few ReLU decisions of
    the full-width generator, and each such flip moves every weight
    gradient of its layer: a few percent of a leaf's scale. The same
    generator's backward in f64 agrees within 1e-7 (``generator_f64``),
    so the spread is rounding, not a different function."""
    cfg = Config()
    cfg = cfg.replace(discriminator=dataclasses.replace(
        cfg.discriminator, compute_dtype="float32"))
    t0 = time.perf_counter()
    states = {dev: create_train_state(cfg, dev, seed=SEED, load_vgg=False)
              for dev in ("cuda", "cpu")}
    batch = synthetic_batch(cfg, seed=7, batch_size=2)
    d = draw(states["cpu"])
    draws = Draws(torch.tensor(1.0), d.mask_noise, d.pool_base)
    metrics = {}
    for dev, state in states.items():
        t = time.perf_counter()
        metrics[dev] = {k: v.cpu() for k, v in train_step(
            state, batch, draws).items() if not k.startswith("_")}
        metrics[dev + "_s"] = time.perf_counter() - t
    loss_err = 0.0
    for k, want in metrics["cpu"].items():
        got = metrics["cuda"][k]
        err = float((got - want).abs())
        check(err <= 1e-4 * abs(float(want)) + 1e-6,
              f"card vs cpu train loss {k}: {float(got)} vs {float(want)}")
        loss_err = max(loss_err, err / max(abs(float(want)), 1e-6))
    ratios, stat_err = [], 0.0
    trees = zip(states["cuda"].trees(), states["cpu"].trees())
    for (name, m_gpu, o_gpu), (_, m_cpu, o_cpu) in trees:
        pairs = list(zip(m_gpu.parameters(), m_cpu.parameters()))
        moms = [(o_gpu.state[a]["exp_avg"].cpu(), o_cpu.state[b]["exp_avg"])
                for a, b in pairs]
        tree_max = max(float(b.abs().max()) for _, b in moms)
        for (pname, _), (a, b) in zip(m_cpu.named_parameters(), moms):
            leaf_max = float(b.abs().max())
            err = float((a - b).abs().max())
            tol = 5e-2 * leaf_max + 1e-4 * tree_max
            ratios.append((err / tol, f"{name}.{pname}", err, leaf_max,
                           tree_max))
        for (bname, a), b in zip(m_gpu.named_buffers(), m_cpu.buffers()):
            err = float((a.cpu() - b).abs().max())
            check(err <= 1e-4 * float(b.abs().max()) + 1e-7,
                  f"card vs cpu batch statistic {name}.{bname}: {err}")
            stat_err = max(stat_err, err)
    ratios.sort(reverse=True)
    say("train card vs cpu moments", worst=[
        dict(leaf=k, err_over_tol=r, err=e, leaf_max=lm, tree_max=tm)
        for r, k, e, lm, tm in ratios[:6]], worst_per_tree={
            tree: next(r for r, k, *_ in ratios if k.startswith(tree + "."))
            for tree in ("g", "d_img", "d_obj", "d_mask")})
    check(ratios[0][0] <= 1.0, f"card vs cpu first moment {ratios[0][1]}: "
          f"{ratios[0][2]} over its tolerance")
    moment_ratio, n_leaves = ratios[0][0], len(ratios)
    say("train card vs cpu", batch=2, leaves=n_leaves,
        max_rel_loss_err=loss_err, max_moment_err_over_tol=moment_ratio,
        max_batch_stat_err=stat_err, cuda_step_s=metrics["cuda_s"],
        cpu_step_s=metrics["cpu_s"], seconds=time.perf_counter() - t0)
    del states


def generator_f64() -> None:
    """Phase 9b: the train-mode generator's backward (the factored stem's
    ``patches`` form, convs, instance norms, the transpose convs) in f64
    on the card and on the CPU, from one set of weights and one
    cotangent: every parameter's gradient within 1e-7 of its scale (or
    of 1e-6 of the largest gradient, for a bias before an instance norm,
    whose gradient is zero in exact arithmetic): five orders of magnitude
    below the f32 spread that ``train_card_vs_cpu`` allows."""
    from scene_generation_tpu_torch.models.generators import GlobalGenerator
    from scene_generation_tpu_torch.models.layers import init_weights
    mc = Config().model
    gen = torch.Generator().manual_seed(8)
    h, w = mc.image_size
    o = Config().data.max_objs
    lw = torch.rand((2, o, h, w), generator=gen, dtype=torch.float64)
    vecs = torch.randn((2, o, mc.layout_nc), generator=gen,
                       dtype=torch.float64)
    cot = torch.randn((2, h, w, mc.output_nc), generator=gen,
                      dtype=torch.float64)
    grads = {}
    for dev in ("cuda", "cpu"):
        g = init_weights(GlobalGenerator(mc.layout_nc, mc.output_nc, mc.ngf,
                                         mc.n_downsample_global,
                                         mc.n_blocks_global), SEED)
        g = g.to(dev, torch.float64).train()
        y = g(weights=lw.to(dev), vecs=vecs.to(dev))
        grads[dev] = [t.cpu() for t in torch.autograd.grad(
            (y * cot.to(dev)).sum(), list(g.parameters()))]
    top = max(float(b.abs().max()) for b in grads["cpu"])
    worst = max(float((a - b).abs().max())
                / max(float(b.abs().max()), 1e-6 * top)
                for a, b in zip(grads["cuda"], grads["cpu"]))
    check(worst <= 1e-7, f"f64 generator gradients differ: {worst}")
    say("generator f64 card vs cpu", max_rel_grad_err=worst,
        leaves=len(grads["cpu"]))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--only", choices=("stem", "compositor", "crop"),
                        help="build and check one kernel alone (its phase "
                        "and its device times); no result line")
    args = parser.parse_args(argv)
    t0 = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    card = smi("name,power.limit")
    say("device", name=name, count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda,
        clocks_sm=sm_clock())
    print(card, flush=True)

    t = time.perf_counter()
    built = _cuda.build([args.only] if args.only else _cuda.KERNELS)
    say("build", seconds=time.perf_counter() - t,
        per_kernel={k: v["seconds"] for k, v in built.items()})

    cfg = with_model(Config(), compute_dtype="bfloat16")
    if args.only:
        check_phase, times, kcfg = {
            "stem": (check_stem, stem_device_times, cfg),
            "compositor": (check_compositor, compositor_device_times, cfg),
            "crop": (check_crop, crop_device_times, Config())}[args.only]
        times(kcfg, check_phase(kcfg))
        return 0
    stem_rows = check_stem(cfg)
    comp_rows = check_compositor(cfg)
    crop_rows = check_crop(Config())
    check_forward_only_guards()

    model = build_model(Config(), "cuda", SEED)
    spread = spread_mask_head(model)
    model_cpu = build_model(Config(), "cpu", SEED)
    model_cpu.load_state_dict(model.state_dict())
    del model
    with tempfile.TemporaryDirectory() as tmp:
        ckpts = {"factored": os.path.join(tmp, "factored"),
                 "dense": os.path.join(tmp, "dense")}
        save_checkpoint(ckpts["factored"], model_cpu, cfg,
                        synthetic_vocab(cfg.model.num_objs))
        # The dense variant: the same weights under factored_stem=False.
        os.makedirs(ckpts["dense"])
        for f in ("model.pt", "vocab.json"):
            os.symlink(os.path.join(ckpts["factored"], f),
                       os.path.join(ckpts["dense"], f))
        with open(os.path.join(ckpts["dense"], "config.json"), "w") as f:
            f.write(with_model(cfg, factored_stem=False).to_json())
        say("checkpoint", mask_logit_spread_before=spread)
        serve_launches = serve_and_forward(ckpts["factored"])
        dense_launches = dense_forward(ckpts["dense"])
        gt_appearance(ckpts["factored"])
        card_vs_cpu(model_cpu)
        rates = serving_rate(ckpts)
    del model_cpu
    with torch_default_tf32():
        train = train_on_card()
    train_card_vs_cpu()
    generator_f64()
    stem_device_times(cfg, stem_rows)
    compositor_device_times(cfg, comp_rows)
    crop_device_times(Config(), crop_rows)

    def row(name, src, replaces, launches, r):
        return dict(name=name, route="cuda", source=src, replaces=replaces,
                    launches=launches, max_abs_err=r["max_abs_err"],
                    ms=r["ms"], plain_ms=r["plain_ms"],
                    bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                    library_ms=r["library_ms"],
                    **{k: r[k] for k in ("device_ms", "library_device_ms")
                       if k in r})

    kernels = [
        row("stem", "scene_generation_tpu_torch/csrc/stem.cu",
            "scene_generation_tpu/ops/pallas/stem.py:47",
            serve_launches["stem_tc"], stem_rows[torch.bfloat16]),
        row("compositor", "scene_generation_tpu_torch/csrc/compositor.cu",
            "scene_generation_tpu/ops/pallas/compositor.py:48",
            dense_launches["compositor"], comp_rows[torch.bfloat16]),
        # D_obj's crops (3 of the 4 forward launches a step; f32, as the
        # train step runs them) and the main path's backward (d_img only);
        # the 64 px appearance crops and the three-gradient backward are
        # printed above.
        row("crop_fwd", "scene_generation_tpu_torch/csrc/crop.cu",
            "scene_generation_tpu/ops/pallas/crop.py:88",
            train["launches"]["crop_fwd"],
            crop_rows[("crop_fwd", 32, torch.float32)]),
        row("crop_bwd", "scene_generation_tpu_torch/csrc/crop.cu",
            "scene_generation_tpu/ops/pallas/crop.py:126",
            train["launches"]["crop_bwd"],
            crop_rows[("crop_bwd", 32, torch.float32)]),
        # The box gradients (d_ry, d_rx) alone: no path of the port asks
        # for them (boxes are batch constants), so 0 launches.
        row("crop_bwd_boxes", "scene_generation_tpu_torch/csrc/crop.cu",
            "scene_generation_tpu/ops/pallas/crop.py:126",
            train["launches"].get("crop_bwd_boxes", 0),
            crop_rows[("crop_bwd_boxes", 32, torch.float32)]),
    ]
    say("done", seconds=time.perf_counter() - t0,
        img_per_s={k: v["img_per_s"] for k, v in rates.items()},
        train_ms_per_step=train["ms_per_step"])
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
