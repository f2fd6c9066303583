#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``scene_generation_tpu_torch/csrc``,
holds each against its plain PyTorch version at the shapes of its path
(the stem and the compositor at the serving shapes, the crop forward and
backward at the train shapes and the crop forward at the accuracy net's
224 px, timed by CUDA events around a call and by the profiler's device
time), checks that the forward-only kernels refuse
inputs that require grad, serves HTTP requests and a batch-16 forward
through the default ``Config()`` (the factored stem, bf16: the
tensor-core stem kernel), runs the dense-stem variant (the compositor
kernel) and the GT-appearance forward (``forward_batch(features=None)``:
the crop forward kernel) and compares the card with the CPU in f32.
Then it trains: a few steps of the default ``Config()``
at batch 12 through ``train_step`` (the crop kernels; the box gradients'
kernel must not run), timed and profiled; one f32 train step on the
card against the same step on the CPU; the kernels' device times; and
last the train CLI as a user runs it (``train.main``: 9 steps,
checkpoints with the val sweeps, which run the f32 stem kernel, and best
promotion, then a bitwise resume, a ``--preset quality`` run and
serving its ``best/``; its checkpoints take about 5 GB of temporary
disk), and the inference and evaluation tools on that ``best/``
(``eval_phase``: encode_features, train_accuracy_net, sample_images,
compute_fid, compute_diversity, the GUI server), each stage's kernel
launches held to the counts the code predicts. Then the paper's
checkpoint format (``reference_phase``: a seeded reference-format ``.pt``
at full width ported by ``tools.port_reference_checkpoint``, bitwise,
served at f32 through the 3xTF32 stem kernel and at bf16, one train step
resumed from it), the COCO readers on
this machine, which has no PIL (``coco_phase``: a fake COCO directory of
480x360 PNGs, examples of both families, the native mask codec against
its numpy version, the host's ms an example, ``train.main --coco_dir``
with process workers and a checkpoint, ``--is_panoptic 1`` and
``encode_features --coco_dir``), and last data parallelism
(``ddp_phase``: two ranks on this card over gloo, one step at 6 + 6
images against the single-process step on the 12, then
``train.main --distributed`` with a checkpoint from rank 0 alone and a
resume on both ranks; this script runs each rank as
``--ddp-step`` / ``--ddp-cli``). Every phase prints one line; any
failure raises and the exit code is non-zero. Without a CUDA device it
exits non-zero before printing any result.

The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --only {stem,compositor,crop,train,ddp}

builds and checks one kernel alone (its phase and its device times; the
crop's also at a DDP rank's 6 images), or runs the train step's phase 8 or
the ddp phase alone, and prints no result line: the quick loop while
working on one of them.
"""
from __future__ import annotations

import argparse
import base64
import collections
import contextlib
import dataclasses
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.parse
import urllib.request
from http.server import HTTPServer

import numpy as np
import torch

from scene_generation_tpu_torch import train as train_cli
from scene_generation_tpu_torch.api import InferenceModel
from scene_generation_tpu_torch.config import Config
from scene_generation_tpu_torch.convert import (load_checkpoint,
                                                save_checkpoint)
from scene_generation_tpu_torch.data import (SyntheticDataset, synthetic_batch,
                                             synthetic_vocab)
from scene_generation_tpu_torch.data.image_utils import decode_png
from scene_generation_tpu_torch.data.loader import DataLoader
from scene_generation_tpu_torch.entry import build_model, train_entry
from scene_generation_tpu_torch.ops import _cuda
from scene_generation_tpu_torch.ops.compositor import (composite,
                                                       composite_plain)
from scene_generation_tpu_torch.ops.crop import (crop_bwd, crop_bwd_plain,
                                                 crop_fwd, crop_fwd_plain)
from scene_generation_tpu_torch.ops.layout import compositor_inputs
from scene_generation_tpu_torch.ops.sampling import (crop_matrices,
                                                      exact_f32_matmul)
from scene_generation_tpu_torch.ops.stem import (f32_launch_config, stem,
                                                 stem_plain, tc_launch_config)
from scene_generation_tpu_torch.serve import Server, make_handler
from scene_generation_tpu_torch.tools import (compute_diversity, compute_fid,
                                              encode_features, gui_server,
                                              sample_images,
                                              train_accuracy_net)
from scene_generation_tpu_torch.trainer import checkpoint as ckpt_mod
from scene_generation_tpu_torch.trainer.step import Draws, draw, train_step
from scene_generation_tpu_torch.trainer.train_state import create_train_state

BATCH = 16
SEED = 0
TRAIN_BATCH = 12
TRAIN_STEPS = 3
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, f32 outside
# them, TF32 tensor cores (the f32 stem's 3xTF32: three TF32 products a
# multiply-add, counted as three operations' worth), HBM bandwidth.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12, "tf32": 495e12}
TF32_SPLIT_PRODUCTS = 3
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
    """Device milliseconds of one call by kernel, under torch.profiler over
    ``reps`` calls after one warm-up: each kernel's mean time a launch
    times its launches a call. That is the call's time on the card without
    the host's launch work, which ``cuda_ms`` includes where the host is
    the slower of the two. The profiler can record only some launches (its
    count then is not a multiple of ``reps``): a kernel's launches a call
    are its count over ``reps`` rounded, and a count more than a quarter
    launch a call off a whole number (or under one a call) is not
    measured. Empty when nothing was measured."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out, short = {}, []
    for e in device_rows(prof):
        per_call = e.count / reps
        launches = round(per_call)
        if launches < 1 or abs(per_call - launches) > 0.25:
            print(f"device times not measured: the profiler recorded "
                  f"{e.count} launches of {e.key[:60]} over {reps} calls",
                  flush=True)
            return {}
        if e.count % reps:
            short.append((e.key[:60], e.count))
        out[e.key[:60]] = device_ms(e) / e.count * launches
    if short:
        print(f"the profiler recorded {short} over {reps} calls: per-launch "
              "means", flush=True)
    return out


def device_total_ms(kernels: dict):
    return sum(kernels.values()) if kernels else "not measured"


def bound(flops: float, nbytes: float, dtype):
    """(ms, 'bytes' | 'operations'): the least time the card could take;
    ``dtype`` a key of PEAK_FLOPS."""
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

def stem_inputs(cfg: Config, dtype, seed=1, n=BATCH):
    """The stem's main-path shapes: the padded weight field (values in
    [0, 1], as claimed mask weights are) and the per-image taps."""
    mc = cfg.model
    h = mc.image_size[0]
    o = cfg.data.max_objs
    gen = torch.Generator().manual_seed(seed)
    w = torch.rand((n, h + 6, h + 6, o), generator=gen)
    g = 0.1 * torch.randn((n, 7, 7, o, mc.ngf), generator=gen)
    return w.to("cuda", dtype), g.to("cuda", dtype)


# The stem's rows: f32 and bf16 at the serving batch, keyed by dtype, and
# f32 at a val sweep's batch (the train CLI's), keyed (dtype, batch).
STEM_CASES = ((torch.float32, BATCH), (torch.float32, TRAIN_BATCH),
              (torch.bfloat16, BATCH))


def stem_key(dtype, n: int):
    return dtype if n == BATCH else (dtype, n)


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
    (the 3xTF32 kernel) and bf16 (the bf16 kernel), and in f32 at a val
    sweep's batch, each twice, bitwise equal, timed by CUDA events beside
    the plain version and the grouped-conv yardstick. The f32 rows' bound
    is their three TF32 products at the TF32 tensor-core rate;
    ``cuda_core_bound_ms`` keeps the bound of one f32 product on the CUDA
    cores (the kernel PR 10 replaced). Each row carries its kernel's
    launch (``launch``: registers a thread, dynamic shared memory, blocks
    an SM, grid, ...). Device times come last (``stem_device_times``)."""
    rows = {}
    for dtype, batch in STEM_CASES:
        w, g = stem_inputs(cfg, dtype, n=batch)
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
        moved = nbytes(w, g, got)
        extra = {}
        if dtype == torch.float32:
            b_ms, b_by = bound(TF32_SPLIT_PRODUCTS * flops, moved, "tf32")
            extra["cuda_core_bound_ms"] = bound(flops, moved, dtype)[0]
            extra["launch"] = f32_launch_config(n, hp - 6, wp - 6, o, c)
        else:
            b_ms, b_by = bound(flops, moved, dtype)
            extra["launch"] = tc_launch_config(n, hp - 6, wp - 6, o, c)
        check(extra["launch"]["local_bytes"] == 0,
              f"stem kernel {dtype} spills: {extra['launch']}")
        key = stem_key(dtype, batch)
        rows[key] = dict(batch=batch, max_abs_err=err, tol=tol, **extra,
                         ms=cuda_ms(lambda: stem(w, g)),
                         plain_ms=cuda_ms(lambda: stem_plain(w, g)),
                         library_ms=cuda_ms(library),
                         bound_ms=b_ms, bound_by=b_by)
        say("kernel stem", dtype=str(dtype), **rows[key])
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


def crop_case(cfg: Config, hh: int, dtype, seed=6, n=TRAIN_BATCH):
    """The crops' train shapes: ``n`` (12) images of 128x128x3 in [-1, 1],
    the synthetic batch's 9 boxes an image (slot 0 of image 0 made
    degenerate, slots 1 and 2 of image 1 partly out of frame) and a random
    gradient."""
    batch = synthetic_batch(cfg, seed=seed, batch_size=n)
    boxes = batch.boxes.copy()
    boxes[0, 0] = [0.4, 0.4, 0.4, 0.7]
    boxes[1, 1] = [-0.2, 0.5, 0.3, 1.3]
    boxes[1, 2] = [0.8, -0.3, 1.4, 0.4]
    boxes = torch.from_numpy(boxes).cuda()
    h, w = cfg.model.image_size
    gen = torch.Generator().manual_seed(seed)
    imgs = torch.rand((n, h, w, 3), generator=gen) * 2 - 1
    u = torch.randn((n, boxes.shape[1], hh, hh, 3), generator=gen)
    ry, rx = crop_matrices(boxes.to(dtype), hh, hh, h, w)
    return (imgs.to("cuda", dtype), ry.contiguous(), rx.contiguous(),
            u.to("cuda", dtype), boxes)


def grid_sample_inputs(imgs, boxes, u):
    """``F.grid_sample``'s form of the same crop (bilinear, zero padding,
    align_corners=True): each image repeated once per object, a grid per
    object in the images' dtype, the gradient channels-first."""
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
    # grid_sample takes a grid of its input's dtype: in bf16 the sample
    # positions round to bf16 too.
    return (inp, grid.reshape(n * o, hh, ww, 2).to(imgs.dtype).contiguous(),
            grad)


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
    and the library calls (``crop_library_calls``; in bf16 the forward's
    alone). Their device times come last (``crop_device_times``)."""
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
            calls = crop_library_calls(imgs, boxes, u)
            n, h, w, c = imgs.shape
            o, ww = ry.shape[1], rx.shape[2]
            lf = calls["crop_fwd"]().reshape(n, o, c, hh, ww).permute(
                0, 1, 3, 4, 2)
            if dtype == torch.bfloat16:
                # The forward's yardstick alone, on a bf16 grid (sample
                # positions rounded to bf16: not the same function to the
                # last bit, so timed without an agreement gate).
                lib_note = {"max_abs_err_fwd": float(
                    (lf.float() - want.float()).abs().max()), "grid": "bf16"}
                lib = {"crop_fwd": cuda_ms(calls["crop_fwd"])}
            else:
                lib = {}
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
    check_crop_wide(cfg, rows)
    return rows


ACC_CROP = 224       # the accuracy net's crops (sample_images, its trainer)
ACC_BATCH = 8        # sample_images' default batch


def check_crop_wide(cfg: Config, rows: dict) -> None:
    """The crop forward at the accuracy net's 224 px crops of 8 images (9
    boxes each, edge boxes as in ``crop_case``): hats (8, 9, 224, 128)
    that upsample every box, so each crop row's span is 1-2 image rows.
    f32 (as the accuracy path runs it: generated images are f32) and
    bf16, against the plain version; the bound (bytes); ``F.grid_sample``
    in both (bf16 on a bf16 grid). Forward only: nothing differentiates
    through these crops."""
    for dtype in (torch.float32, torch.bfloat16):
        imgs, ry, rx, u, boxes = crop_case(cfg, ACC_CROP, dtype, n=ACC_BATCH)
        got = crop_fwd(imgs, ry, rx)
        torch.cuda.synchronize()
        want = crop_fwd_plain(imgs, ry, rx)
        err = float((got.float() - want.float()).abs().max())
        rel = 1e-5 if dtype == torch.float32 else 2 ** -7
        tol = rel * float(want.float().abs().max())
        check(bool(torch.isfinite(got.float()).all()) and err <= tol,
              f"crop forward {dtype} HH={ACC_CROP}: max abs err {err} > "
              f"{tol}")
        check(torch.equal(got, crop_fwd(imgs, ry, rx)),
              f"crop forward {dtype} HH={ACC_CROP} is not bitwise "
              "repeatable")
        b = bound(*crop_work(imgs, ry, rx, u, (got,)), dtype)
        dense = bound(dense_crop_flops(imgs, ry, rx),
                      nbytes(imgs, ry, rx, got), dtype)
        lib = None
        call = crop_library_calls(imgs, boxes, u)["crop_fwd"]
        n, h, w, c = imgs.shape
        lf = call().reshape(n, -1, c, ACC_CROP, ACC_CROP).permute(
            0, 1, 3, 4, 2)
        lib_err = float((lf.float() - want.float()).abs().max())
        if dtype == torch.float32:
            agree = lib_err <= 1e-4 * float(want.abs().max())
            lib_note = {"max_abs_err_fwd": lib_err, "agrees": agree}
            if agree:
                lib = cuda_ms(call)
        else:                  # a bf16 grid: timed without a gate
            lib_note = {"max_abs_err_fwd": lib_err, "grid": "bf16"}
            lib = cuda_ms(call)
        rows[("crop_fwd", ACC_CROP, dtype)] = dict(
            max_abs_err=err, tol=tol,
            ms=cuda_ms(lambda: crop_fwd(imgs, ry, rx)),
            plain_ms=cuda_ms(lambda: crop_fwd_plain(imgs, ry, rx)),
            library_ms=lib, bound_ms=b[0], bound_by=b[1],
            dense_bound_ms=dense[0], dense_bound_by=dense[1])
        say("kernel crop_fwd", hh=ACC_CROP, dtype=str(dtype), n=ACC_BATCH,
            library=lib_note, **rows[("crop_fwd", ACC_CROP, dtype)])


def stem_device_times(cfg: Config, rows: dict) -> None:
    """Each stem row's device time per call and its grouped-conv
    yardstick's (the profiler's own kernel times), added to ``rows``; run
    at the start of a process (``fresh_device_times``)."""
    for dtype, batch in STEM_CASES:
        w, g = stem_inputs(cfg, dtype, n=batch)
        dev = device_kernels_ms(lambda: stem(w, g))
        lib = device_kernels_ms(stem_library_call(w, g))
        row = rows[stem_key(dtype, batch)]
        row.update(device_ms=device_total_ms(dev), device_kernels=dev,
                   library_device_ms=device_total_ms(lib),
                   library_device_kernels=lib)
        say("kernel stem device", dtype=str(dtype), batch=batch,
            device_ms=row["device_ms"],
            device_kernels=dev, library_device_ms=row["library_device_ms"],
            library_device_kernels=lib, bound_ms=row["bound_ms"],
            clocks_sm=sm_clock(), **({"launch": row["launch"]}
                                     if "launch" in row else {}))


def crop_device_times(cfg: Config, rows: dict) -> None:
    """Each crop row's device time per call and its library call's (the
    profiler's own kernel times), added to ``rows``; run at the start of a
    process (``fresh_device_times``)."""
    for hh in (64, 32):
        for dtype in (torch.float32, torch.bfloat16):
            imgs, ry, rx, u, boxes = crop_case(cfg, hh, dtype)
            calls = {"crop_fwd": lambda: crop_fwd(imgs, ry, rx)}
            for name, nd, _ in CROP_BWD_ROWS:
                calls[name] = lambda nd=nd: crop_bwd(imgs, ry, rx, u, nd)
            libs = crop_library_calls(imgs, boxes, u)
            for name, fn in calls.items():
                dev = device_kernels_ms(fn)
                row = rows[(name, hh, dtype)]
                row.update(device_ms=device_total_ms(dev), device_kernels=dev,
                           library_device_ms=device_total_ms(
                               device_kernels_ms(libs[name]))
                           if row["library_ms"] is not None else None)
                say(f"kernel {name} device", hh=hh, dtype=str(dtype),
                    device_ms=row["device_ms"], device_kernels=dev,
                    library_device_ms=row["library_device_ms"],
                    bound_ms=row["bound_ms"], clocks_sm=sm_clock())
    for dtype in (torch.float32, torch.bfloat16):
        imgs, ry, rx, u, boxes = crop_case(cfg, ACC_CROP, dtype, n=ACC_BATCH)
        row = rows[("crop_fwd", ACC_CROP, dtype)]
        dev = device_kernels_ms(lambda: crop_fwd(imgs, ry, rx))
        lib = (device_kernels_ms(crop_library_calls(imgs, boxes, u)[
            "crop_fwd"]) if row["library_ms"] is not None else None)
        row.update(device_ms=device_total_ms(dev), device_kernels=dev,
                   library_device_ms=None if lib is None
                   else device_total_ms(lib))
        say("kernel crop_fwd device", hh=ACC_CROP, dtype=str(dtype),
            device_ms=row["device_ms"], device_kernels=dev,
            library_device_ms=row["library_device_ms"],
            bound_ms=row["bound_ms"], clocks_sm=sm_clock())


def crop_per_rank_times(cfg: Config, rows: dict) -> None:
    """The crop forward and the train path's backward (d_img) at the shape
    a data-parallel rank gives them (6 of the 12 images: 2 ranks), f32, at
    64 and 32 px: against the plain versions, timed by CUDA events (kernel,
    plain, ``grid_sample``) and by the profiler, with their bound. Rows
    ``crop_fwd_per_rank`` / ``crop_bwd_per_rank`` in ``rows``; run at the
    start of a process (``--only crop``)."""
    n, dtype = TRAIN_BATCH // DDP_RANKS, torch.float32
    for hh in (64, 32):
        imgs, ry, rx, u, boxes = crop_case(cfg, hh, dtype, n=n)
        libs = crop_library_calls(imgs, boxes, u)
        out = crop_fwd(imgs, ry, rx)
        d_img = crop_bwd(imgs, ry, rx, u, D_IMG_ONLY)[0]
        torch.cuda.synchronize()
        cases = {
            "crop_fwd_per_rank": (lambda: crop_fwd(imgs, ry, rx),
                                  lambda: crop_fwd_plain(imgs, ry, rx),
                                  libs["crop_fwd"], out,
                                  crop_fwd_plain(imgs, ry, rx), None),
            "crop_bwd_per_rank": (
                lambda: crop_bwd(imgs, ry, rx, u, D_IMG_ONLY),
                lambda: crop_bwd_plain(imgs, ry, rx, u, D_IMG_ONLY),
                libs["crop_bwd"], d_img, crop_bwd_plain(imgs, ry, rx, u)[0],
                D_IMG_ONLY)}
        for name, (fn, plain, lib, got, want, needs) in cases.items():
            err = float((got - want).abs().max())
            check(err <= 1e-5 * float(want.abs().max()),
                  f"{name} HH={hh}: max abs err {err}")
            b = bound(*crop_work(imgs, ry, rx, u, (got,), needs), dtype)
            dev = device_kernels_ms(fn)
            rows[(name, hh, dtype)] = row = dict(
                batch=n, max_abs_err=err, ms=cuda_ms(fn),
                plain_ms=cuda_ms(plain), library_ms=cuda_ms(lib),
                bound_ms=b[0], bound_by=b[1],
                device_ms=device_total_ms(dev), device_kernels=dev,
                library_device_ms=device_total_ms(device_kernels_ms(lib)))
            say(f"kernel {name} device", hh=hh, dtype=str(dtype),
                clocks_sm=sm_clock(), **row)


def compositor_device_times(cfg: Config, rows: dict) -> None:
    """The compositor's device time per call at the serving shape (the
    profiler's own kernel times), added to ``rows``; run at the start of a
    process (``fresh_device_times``)."""
    case = compositor_case(cfg)
    for dtype in (torch.float32, torch.bfloat16):
        inputs = to_compositor(cfg, case, dtype)
        dev = device_kernels_ms(lambda: composite(*inputs))
        row = rows[dtype]
        row.update(device_ms=device_total_ms(dev), device_kernels=dev)
        say("kernel compositor device", dtype=str(dtype),
            device_ms=row["device_ms"], device_kernels=dev,
            bound_ms=row["bound_ms"], clocks_sm=sm_clock())


def fresh_device_times(stem_rows: dict, comp_rows: dict,
                       crop_rows: dict) -> None:
    """Every kernel row's device times, each kernel's taken by
    ``--only <kernel>`` in a process of its own and added to its rows.
    torch.profiler records fewer of a kernel's launches the longer a
    process has run (all of them at its start, 6 of 10 after this
    script's end-to-end phases), and profiler sessions slow the host's
    launches after them (the serving rate read 910-940 img/s against
    1164-1193 without, at the same device busy time), so neither belongs
    in this process. Each line the child prints is printed here too."""
    for name in ("stem", "compositor", "crop"):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--only", name],
            capture_output=True, text=True, timeout=600)
        check(proc.returncode == 0, f"--only {name} failed:\n"
              f"{proc.stdout[-2000:]}{proc.stderr[-2000:]}")
        for line in proc.stdout.splitlines():
            if not (line.startswith("[kernel ") and " device] " in line):
                continue
            print(line, flush=True)
            tag, payload = line.split("] ", 1)
            kernel, rec = tag.split()[1], json.loads(payload)
            dtype = getattr(torch, rec["dtype"].split(".")[1])
            if kernel == "stem":
                row = stem_rows[stem_key(dtype, rec["batch"])]
            elif kernel == "compositor":
                row = comp_rows[dtype]
            elif kernel.endswith("_per_rank"):   # measured in the child
                row = crop_rows.setdefault((kernel, rec["hh"], dtype), rec)
            else:
                row = crop_rows[(kernel, rec["hh"], dtype)]
            row.update({k: rec[k] for k in ("device_ms", "device_kernels",
                                            "library_device_ms")
                        if k in rec})


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


# --- phases 4-6: the model --------------------------------------------------

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
    """A base64 PNG of the server's response as (H, W, 3) uint8."""
    raw = base64.b64decode(b64)
    check(raw[:8] == b"\x89PNG\r\n\x1a\n", "response image is not a PNG")
    return decode_png(raw)


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


# --- phases 8-9: training ---------------------------------------------------

def train_on_card() -> dict:
    """Phase 8: the default ``Config()`` (generator f32, discriminators
    and VGG bf16; PyTorch's default TF32 flags, as the train CLI runs) at
    batch 12 through ``train_step``: TRAIN_STEPS steps, every loss
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
    logged = []
    for i in range(TRAIN_STEPS):
        metrics = train_step(state, synthetic_batch(
            state.cfg, seed=SEED + i, batch_size=TRAIN_BATCH))
        on_step(i, metrics)
        vals = {k: float(v) for k, v in metrics.items()
                if not k.startswith("_")}
        check(all(np.isfinite(v) for v in vals.values()),
              f"step {i + 1}: non-finite loss terms {vals}")
        logged.append(vals)
    torch.cuda.synchronize()
    launches = dict(_cuda.LAUNCHES)
    del before
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


# The CLI's synthetic val set is max(8, size // 8) images in whole
# batches, as in the JAX CLI: 96 images give a val batch of 12 (fewer give
# none, and the sweeps would run nothing) and 8 train batches an epoch, so
# t=9 opens epoch 2 and the resume continues it mid-epoch.
CLI_STEPS = 9
CLI_EVERY = 3
CLI_SYNTHETIC = 96


def _cli_main(argv, on_step=None):
    """``train.main(argv)`` in this process (so that ``_cuda.LAUNCHES``
    counts its launches), its printed lines captured and returned."""
    import io
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            state, meta = train_cli.main(argv, on_step=on_step)
    except BaseException:
        print(out.getvalue()[-4000:], flush=True)
        raise
    return state, meta, out.getvalue()


@contextlib.contextmanager
def checkpoint_timers():
    """Time each ``CheckpointManager.save`` call (the loop's hold: the
    call, then the device finishing the snapshot it queued), each
    snapshot's device-to-host copy and each file write (both on the
    background thread)."""
    times = {"hold_s": [], "hold_synced_s": [], "to_host_s": [],
             "write_s": []}
    cls = ckpt_mod.CheckpointManager
    orig = (cls.save, ckpt_mod._to_host, ckpt_mod._write_state)

    def timed(key, fn):
        def wrapper(*a, **kw):
            t = time.perf_counter()
            out = fn(*a, **kw)
            times[key].append(time.perf_counter() - t)
            return out
        return wrapper

    def save(self, state, best=False):
        t = time.perf_counter()
        orig[0](self, state, best)
        times["hold_s"].append(time.perf_counter() - t)
        torch.cuda.synchronize()
        times["hold_synced_s"].append(time.perf_counter() - t)

    cls.save = save
    ckpt_mod._to_host = timed("to_host_s", orig[1])
    ckpt_mod._write_state = timed("write_s", orig[2])
    try:
        yield times
    finally:
        cls.save, ckpt_mod._to_host, ckpt_mod._write_state = orig


def train_cli_phase(step_ms: float, tmp: str) -> dict:
    """Phase 10 (last): the port's train CLI as a user runs it
    (``train.main([...])``) at the full default ``Config()``, batch 12:
    CLI_STEPS steps over a CLI_SYNTHETIC-image synthetic set (an epoch
    boundary inside), a checkpoint every CLI_EVERY with the val-gt and
    val-sg sweeps and best promotion, loss lines every step. Then a
    resume for 2 more steps (every restored tensor bitwise the saved one,
    the first batch the straight stream's next one), a 2-step
    ``--preset quality`` run (bf16 Adam mu) and
    ``InferenceModel.from_checkpoint(best=True)`` serving its best state
    at b16 in bf16. The runs write under ``tmp``; the last one's
    ``best/`` stays there for the eval phase."""
    free_gib = shutil.disk_usage(tmp).free / 2 ** 30
    common = ["--synthetic", "--synthetic_size", str(CLI_SYNTHETIC),
              "--batch_size", str(TRAIN_BATCH), "--print_every", "1",
              "--num_val_samples", "24", "--timing", "--output_dir", tmp,
              "--seed", str(SEED)]
    losses_finite = []

    def on_step(t, batch, metrics):
        losses_finite.append(all(bool(torch.isfinite(v).all())
                                  for k, v in metrics.items()
                                  if not k.startswith("_")))

    # 1. The straight run: checkpoints at t=3, 6 and 9.
    _cuda.LAUNCHES.clear()
    with checkpoint_timers() as times:
        state, meta, log = _cli_main(
            common + ["--num_iterations", str(CLI_STEPS),
                      "--checkpoint_every", str(CLI_EVERY)], on_step)
    launches = dict(_cuda.LAUNCHES)
    check(len(losses_finite) == CLI_STEPS and all(losses_finite),
          f"train CLI losses not finite at every step: {losses_finite}")
    root = os.path.join(tmp, "checkpoint")
    with open(os.path.join(root, "meta.json")) as f:
        disk = json.load(f)
    # The JAX CLI's count: steps 1-8 are epoch 1, step 9 epoch 2.
    per_epoch = CLI_SYNTHETIC // TRAIN_BATCH
    check(disk["counters"]["t"] == CLI_STEPS
          and disk["counters"]["epoch"] == (CLI_STEPS - 1) // per_epoch
          + 1, f"meta counters {disk['counters']}")
    ts = list(range(CLI_EVERY, CLI_STEPS + 1, CLI_EVERY))
    check(disk["checkpoint_ts"] == ts,
          f"checkpoint_ts {disk['checkpoint_ts']}")
    check(len(disk["best_t"]) > 0, "no best promotion")
    ious = {k: disk[k] for k in ("val_gt_iou", "val_sg_iou")}
    check(all(len(v) == len(ts) and all(np.isfinite(v))
              for v in ious.values()), f"val IoUs {ious}")
    for d in ("last", "best"):
        check(os.path.exists(os.path.join(root, d, "state.pt")),
              f"no {d}/state.pt")
    check(launches.get("crop_fwd", 0) >= 4 * CLI_STEPS
          and launches.get("crop_bwd", 0) >= CLI_STEPS,
          f"crop kernels not launched on every step: {launches}")
    f32_stem = launches.get("stem_f32", 0)
    check(f32_stem > 0 and f32_stem == launches.get("stem", 0),
          f"the val sweeps ran no f32 stem, or another one: {launches}")
    check(launches.get("crop_bwd_boxes", 0) == 0,
          f"the train CLI launched the d_ry / d_rx kernels: {launches}")
    timing = [float(ln.split()[1]) for ln in log.splitlines()
              if ln.strip().startswith("[timing]")]
    gib = os.path.getsize(os.path.join(root, "last", "state.pt")) / 2 ** 30
    saved = ckpt_mod.tree_map(lambda t: t.detach().cpu().clone(),
                              state.state_dict())
    del state
    torch.cuda.empty_cache()

    # 2. The resume: t=9 restored bitwise, then t=10 and t=11.
    restored, first = [], {}
    orig_restore = ckpt_mod.CheckpointManager.restore

    def restore(self, template, best=False):
        out = orig_restore(self, template, best)
        restored.append(ckpt_mod.tree_map(
            lambda t: t.detach().cpu().clone(), out.state_dict()))
        return out

    def first_batch(t, batch, metrics):
        first.setdefault(t, [torch.as_tensor(a).cpu().numpy()
                             for a in batch])

    ckpt_mod.CheckpointManager.restore = restore
    try:
        state, meta2, log2 = _cli_main(
            common + ["--num_iterations", str(CLI_STEPS + 2),
                      "--checkpoint_every", str(CLI_EVERY),
                      "--restore_from_checkpoint", "1"], first_batch)
    finally:
        ckpt_mod.CheckpointManager.restore = orig_restore
    check(f"restored checkpoint at t={CLI_STEPS}" in log2,
          f"the resume did not report t={CLI_STEPS}")
    check(meta2["counters"]["t"] == CLI_STEPS + 2,
          f"resumed counters {meta2['counters']}")
    leaves = list(ckpt_mod.tree_leaves(saved))
    got = list(ckpt_mod.tree_leaves(restored[0]))
    check([p for p, _ in leaves] == [p for p, _ in got],
          "restored state has other leaves than the saved one")
    differ = [p for (p, a), (_, b) in zip(leaves, got)
              if not (torch.equal(a, b) and a.dtype == b.dtype
                      if isinstance(a, torch.Tensor) else a == b)]
    check(not differ, f"restored leaves differ from the saved: "
          f"{differ[:5]}")
    # The straight stream's next batch (t=10: epoch 2, its second).
    cfg = train_cli.config_from_args(train_cli.parse_args(common))
    loader = DataLoader(SyntheticDataset(cfg, CLI_SYNTHETIC, SEED),
                        TRAIN_BATCH, cfg.data.max_objs,
                        cfg.data.max_triples, shuffle=True, seed=SEED)
    loader.set_epoch(CLI_STEPS // per_epoch + 1)
    want = list(loader)[CLI_STEPS % per_epoch]
    check(CLI_STEPS + 1 in first and all(
        np.array_equal(a, b) for a, b in zip(first[CLI_STEPS + 1], want)),
        f"the resumed run's first batch is not the straight run's "
        f"t={CLI_STEPS + 1}")
    del state, saved, restored
    torch.cuda.empty_cache()

    # 3. --preset quality: bf16 Adam mu, finite losses; its best/
    # (bf16 config) served at b16.
    losses_finite.clear()
    state, meta3, _ = _cli_main(
        common + ["--preset", "quality", "--num_iterations", "2",
                  "--checkpoint_every", "2"], on_step)
    mu_dtypes = {name: sorted({str(m.dtype) for m in
                               opt.state_dict()["mu"]})
                 for name, _, opt in state.trees()}
    check(all(v == ["torch.bfloat16"] for v in mu_dtypes.values()),
          f"--preset quality mu dtypes {mu_dtypes}")
    check(len(losses_finite) == 2 and all(losses_finite),
          f"--preset quality losses not finite: {losses_finite}")
    del state
    torch.cuda.empty_cache()
    served = InferenceModel.from_checkpoint(tmp, best=True,
                                            device="cuda")
    batch = synthetic_batch(served.cfg, seed=4, batch_size=BATCH)
    n, o = batch.objs.shape
    _cuda.LAUNCHES.clear()
    out = served.forward_batch(
        batch, features=np.zeros((n, o, served.cfg.model.rep_size),
                                 np.float32),
        features_mask=np.zeros((n, o), np.float32))
    torch.cuda.synchronize()
    serve_launches = dict(_cuda.LAUNCHES)
    check(tuple(out.imgs_pred.shape) == (BATCH, 128, 128, 3)
          and bool(torch.isfinite(out.imgs_pred).all()),
          "serving best/ gave no finite b16 images")
    check(serve_launches.get("stem_tc", 0) > 0,
          f"serving best/ ran no tensor-core stem: {serve_launches}")
    del served, out
    result = dict(
        steps=CLI_STEPS, launches=launches, f32_stem_launches=f32_stem,
        checkpoint_gib=gib, free_disk_gib_before=free_gib,
        save_hold_s=times["hold_s"], save_hold_synced_s=times["hold_synced_s"],
        to_host_s=times["to_host_s"], write_s=times["write_s"],
        timing_ms_per_step=timing, phase8_ms_per_step=step_ms,
        counters=disk["counters"], best_t=disk["best_t"], val_iou=ious,
        resumed_leaves=len(leaves), quality_mu=mu_dtypes,
        serve_best_launches=serve_launches)
    say("train CLI", **result)
    return result


EVAL_ENCODE = 96      # encode_features: images, at batch ACC_BATCH
EVAL_ACC_SYNTHETIC = 24  # train_accuracy_net: 3 steps at batch ACC_BATCH
EVAL_SAMPLES = 16     # sample_images
EVAL_PAIRS = 8        # compute_diversity


def _stage(name: str, stages: dict, predicted: dict, fn,
           phase: str = "eval"):
    """Run one stage of ``phase`` with the launch counts set to 0 just
    before it; record its wall seconds and launches beside the predicted
    counts, and fail if they differ."""
    _cuda.LAUNCHES.clear()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    launches = {k: v for k, v in _cuda.LAUNCHES.items() if v}
    stages[name] = dict(seconds=time.perf_counter() - t, launches=launches,
                        predicted=predicted)
    say(f"{phase} {name}", **stages[name])
    check(launches == predicted, f"{phase} {name}: launches {launches}, "
          f"predicted {predicted}")
    return out


def _encode_on(device: str, run_dir: str):
    """encode_features' ``encode`` of the EVAL_ENCODE images with the
    model in f32 on ``device``."""
    model = InferenceModel.from_checkpoint(run_dir, device=device)
    model.model.float()
    loader = DataLoader(SyntheticDataset(model.cfg, EVAL_ENCODE, SEED),
                        ACC_BATCH, model.cfg.data.max_objs,
                        model.cfg.data.max_triples, shuffle=False,
                        drop_last=False)
    return encode_features.encode(model, loader)


def eval_phase(train_dir: str) -> dict:
    """Phase 11 (last): the inference and evaluation tools, in-process on
    the card, on the ``best/`` of the train CLI phase's ``--preset
    quality`` run (the full default Config() in bf16), its mask head
    rescaled as for serving (``spread_mask_head``: two steps from a seeded
    init leave bf16 masks at 0.5):
    encode_features over EVAL_ENCODE synthetic images at batch 8 with the
    clustering on the card, its f32 encoding held against the CPU's;
    train_accuracy_net, 3 steps of ResNet101 at 224 px; sample_images with
    the k=1 table and the accuracy net; compute_fid over its gt and pred
    PNGs (read back by ``decode_png``); compute_diversity over EVAL_PAIRS
    pairs; the GUI server's ``GET /`` and one ``GET /get_data`` scene.
    Each stage's launches are held to the counts the code predicts."""
    work = tempfile.mkdtemp(prefix="sg_eval_")
    try:
        run = os.path.join(work, "run")
        cfg, vocab, model = load_checkpoint(train_dir, "cuda", best=True)
        spread = spread_mask_head(model)
        save_checkpoint(run, model, cfg, vocab)
        del model
        torch.cuda.empty_cache()
        stages = {}
        batches = -(-EVAL_ENCODE // ACC_BATCH)
        feats = _stage("encode_features", stages, {"crop_fwd": batches},
                       lambda: encode_features.main([
                           "--output_dir", run, "--synthetic",
                           "--num_samples", str(EVAL_ENCODE),
                           "--batch_size", str(ACC_BATCH),
                           "--save_dir", work]))
        # The f32 encoding on the card against the CPU's, within 1e-3 of
        # each class's scale; the bf16 run's distance from it is printed.
        card, cpu = _encode_on("cuda", run), _encode_on("cpu", run)
        check(sorted(card) == sorted(cpu) == sorted(feats),
              "encode_features: classes differ between card and CPU")
        f32_err = max(float(np.abs(card[c] - cpu[c]).max())
                      / max(float(np.abs(cpu[c]).max()), 1e-12) for c in cpu)
        bf16_err = max(float(np.abs(feats[c] - cpu[c]).max())
                       / max(float(np.abs(cpu[c]).max()), 1e-12) for c in cpu)
        tables = {k: np.load(os.path.join(work, f"features_clustered_{k}"
                                          ".npy"), allow_pickle=True).item()
                  for k in ("100", "010", "001")}
        # The k=1 centres (k-means on the card) against the numpy means of
        # the features they clustered.
        mean_err = max(float(np.abs(tables["001"][c][0] - feats[c].mean(0))
                             .max()) / max(float(np.abs(feats[c]).max()),
                                           1e-12) for c in feats)
        say("eval encode_features check", classes=len(cpu),
            objects=sum(len(v) for v in cpu.values()), f32_rel_err=f32_err,
            bf16_rel_err=bf16_err, k1_mean_rel_err=mean_err,
            mask_logit_spread_before=spread,
            k100_centres=sum(len(v) for v in tables["100"].values()))
        check(f32_err <= 1e-3, f"encode_features f32 card vs CPU: {f32_err} "
              "of a class's scale > 1e-3")
        check(mean_err <= 1e-5, f"the k=1 table is {mean_err} of a class's "
              "scale from the class means")

        acc = os.path.join(work, "accuracy_net.pt")
        _stage("train_accuracy_net", stages,
               {"crop_fwd": EVAL_ACC_SYNTHETIC // ACC_BATCH},
               lambda: train_accuracy_net.main([
                   "--synthetic", "--synthetic_size", str(EVAL_ACC_SYNTHETIC),
                   "--batch_size", str(ACC_BATCH), "--save_path", acc]))
        samples = os.path.join(work, "samples")
        n_batches = EVAL_SAMPLES // ACC_BATCH
        results = _stage(
            "sample_images", stages,
            {"stem": n_batches, "stem_tc": n_batches, "crop_fwd": n_batches},
            lambda: sample_images.main([
                "--output_dir", run, "--features_path",
                os.path.join(work, "features_clustered_001.npy"),
                "--synthetic", "--num_samples", str(EVAL_SAMPLES),
                "--batch_size", str(ACC_BATCH), "--accuracy_model_path", acc,
                "--save_dir", samples]))
        check(results["num_images"] == EVAL_SAMPLES
              and all(np.isfinite(list(results.values()))),
              f"sample_images results {results}")
        dirs = {}
        for kind in ("gt", "pred"):
            dirs[kind] = os.path.join(work, f"fid_{kind}")
            os.makedirs(dirs[kind])
            for f in sorted(os.listdir(samples)):
                if f.endswith(f"_{kind}.png"):
                    shutil.copy(os.path.join(samples, f), dirs[kind])
        fid = _stage("compute_fid", stages, {}, lambda: compute_fid.main([
            "--real_dir", dirs["gt"], "--fake_dir", dirs["pred"]]))
        check(fid["n_real"] == fid["n_fake"] == EVAL_SAMPLES
              and np.isfinite(fid["fid"]), f"compute_fid {fid}")
        div = _stage("compute_diversity", stages,
                     {"stem": 2 * (EVAL_PAIRS // ACC_BATCH),
                      "stem_tc": 2 * (EVAL_PAIRS // ACC_BATCH)},
                     lambda: compute_diversity.main([
                         "--output_dir", run, "--features_path",
                         os.path.join(work, "features_clustered_100.npy"),
                         "--synthetic", "--num_samples", str(EVAL_PAIRS),
                         "--batch_size", str(ACC_BATCH)]))
        check(div["n"] == EVAL_PAIRS and np.isfinite(
            div["diversity_lpips_mean"]), f"compute_diversity {div}")
        gui = _stage("gui_server", stages, {"stem": 1, "stem_tc": 1},
                     lambda: gui_request(run, work))
        say("eval", results=results, fid=fid, diversity=div, gui=gui)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return stages


def gui_request(run: str, work: str) -> dict:
    """The GUI server over HTTP: ``GET /`` is the repo's index.html; one
    ``GET /get_data`` scene (batch 1, bf16: the tensor-core stem) gives a
    PNG that decodes to a non-constant image of the model's size."""
    backend = gui_server.GuiBackend(
        run, features_path=os.path.join(work, "features_clustered_100.npy"),
        images_dir=os.path.join(work, "gui"), device="cuda")
    httpd = HTTPServer(("127.0.0.1", 0), gui_server.make_handler(backend))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        index = urllib.request.urlopen(base + "/", timeout=60).read()
        with open(os.path.join(gui_server.GUI_DIR, "index.html"), "rb") as f:
            check(index == f.read(), "GET / is not scripts/gui/index.html")
        names = backend.model.vocab["object_idx_to_name"]
        scene = {"image_id": 1, "objects": [
            {"text": names[4], "left": 0.1, "top": 0.2, "width": 0.4,
             "height": 0.5, "size": 5, "location": 7, "feature": 0},
            {"text": names[2], "left": 0.5, "top": 0.4, "width": 0.45,
             "height": 0.5, "size": 6, "location": 18, "feature": -1},
            {"text": names[5], "left": 0.0, "top": 0.0, "width": 1.0,
             "height": 0.4, "size": 9, "location": 2, "feature": -1}]}
        resp = json.loads(urllib.request.urlopen(
            base + "/get_data?data=" + urllib.parse.quote(json.dumps(scene)),
            timeout=300).read())
        img = decode_png(urllib.request.urlopen(
            base + "/" + resp["img_pred"], timeout=60).read())
        layout = decode_png(urllib.request.urlopen(
            base + "/" + resp["img_layout"], timeout=60).read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    check(not thread.is_alive(), "the GUI server did not stop")
    h, w = backend.model.cfg.model.image_size
    check(img.shape == (h, w, 3) and int(img.max()) > int(img.min()),
          f"GUI image of {img.shape}: constant or not {h}x{w}")
    return dict(img_std=float(img.std()), layout=list(layout.shape),
                paths=resp)


# --- the COCO readers on the card machine (no PIL) --------------------------

COCO_TRAIN, COCO_VAL = 96, 24      # fake COCO images, 480x360 PNG
COCO_STEPS, COCO_PAN_STEPS = 3, 2
COCO_ENCODE = 96                   # encode_features: images, batch ACC_BATCH
COCO_HOST_IMAGES = 24              # images timed on the host


def coco_host_times(root: str) -> dict:
    """The host's milliseconds an example, over COCO_HOST_IMAGES train
    images: reading the file, ``decode_png``, the bilinear resize to the
    model's 128 px, the mask codec (every instance and stuff segmentation
    of the image) and a whole ``get_example`` of each family."""
    from scene_generation_tpu_torch.data import image_utils, rle
    ann = os.path.join(root, "annotations")
    with open(os.path.join(ann, "instances_train2017.json")) as f:
        inst = json.load(f)
    with open(os.path.join(ann, "stuff_train2017.json")) as f:
        segs = inst["annotations"] + json.load(f)["annotations"]
    images = inst["images"][:COCO_HOST_IMAGES]
    ms = {k: 0.0 for k in ("read", "decode", "resize", "rle")}
    for im in images:
        t = time.perf_counter()
        with open(os.path.join(root, "images/train2017",
                               im["file_name"]), "rb") as f:
            data = f.read()
        t1 = time.perf_counter()
        img = image_utils.to_rgb(image_utils.decode_png(data))
        t2 = time.perf_counter()
        image_utils.resize(img, (128, 128), "bilinear")
        t3 = time.perf_counter()
        for a in segs:
            if a["image_id"] == im["id"]:
                rle.seg_to_mask(a["segmentation"], im["width"], im["height"])
        t4 = time.perf_counter()
        for k, dt in zip(ms, (t1 - t, t2 - t1, t3 - t2, t4 - t3)):
            ms[k] += dt * 1e3 / len(images)
    cfg = Config()
    for panoptic in (False, True):
        train, _ = train_cli.coco_datasets(cfg, root, panoptic)
        t = time.perf_counter()
        for i in range(COCO_HOST_IMAGES):
            train.get_example(i, 1)
        ms["get_example_" + ("panoptic" if panoptic else "instances")] = (
            (time.perf_counter() - t) * 1e3 / COCO_HOST_IMAGES)
    return ms


def coco_phase(work: str) -> dict:
    """The COCO readers without PIL, on the card machine: a fake COCO
    directory written as 480x360 PNG (``tools.make_fake_coco_dir``),
    examples of both families read and checked, the native mask codec held
    against its numpy version on every segmentation, the host's times an
    example; then ``train.main --coco_dir`` at the full default
    ``Config()`` (batch 12, process workers, one checkpoint with its val
    sweeps), ``--is_panoptic 1`` and ``encode_features --coco_dir`` on the
    checkpoint, each stage's launches held to the counts the code
    predicts."""
    from scene_generation_tpu_torch.data import rle
    from scene_generation_tpu_torch.tools import make_fake_coco_dir
    root = os.path.join(work, "coco")
    stages = {}
    t = time.perf_counter()
    make_fake_coco_dir.main(["--root", root, "--num_train", str(COCO_TRAIN),
                             "--num_val", str(COCO_VAL), "--size", "480,360",
                             "--image_format", "png"])
    stages["make_fake_coco_dir"] = dict(seconds=time.perf_counter() - t)

    t = time.perf_counter()
    cfg = Config()
    read = {}
    for panoptic in (False, True):
        train, val = train_cli.coco_datasets(cfg, root, panoptic)
        family = "panoptic" if panoptic else "instances"
        # Every fake image holds 3-4 instance + stuff objects; panoptic
        # ones 2-3 segments, of which the filters keep those with 3.
        check((len(train), len(val)) == (COCO_TRAIN, COCO_VAL) if not
              panoptic else len(train) >= COCO_PAN_STEPS * TRAIN_BATCH,
              f"{family}: {len(train)} train / {len(val)} val images pass "
              f"the filters")
        for i in range(4):
            ex = train.get_example(i, 0)
            o = len(ex.objs)
            check(ex.image.shape == (128, 128, 3) and ex.image.dtype ==
                  np.uint8 and int(ex.image.max()) > int(ex.image.min()),
                  f"{family} example {i}: image {ex.image.shape}")
            check(ex.masks.shape == (o, 32, 32) and set(np.unique(
                ex.masks)) <= {0.0, 1.0} and ex.masks[:-1].any(),
                f"{family} example {i}: masks")
            check(ex.objs[-1] == 0 and np.isfinite(ex.boxes).all(),
                  f"{family} example {i}: objects")
        read[family] = dict(classes=train.num_classes, train=len(train),
                            val=len(val))
    with open(os.path.join(root, "annotations",
                           "instances_train2017.json")) as f:
        inst = json.load(f)
    sizes = {im["id"]: (im["width"], im["height"]) for im in inst["images"]}
    kinds = collections.Counter()
    for a in inst["annotations"]:
        seg = a["segmentation"]
        w, h = sizes[a["image_id"]]
        got = rle.seg_to_mask(seg, w, h)
        check(np.array_equal(got, rle.seg_to_mask_py(seg, w, h))
              and got.any(), f"mask codec differs on annotation {a['id']}")
        kinds[type(seg).__name__ + (type(seg["counts"]).__name__
                                    if isinstance(seg, dict) else "")] += 1
    check(len(kinds) == 3, f"segmentation kinds {dict(kinds)}")
    check("PIL" not in sys.modules, "the COCO readers imported PIL")
    stages["read"] = dict(seconds=time.perf_counter() - t, families=read,
                          rle_checked=dict(kinds))
    host_ms = coco_host_times(root)
    say("coco read", host_ms_per_example=host_ms, **stages["read"])

    run = os.path.join(work, "run")
    common = ["--coco_dir", root, "--batch_size", str(TRAIN_BATCH),
              "--print_every", "1", "--num_val_samples", str(COCO_VAL),
              "--timing", "--seed", str(SEED)]
    # A step crops 4 times (the encoder, D_obj in G's loss, D_obj's fake
    # and real passes) and differentiates one of them; a checkpoint's two
    # val sweeps run the f32 stem and the encoder's crop once a batch.
    val_batches = 2 * (COCO_VAL // TRAIN_BATCH)
    runs = {"train": (COCO_STEPS, [
                "--checkpoint_every", str(COCO_STEPS), "--output_dir", run],
                {"crop_fwd": 4 * COCO_STEPS + val_batches,
                 "crop_bwd": COCO_STEPS, "stem": val_batches,
                 "stem_f32": val_batches}),
            "train panoptic": (COCO_PAN_STEPS, [
                "--is_panoptic", "1", "--output_dir",
                os.path.join(work, "run_panoptic")],
                {"crop_fwd": 4 * COCO_PAN_STEPS,
                 "crop_bwd": COCO_PAN_STEPS})}
    for name, (steps, argv, predicted) in runs.items():
        with torch_default_tf32():
            _, meta, log = _stage(name, stages, predicted, lambda: (
                _cli_main(common + argv + ["--num_iterations", str(steps)])),
                "coco")
        stages[name]["timing_ms_per_step"] = [
            float(ln.split()[1]) for ln in log.splitlines()
            if ln.strip().startswith("[timing]")]
        check(meta["counters"]["t"] == steps and all(
            np.isfinite(v).all() for v in meta["losses"].values()),
            f"coco {name}: counters {meta['counters']} or losses")
        check(meta["vocab"]["is_panoptic"] == (name == "train panoptic"),
              f"coco {name}: vocab is_panoptic")
        torch.cuda.empty_cache()
    feats = _stage(
        "encode_features", stages,
        {"crop_fwd": -(-COCO_ENCODE // ACC_BATCH)},
        lambda: encode_features.main([
            "--output_dir", run, "--coco_dir", root, "--num_samples",
            str(COCO_ENCODE), "--batch_size", str(ACC_BATCH), "--save_dir",
            os.path.join(work, "features")]), "coco")
    check(len(feats) >= 2 and all(np.isfinite(v).all()
                                  for v in feats.values()),
          f"encode_features --coco_dir: {len(feats)} classes")
    say("coco", stage_seconds={k: v["seconds"] for k, v in stages.items()},
        host_ms_per_example=host_ms,
        train_ms_per_step={k: v["timing_ms_per_step"]
                           for k, v in stages.items()
                           if "timing_ms_per_step" in v})
    return dict(stages=stages, host_ms=host_ms)


# --- data parallelism: 2 ranks on the one card over gloo --------------------

DDP_RANKS = 2
DDP_TIMED_STEPS = 2     # steps after the compared one, timed
DDP_CLI_STEPS, DDP_CLI_RESUMED = 3, 5
DDP_SYNTHETIC = 96


def ddp_config() -> Config:
    """Phase 9's f32 configuration (discriminators in f32; TF32 off)."""
    cfg = Config()
    return cfg.replace(discriminator=dataclasses.replace(
        cfg.discriminator, compute_dtype="float32"))


def ddp_step_rank(out_dir: str, deterministic: bool = False) -> int:
    """A rank of the DDP step (``--ddp-step``): joins the gloo group from
    torchrun's environment, steps ``ddp_config()``'s seeded state on its
    half of the 12 images (on cuDNN's deterministic algorithms with
    ``deterministic``), saves its loss shares, first moments, batch
    statistics and pool counts, then times DDP_TIMED_STEPS more steps and
    their collectives."""
    from scene_generation_tpu_torch.parallel import data_parallel
    torch.backends.cudnn.deterministic = deterministic
    comm, dev = data_parallel.init_process_group()
    try:
        cfg = ddp_config()
        state = create_train_state(cfg, dev, seed=SEED, load_vgg=False,
                                   comm=comm)
        data_parallel.verify_replicated(comm, state)
        batch = synthetic_batch(cfg, seed=7, batch_size=TRAIN_BATCH)
        local = TRAIN_BATCH // comm.world_size
        half = type(batch)(*(a[comm.rank * local:(comm.rank + 1) * local]
                             for a in batch))
        _cuda.LAUNCHES.clear()
        metrics = train_step(state, half)
        torch.cuda.synchronize()
        launches = dict(_cuda.LAUNCHES)
        torch.save({
            "metrics": {k: v.cpu() for k, v in metrics.items()
                        if not k.startswith("_")},
            "mu": {f"{name}.{pn}": opt.state[p]["mu"].cpu()
                   for name, m, opt in state.trees()
                   for pn, p in m.named_parameters()},
            "buffers": {f"{name}.{bn}": b.cpu()
                        for name, m, _ in state.trees()
                        for bn, b in m.named_buffers()},
            "pool_counts": state.pool.counts.cpu(),
            "launches": launches, "objects": float(half.obj_mask.sum())},
            os.path.join(out_dir, f"rank{comm.rank}.pt"))
        calls, secs = comm.calls, comm.seconds
        t = time.perf_counter()
        for _ in range(DDP_TIMED_STEPS):
            train_step(state, half)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t) * 1e3 / DDP_TIMED_STEPS
        print(json.dumps({"ddp_rank": comm.rank, "ms_per_step": step_ms,
                          "collective_ms_per_step": (comm.seconds - secs)
                          * 1e3 / DDP_TIMED_STEPS,
                          "collectives_per_step": (comm.calls - calls)
                          / DDP_TIMED_STEPS, "launches": launches}),
              flush=True)
    finally:
        torch.distributed.destroy_process_group()
    return 0


def ddp_cli_rank(argv_json: str) -> int:
    """A rank of ``train.main --distributed`` (``--ddp-cli``), in this
    process so that the launches count: prints one JSON line with its
    launches, the checkpoint files it wrote and its log."""
    argv = json.loads(argv_json)
    writes = []
    orig = ckpt_mod._write_state

    def write_state(directory, tree):
        writes.append(directory)
        return orig(directory, tree)

    ckpt_mod._write_state = write_state
    torch.backends.cuda.matmul.allow_tf32 = False     # PyTorch's defaults
    torch.backends.cudnn.allow_tf32 = True
    _cuda.LAUNCHES.clear()
    _, meta, log = _cli_main(argv)
    print(json.dumps({"ddp_cli_rank": int(os.environ["RANK"]),
                      "launches": dict(_cuda.LAUNCHES), "writes": writes,
                      "counters": meta["counters"], "log": log}), flush=True)
    return 0


def spawn_ranks(args, timeout: int = 600) -> list:
    """``chip_smoke.py <args>`` as DDP_RANKS ranks on this card, with
    torchrun's environment (one host, a free port); each rank's last JSON
    line, in rank order. Fails if a rank fails."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for r in range(DDP_RANKS):
        env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r),
                   WORLD_SIZE=str(DDP_RANKS),
                   LOCAL_WORLD_SIZE=str(DDP_RANKS),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__)] + args, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        check(p.returncode == 0, f"DDP rank {r} of {' '.join(args[:1])} "
              f"failed ({p.returncode}):\n{out[-3000:]}")
    return [json.loads([ln for ln in out.splitlines()
                        if ln.startswith("{")][-1]) for out in outs]


@contextlib.contextmanager
def cudnn_mode(autotune: bool = False, deterministic: bool = False):
    """cuDNN's benchmark (autotuned algorithms) and deterministic flags
    within the block."""
    before = (torch.backends.cudnn.benchmark,
              torch.backends.cudnn.deterministic)
    torch.backends.cudnn.benchmark = autotune
    torch.backends.cudnn.deterministic = deterministic
    try:
        yield
    finally:
        (torch.backends.cudnn.benchmark,
         torch.backends.cudnn.deterministic) = before


def _joined_step(cfg: Config, batch, autotune: bool = False,
                 deterministic: bool = False) -> tuple:
    """One single-process f32 step of a seeded state on the card (with
    ``autotune``, on the convolution algorithms cuDNN's benchmark mode
    picks; with ``deterministic``, on cuDNN's deterministic algorithms):
    its metrics, its trees' first moments and buffers (on the host) and
    the pool's counts."""
    state = create_train_state(cfg, "cuda", seed=SEED, load_vgg=False)
    with cudnn_mode(autotune, deterministic):
        metrics = {k: v.cpu() for k, v in train_step(state, batch).items()
                   if not k.startswith("_")}
    trees = [(name, {pn: opt.state[p]["mu"].cpu()
                     for pn, p in m.named_parameters()},
              {bn: b.cpu() for bn, b in m.named_buffers()})
             for name, m, opt in state.trees()]
    counts = state.pool.counts.cpu()
    del state
    torch.cuda.empty_cache()
    return metrics, trees, counts


def _worst_moment(trees: list, mus: dict) -> tuple:
    """(error over tolerance, leaf) of the worst first moment in ``mus``
    (``{"tree.param": mu}``) against ``trees``' under phase 9's rule:
    5e-2 of the leaf's max plus 1e-4 of its tree's."""
    worst = (0.0, "")
    for name, want, _ in trees:
        tree_max = max(float(m.abs().max()) for m in want.values())
        for pn, m in want.items():
            err = float((mus[f"{name}.{pn}"] - m).abs().max())
            tol = 5e-2 * float(m.abs().max()) + 1e-4 * tree_max
            worst = max(worst, (err / tol, f"{name}.{pn}"))
    return worst


def ddp_phase(work: str) -> dict:
    """Data parallelism on the one card: two ranks over gloo (ranks that
    share a card cannot use NCCL), one train step of ``ddp_config()`` at
    6 + 6 images against one single-process step on the 12 from the same
    state, to phase 9's f32 rule (losses within 1e-4 relative, first
    moments within 5e-2 of a leaf's max plus 1e-4 of its tree's, batch
    statistics within 1e-4 relative); then ``train.main --distributed``
    under two ranks: DDP_CLI_STEPS steps with a checkpoint, and a resume to
    DDP_CLI_RESUMED. Rank 0 alone writes checkpoints, both restore.
    Gloo stages every collective through the host: its times say nothing
    of NCCL across cards."""
    cfg = ddp_config()
    batch = synthetic_batch(cfg, seed=7, batch_size=TRAIN_BATCH)
    want, trees, counts = _joined_step(cfg, batch)
    # Witnesses of the f32 floor: the joined step again in this one
    # process, (a) on the same 12 images with the halves swapped, where
    # only the order of the batch sums changes, (b) on cuDNN's autotuned
    # convolution algorithms, and (c) as it is: the same function on the
    # same inputs, apart only by the nondeterministic (atomic) sums of the
    # backward. None has a rank or a collective. Then the joined step on
    # cuDNN's deterministic algorithms, (d) run twice (what atomics outside
    # cuDNN leave) and (e) against the 2-rank step on them.
    half = TRAIN_BATCH // DDP_RANKS
    swapped = type(batch)(*(np.concatenate([a[half:], a[:half]])
                            for a in batch))

    def moments(w_trees):
        return {f"{name}.{pn}": m for name, mus, _ in w_trees
                for pn, m in mus.items()}

    witness = {}
    for name_, (b, autotune) in (("swapped", (swapped, False)),
                                 ("autotuned", (batch, True)),
                                 ("repeated", (batch, False))):
        witness[name_] = _worst_moment(
            trees, moments(_joined_step(cfg, b, autotune)[1]))
    _, det_trees, _ = _joined_step(cfg, batch, deterministic=True)
    witness["deterministic_repeated"] = _worst_moment(det_trees, moments(
        _joined_step(cfg, batch, deterministic=True)[1]))

    def ranks_step(directory, *flags):
        os.makedirs(directory)
        timing = spawn_ranks(["--ddp-step", directory, *flags])
        return timing, [torch.load(os.path.join(directory, f"rank{r}.pt"),
                                   weights_only=True)
                        for r in range(DDP_RANKS)]

    _, det_got = ranks_step(os.path.join(work, "ddp_step_det"),
                            "--ddp-deterministic")
    witness["deterministic_2_rank"] = max(
        _worst_moment(det_trees, g["mu"]) for g in det_got)
    timing, got = ranks_step(os.path.join(work, "ddp_step"))
    check(got[0]["objects"] != got[1]["objects"],
          "the halves hold the same object count")
    loss_err = 0.0
    for k, v in want.items():
        if k == "use_gt":
            check(all(float(g["metrics"][k]) == float(v) for g in got),
                  "the ranks drew another use_gt than the joined step")
            continue
        total = sum(float(g["metrics"][k]) for g in got)
        err = abs(total - float(v))
        check(err <= 1e-4 * abs(float(v)) + 1e-6,
              f"DDP loss {k}: {total} against the joined {float(v)}")
        loss_err = max(loss_err, err / max(abs(float(v)), 1e-6))
    worst, stat_err = (0.0, ""), 0.0
    for g in got:
        check(torch.equal(g["pool_counts"], counts), "DDP pool counts")
        worst = max(worst, _worst_moment(trees, g["mu"]))
        for name, _, bufs in trees:
            for bn, b in bufs.items():
                err = float((g["buffers"][f"{name}.{bn}"] - b).abs().max())
                check(err <= 1e-4 * float(b.abs().max()) + 1e-7,
                      f"DDP batch statistic {name}.{bn}: {err}")
                stat_err = max(stat_err, err)
    check(worst[0] <= 1.0, f"DDP first moment {worst[1]}: {worst[0]} of its "
          "tolerance")
    for t in timing:
        check(t["launches"].get("crop_fwd") == 4
              and t["launches"].get("crop_bwd") == 1,
              f"DDP rank {t['ddp_rank']} step launches {t['launches']}")
    step = dict(max_rel_loss_err=loss_err, max_moment_err_over_tol=worst[0],
                worst_moment=worst[1], max_batch_stat_err=stat_err,
                witness_moment_err_over_tol=witness,
                objects=[g["objects"] for g in got], ranks=timing)
    say("ddp step", **step)

    run = os.path.join(work, "ddp_run")
    common = ["--distributed", "--synthetic", "--synthetic_size",
              str(DDP_SYNTHETIC), "--batch_size", str(TRAIN_BATCH),
              "--print_every", "1", "--num_val_samples", str(TRAIN_BATCH),
              "--timing", "--seed", str(SEED), "--output_dir", run,
              "--checkpoint_every", str(DDP_CLI_STEPS)]
    t0 = time.perf_counter()
    first = spawn_ranks(["--ddp-cli", json.dumps(
        common + ["--num_iterations", str(DDP_CLI_STEPS)])])
    resumed = spawn_ranks(["--ddp-cli", json.dumps(
        common + ["--num_iterations", str(DDP_CLI_RESUMED),
                  "--restore_from_checkpoint", "1"])])
    cli_s = time.perf_counter() - t0
    root = os.path.join(run, "checkpoint")
    for d in ("last", "best"):
        check(os.path.exists(os.path.join(root, d, "state.pt")),
              f"the DDP run wrote no {d}/state.pt")
    for runs, steps in ((first, DDP_CLI_STEPS),
                        (resumed, DDP_CLI_RESUMED - DDP_CLI_STEPS)):
        check(bool(runs[0]["writes"]) and not runs[1]["writes"],
              f"checkpoint writes by rank: {[r['writes'] for r in runs]}")
        losses = [[ln for ln in r["log"].splitlines()
                   if ln.startswith("  [") and "[timing]" not in ln]
                  for r in runs]
        check(losses[0] == losses[1] and len(losses[0]) > 0,
              "the ranks logged different losses")
        for r in runs:
            sweeps = 2 if runs is first else 0    # one checkpoint, 2 sweeps
            want_l = {"crop_fwd": 4 * steps + sweeps, "crop_bwd": steps,
                      "stem": sweeps, "stem_f32": sweeps}
            got_l = {k: r["launches"].get(k, 0) for k in want_l}
            check(got_l == want_l, f"DDP CLI rank launches {got_l}, "
                  f"predicted {want_l}")
    for r in resumed:
        check(f"restored checkpoint at t={DDP_CLI_STEPS}" in r["log"]
              and r["counters"]["t"] == DDP_CLI_RESUMED,
              f"a rank did not resume: {r['counters']}")

    def per_rank(runs, what):
        return [[float(ln.split()[1]) for ln in r["log"].splitlines()
                 if ln.strip().startswith("[timing]") and what in ln]
                for r in runs]

    cli = dict(seconds=cli_s,
               ms_per_step=per_rank(first + resumed, "sustained"),
               collective_ms_per_step=per_rank(first + resumed,
                                               "collectives"),
               launches=[r["launches"] for r in first + resumed],
               writes=[len(r["writes"]) for r in first + resumed],
               note="gloo on one card stages collectives through the host; "
                    "not NCCL across cards")
    say("ddp train CLI", **cli)
    return dict(step=step, cli=cli)


# --- the paper's own checkpoint: ported, served and resumed ---------------

REF_COUNTERS = {"t": 1200, "epoch": 3}
REF_BATCH = 16


def _reference_pt(path: str) -> dict:
    """A checkpoint in the reference trainer's format at the full default
    widths (9 resblocks at 1024 channels, 172 classes, O=9), its weights
    drawn from SEED (``tests/_reference_checkpoint.py``; the published
    checkpoint is not in the repository), saved to ``path``."""
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tests"))
    try:
        from _reference_checkpoint import reference_checkpoint
    finally:
        sys.path.pop(0)
    from scene_generation_tpu_torch.convert_reference import (
        config_from_reference_args)
    vocab = synthetic_vocab(Config().model.num_objs)
    cfg = config_from_reference_args({}, vocab, "float32")
    ckpt = reference_checkpoint(cfg, {}, vocab, seed=SEED,
                                counters=dict(REF_COUNTERS))
    torch.save(ckpt, path)
    return ckpt


def _serve_reference(run: str, dtype: str) -> dict:
    """``n`` requests and a batch-16 forward of the ported checkpoint
    through ``Server`` at ``dtype``; with f32, the stem kernel's inputs
    and output of the batch-16 forward are recorded for the check against
    ``stem_plain``."""
    from scene_generation_tpu_torch.models import generators
    server = Server(run, device="cuda")
    check(server.model.cfg.model.compute_dtype == dtype,
          f"served at {server.model.cfg.model.compute_dtype}, not {dtype}")
    graphs = scene_graphs(server.model.vocab)
    seen = []
    kernel = generators.stem

    def recording_stem(w, g):
        out = kernel(w, g)
        seen.append((w, g, out))
        return out

    _cuda.LAUNCHES.clear()
    for sg in graphs:
        resp = server.generate({"scene_graphs": [sg]})
        check(png_pixels(resp["images"][0]).std() > 0,
              f"ported {dtype}: constant image")
    generators.stem = recording_stem
    try:
        out = forward_b16(server)
    finally:
        generators.stem = kernel
    launches = {k: v for k, v in _cuda.LAUNCHES.items() if v}
    check(tuple(out.imgs_pred.shape) == (REF_BATCH, 128, 128, 3),
          f"ported imgs_pred {tuple(out.imgs_pred.shape)}")
    check_images(out.imgs_pred, f"ported {dtype} b16")
    return dict(launches=launches, requests=len(graphs), seen=seen,
                img_std=float(out.imgs_pred.std()))


def reference_phase(work: str) -> dict:
    """The paper's own checkpoint on the card: a reference-format ``.pt``
    at the full default widths ported by
    ``tools.port_reference_checkpoint`` (f32), its weights held bitwise to
    the ``.pt``'s; served at f32 (the 3xTF32 stem kernel; its output in
    the forward held to ``stem_plain`` within 1e-4) and at bf16 (the bf16
    stem kernel); then one train step resumed from it with
    ``train --restore_from_checkpoint 1`` (the crop forward and d_img
    kernels) and a checkpoint whose val sweeps run the f32 stem kernel.
    Every stage's launches are held to the counts the code predicts."""
    from scene_generation_tpu_torch.convert_reference import (
        convert_reference_discriminators, convert_reference_state_dict)
    from scene_generation_tpu_torch.tools import port_reference_checkpoint
    stages = {}
    pt = os.path.join(work, "checkpoint_with_model.pt")
    run = os.path.join(work, "ported")

    t = time.perf_counter()
    ckpt = _reference_pt(pt)
    stages["write_pt"] = dict(seconds=time.perf_counter() - t,
                              bytes=os.path.getsize(pt))
    meta = _stage("port", stages, {}, lambda: _quiet(
        port_reference_checkpoint.main,
        ["--torch_checkpoint", pt, "--output_dir", run,
         "--compute_dtype", "float32"]), "reference")
    check(meta["counters"] == REF_COUNTERS, f"counters {meta['counters']}")

    # The ported weights, bitwise: the generator and the three
    # discriminators as the checkpoint holds them, against the converter
    # run here on the .pt's tensors.
    cfg = Config.from_json(json.dumps(meta["config"]))
    state = torch.load(ckpt_mod.CheckpointManager(run).state_path(),
                       map_location="cpu", weights_only=True, mmap=True)
    want = dict(convert_reference_discriminators(ckpt, cfg.discriminator),
                g=convert_reference_state_dict(ckpt["model_state"],
                                               cfg.model))
    n_tensors = 0
    for tree, sd in want.items():
        check(state[tree].keys() == sd.keys(), f"ported {tree} keys")
        for k, v in sd.items():
            check(torch.equal(state[tree][k], v), f"ported {tree}.{k}")
            n_tensors += 1
    del state, ckpt

    # Each serving: 3 requests and a batch-16 forward, a stem launch each.
    f32 = _stage("serve_f32", stages, {"stem": 4, "stem_f32": 4},
                 lambda: _serve_reference(run, "float32"), "reference")
    w, g, got = f32.pop("seen")[-1]
    want_stem = stem_plain(w, g)
    stem_err = float((got - want_stem).abs().max())
    check(stem_err <= 1e-4, f"ported f32 forward's stem: {stem_err}")
    del w, g, got, want_stem
    # bf16: the same weights (last/ linked) under a meta at bf16.
    bf16_run = os.path.join(work, "ported_bf16")
    mgr = ckpt_mod.CheckpointManager(bf16_run, use_async=False)
    os.symlink(os.path.dirname(ckpt_mod.CheckpointManager(run).state_path()),
               os.path.dirname(mgr.state_path()))
    mgr.save_meta(dict(meta, config=json.loads(with_model(
        cfg, compute_dtype="bfloat16").to_json())))
    bf16 = _stage("serve_bf16", stages, {"stem": 4, "stem_tc": 4},
                  lambda: _serve_reference(bf16_run, "bfloat16"),
                  "reference")
    bf16.pop("seen")

    # One step resumed from t=1200 and a checkpoint at t=1201: 4 crop
    # forwards and one d_img backward in the step, one crop forward and
    # one f32 stem in each of the two val sweeps (one val batch of 12).
    steps = 1
    argv = ["--synthetic", "--synthetic_size", str(CLI_SYNTHETIC),
            "--torch_deconv", "1", "--batch_size", str(TRAIN_BATCH),
            "--num_iterations", str(REF_COUNTERS["t"] + steps),
            "--checkpoint_every", "1", "--print_every", "1",
            "--num_val_samples", str(TRAIN_BATCH), "--seed", str(SEED),
            "--output_dir", run, "--restore_from_checkpoint", "1"]
    resumed = _stage("resume", stages, {
        "crop_fwd": 4 * steps + 2, "crop_bwd": steps, "stem": 2,
        "stem_f32": 2}, lambda: _cli_main(argv), "reference")
    _, r_meta, log = resumed
    check(f"restored checkpoint at t={REF_COUNTERS['t']}" in log,
          "the ported checkpoint was not restored")
    check(r_meta["counters"]["t"] == REF_COUNTERS["t"] + steps,
          f"resumed to {r_meta['counters']}")
    losses = {k: v[-1] for k, v in r_meta["losses"].items()}
    check(all(np.isfinite(v) for v in losses.values()),
          f"resumed losses {losses}")
    result = dict(stages={k: {kk: vv for kk, vv in v.items()
                              if kk in ("seconds", "launches", "predicted",
                                        "bytes")}
                          for k, v in stages.items()},
                  ported_tensors=n_tensors, stem_max_abs_err=stem_err,
                  img_std={"float32": f32["img_std"],
                           "bfloat16": bf16["img_std"]},
                  resumed_losses=losses, f32_launches=f32["launches"],
                  bf16_launches=bf16["launches"])
    say("reference", **result)
    return result


def _quiet(fn, *args):
    """``fn(*args)`` with its printed lines kept off this script's
    output."""
    import io
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args)


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
        moms = [(o_gpu.state[a]["mu"].cpu(), o_cpu.state[b]["mu"])
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
    parser.add_argument("--only",
                        choices=("stem", "compositor", "crop", "train", "ddp"),
                        help="build and check one kernel alone (its phase "
                        "and its device times), or run the train step's "
                        "phase 8 or the ddp phase alone; no result line")
    parser.add_argument("--ddp-step", metavar="DIR",
                        help="run as a rank of the DDP step phase")
    parser.add_argument("--ddp-deterministic", action="store_true",
                        help="with --ddp-step: on cuDNN's deterministic "
                        "algorithms")
    parser.add_argument("--ddp-cli", metavar="ARGV_JSON",
                        help="run as a rank of the DDP train CLI phase")
    args = parser.parse_args(argv)
    t0 = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.ddp_step:
        return ddp_step_rank(args.ddp_step, args.ddp_deterministic)
    if args.ddp_cli:
        return ddp_cli_rank(args.ddp_cli)
    name = torch.cuda.get_device_name(0)
    card = smi("name,power.limit")
    say("device", name=name, count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda,
        clocks_sm=sm_clock())
    print(card, flush=True)

    t = time.perf_counter()
    built = _cuda.build(_cuda.KERNELS if args.only in (None, "ddp") else
                        ["crop"] if args.only == "train" else [args.only])
    say("build", seconds=time.perf_counter() - t,
        per_kernel={k: v["seconds"] for k, v in built.items()})

    cfg = with_model(Config(), compute_dtype="bfloat16")
    if args.only == "train":
        with torch_default_tf32():
            train_on_card()
        return 0
    if args.only == "ddp":
        work = tempfile.mkdtemp(prefix="sg_ddp_")
        try:
            ddp_phase(work)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        return 0
    if args.only:
        check_phase, times, kcfg = {
            "stem": (check_stem, stem_device_times, cfg),
            "compositor": (check_compositor, compositor_device_times, cfg),
            "crop": (check_crop, crop_device_times, Config())}[args.only]
        rows = check_phase(kcfg)
        times(kcfg, rows)
        if args.only == "crop":
            crop_per_rank_times(kcfg, rows)
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
        vocab = synthetic_vocab(cfg.model.num_objs)
        save_checkpoint(ckpts["factored"], model_cpu, cfg, vocab)
        # The dense variant: the same weights (last/ linked) under a meta
        # with factored_stem=False.
        dense = ckpt_mod.CheckpointManager(ckpts["dense"], use_async=False)
        os.symlink(os.path.dirname(ckpt_mod.CheckpointManager(
            ckpts["factored"]).state_path()),
            os.path.dirname(dense.state_path()))
        dense.save_meta(dense.new_meta(with_model(cfg, factored_stem=False),
                                       vocab))
        say("checkpoint", mask_logit_spread_before=spread)
        serve_launches = serve_and_forward(ckpts["factored"])
        dense_launches = dense_forward(ckpts["dense"])
        gt_appearance(ckpts["factored"])
        card_vs_cpu(model_cpu)
    del model_cpu
    with torch_default_tf32():
        train = train_on_card()
    train_card_vs_cpu()
    generator_f64()
    fresh_device_times(stem_rows, comp_rows, crop_rows)
    # Last: the train CLI and the eval tools on its best/, after every
    # timing of the kernels.
    train_dir = tempfile.mkdtemp(prefix="sg_train_cli_")
    try:
        with torch_default_tf32():
            cli = train_cli_phase(train["ms_per_step"], train_dir)
        t = time.perf_counter()
        evals = eval_phase(train_dir)
        eval_s = time.perf_counter() - t
    finally:
        shutil.rmtree(train_dir, ignore_errors=True)
    acc_launches = sum(evals[k]["launches"].get("crop_fwd", 0)
                       for k in ("train_accuracy_net", "sample_images"))
    # Then the COCO readers and data parallelism, each in a work directory
    # of its own (their checkpoints take 2.2 GiB a slot).
    phase_s = {}
    for name_, phase in (("reference", reference_phase),
                         ("coco", coco_phase), ("ddp", ddp_phase)):
        work = tempfile.mkdtemp(prefix=f"sg_{name_}_")
        t = time.perf_counter()
        try:
            phase_s[name_] = (phase(work), time.perf_counter() - t)
        finally:
            shutil.rmtree(work, ignore_errors=True)
    ref, coco, ddp = (phase_s[k][0] for k in ("reference", "coco", "ddp"))
    # A rank's launches in the DDP train CLI's first run (rank 0).
    rank_launches = ddp["cli"]["launches"][0]

    # Each kernel's launches in the train CLI phase (the bf16 stem's: none;
    # the val sweeps run the f32 one), beside the main path's count.
    cli_launches = dict(cli["launches"], stem=0)

    def row(name, src, replaces, launches, r):
        return dict(name=name, route="cuda", source=src, replaces=replaces,
                    launches=launches,
                    train_cli_launches=cli_launches.get(name, 0),
                    max_abs_err=r["max_abs_err"],
                    ms=r["ms"], plain_ms=r["plain_ms"],
                    bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                    library_ms=r["library_ms"],
                    **{k: r[k] for k in ("device_ms", "library_device_ms")
                       if k in r})

    kernels = [
        row("stem", "scene_generation_tpu_torch/csrc/stem.cu",
            "scene_generation_tpu/ops/pallas/stem.py:47",
            serve_launches["stem_tc"], stem_rows[torch.bfloat16]),
        # The f32 stem (3xTF32): launches serving the ported reference
        # checkpoint at f32; its bound is three TF32 products at the TF32
        # tensor-core rate, cuda_core_bound_ms one f32 product on the CUDA
        # cores; its launch, and the same at a val sweep's batch.
        dict(row("stem_f32", "scene_generation_tpu_torch/csrc/stem.cu",
                 "scene_generation_tpu/ops/pallas/stem.py:47",
                 ref["f32_launches"].get("stem_f32", 0),
                 stem_rows[torch.float32]),
             train_cli_launches=cli["f32_stem_launches"],
             cuda_core_bound_ms=stem_rows[torch.float32][
                 "cuda_core_bound_ms"],
             launch=stem_rows[torch.float32]["launch"],
             val_sweep={k: v for k, v in stem_rows[
                 (torch.float32, TRAIN_BATCH)].items()
                 if k in ("batch", "max_abs_err", "ms", "plain_ms",
                          "library_ms", "bound_ms", "bound_by", "device_ms",
                          "library_device_ms", "launch")}),
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
        # The accuracy net's 224 px crops (f32, 8 images): launches in the
        # eval phase (train_accuracy_net and sample_images).
        dict(row("crop_fwd_224px", "scene_generation_tpu_torch/csrc/crop.cu",
                 "scene_generation_tpu/ops/pallas/crop.py:88", acc_launches,
                 crop_rows[("crop_fwd", ACC_CROP, torch.float32)]),
             eval_launches=acc_launches),
        row("crop_bwd", "scene_generation_tpu_torch/csrc/crop.cu",
            "scene_generation_tpu/ops/pallas/crop.py:126",
            train["launches"]["crop_bwd"],
            crop_rows[("crop_bwd", 32, torch.float32)]),
        # The shapes of a DDP rank (6 of the 12 images, 32 px: D_obj's
        # crops); launches of one rank in the DDP train CLI's first run.
        dict(row("crop_fwd_per_rank",
                 "scene_generation_tpu_torch/csrc/crop.cu",
                 "scene_generation_tpu/ops/pallas/crop.py:88",
                 rank_launches.get("crop_fwd", 0),
                 crop_rows[("crop_fwd_per_rank", 32, torch.float32)]),
             batch=TRAIN_BATCH // DDP_RANKS),
        dict(row("crop_bwd_per_rank",
                 "scene_generation_tpu_torch/csrc/crop.cu",
                 "scene_generation_tpu/ops/pallas/crop.py:126",
                 rank_launches.get("crop_bwd", 0),
                 crop_rows[("crop_bwd_per_rank", 32, torch.float32)]),
             batch=TRAIN_BATCH // DDP_RANKS),
        # The box gradients (d_ry, d_rx) alone: no path of the port asks
        # for them (boxes are batch constants), so 0 launches.
        row("crop_bwd_boxes", "scene_generation_tpu_torch/csrc/crop.cu",
            "scene_generation_tpu/ops/pallas/crop.py:126",
            train["launches"].get("crop_bwd_boxes", 0),
            crop_rows[("crop_bwd_boxes", 32, torch.float32)]),
    ]
    say("done", seconds=time.perf_counter() - t0,
        train_ms_per_step=train["ms_per_step"],
        train_cli_ms_per_step=cli["timing_ms_per_step"], eval_seconds=eval_s,
        eval_stage_seconds={k: v["seconds"] for k, v in evals.items()},
        phase_seconds={k: v[1] for k, v in phase_s.items()},
        reference_stage_seconds={k: v["seconds"]
                                 for k, v in ref["stages"].items()},
        coco_stage_seconds={k: v["seconds"]
                            for k, v in coco["stages"].items()},
        coco_host_ms_per_example=coco["host_ms"],
        ddp_step_ms={r["ddp_rank"]: r["ms_per_step"]
                     for r in ddp["step"]["ranks"]},
        ddp_collective_ms={r["ddp_rank"]: r["collective_ms_per_step"]
                           for r in ddp["step"]["ranks"]},
        ddp_cli_ms_per_step=ddp["cli"]["ms_per_step"])
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
