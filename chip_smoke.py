#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``scene_generation_tpu_torch/csrc``,
holds each against its plain PyTorch version at the serving shapes, serves
HTTP requests and a batch-16 forward through the default ``Config()`` (the
factored stem, bf16), runs the dense-stem variant (the compositor kernel),
compares the card with the CPU in f32, and times serving (CUDA events, then
a ``torch.profiler`` breakdown of the device's time). Every phase
prints one line; any failure raises and the exit code is non-zero. Without
a CUDA device it exits non-zero before printing any result.

The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import base64
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
from scene_generation_tpu_torch.entry import build_model
from scene_generation_tpu_torch.ops import _cuda
from scene_generation_tpu_torch.ops.compositor import (composite,
                                                       composite_plain)
from scene_generation_tpu_torch.ops.layout import compositor_inputs
from scene_generation_tpu_torch.ops.sampling import exact_f32_matmul
from scene_generation_tpu_torch.ops.stem import stem, stem_plain
from scene_generation_tpu_torch.serve import Server, make_handler

BATCH = 16
SEED = 0
TRACE_STEPS = 5
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


def bound(flops: float, nbytes: float, dtype: torch.dtype):
    """(ms, 'bytes' | 'operations'): the least time the card could take."""
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


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


def check_stem(cfg: Config) -> dict:
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        w, g = stem_inputs(cfg, dtype)
        got = stem(w, g)
        want = stem_plain(w, g)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        # f32: 441-term sums in another order; bf16: both round their f32
        # sums to bf16, one ulp apart at most.
        tol = 1e-4 if dtype == torch.float32 else 2 ** -7 * float(
            want.float().abs().max())
        check(err <= tol, f"stem kernel {dtype}: max abs err {err} > {tol}")
        n, hp, wp, o = w.shape
        c = g.shape[-1]
        # One grouped conv computes the same function: the library yardstick.
        x_lib = w.permute(0, 3, 1, 2).reshape(1, n * o, hp, wp).contiguous()
        k_lib = g.permute(0, 4, 3, 1, 2).reshape(n * c, o, 7, 7).contiguous()

        def library():
            return torch.nn.functional.conv2d(x_lib, k_lib, groups=n)

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


# --- phases 4-7: the model --------------------------------------------------

def with_model(cfg: Config, **kw) -> Config:
    return cfg.replace(model=dataclasses.replace(cfg.model, **kw))


def model_inputs(cfg: Config, n: int, device, seed: int = 3):
    """Batch tensors on ``device``; zero features with a zero mask, so every
    object's appearance comes from repr_net (as bench.py serves)."""
    mc = cfg.model
    b = synthetic_batch(cfg, seed=seed, batch_size=n)
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    o = b.objs.shape[1]
    return dict(objs=t(b.objs), triples=t(b.triples),
                attributes=t(b.attributes), obj_mask=t(b.obj_mask),
                triple_mask=t(b.triple_mask),
                mask_noise=torch.zeros(mc.mask_noise_dim, device=device),
                boxes_gt=t(b.boxes),
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


def card_vs_cpu(model_cpu) -> None:
    """Phase 6: the same f32 weights on the card (kernels) and on the CPU
    (plain versions), batch 2, TF32 off, both variants. GT boxes and masks
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
    for factored in (True, False):
        errs = {}
        outs = []
        for model, dev in ((model_gpu, "cuda"), (model_cpu, "cpu")):
            # factored_stem picks a path and owns no parameter, so one set
            # of weights serves both variants.
            model.cfg = with_model(cfg, factored_stem=factored).model
            inputs = model_inputs(cfg, 2, dev)
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
        say("card vs cpu", factored=factored, max_abs_diff=errs, tol=tols)
    del model_gpu


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
    from torch.autograd import DeviceType
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
        rows = sorted((e for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA
                       and device_ms(e) > 0), key=device_ms, reverse=True)
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


def main() -> int:
    t0 = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    say("device", name=name, count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda)
    print(smi, flush=True)

    t = time.perf_counter()
    built = _cuda.build()
    say("build", seconds=time.perf_counter() - t,
        per_kernel={k: v["seconds"] for k, v in built.items()})

    cfg = with_model(Config(), compute_dtype="bfloat16")
    stem_rows = check_stem(cfg)
    comp_rows = check_compositor(cfg)

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
        card_vs_cpu(model_cpu)
        rates = serving_rate(ckpts)

    def row(name, src, replaces, launches, r):
        return dict(name=name, route="cuda", source=src, replaces=replaces,
                    launches=launches, max_abs_err=r["max_abs_err"],
                    ms=r["ms"], plain_ms=r["plain_ms"],
                    bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                    library_ms=r["library_ms"])

    kernels = [
        row("stem", "scene_generation_tpu_torch/csrc/stem.cu",
            "scene_generation_tpu/ops/pallas/stem.py:47",
            serve_launches["stem"], stem_rows[torch.bfloat16]),
        row("compositor", "scene_generation_tpu_torch/csrc/compositor.cu",
            "scene_generation_tpu/ops/pallas/compositor.py:48",
            dense_launches["compositor"], comp_rows[torch.bfloat16]),
    ]
    say("done", seconds=time.perf_counter() - t0,
        img_per_s={k: v["img_per_s"] for k, v in rates.items()})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
