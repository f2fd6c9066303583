"""Serving traffic: batches of scene graphs through
``InferenceModel.forward_batch``, closed loop, one caller.

Set-up builds the model from the configuration through the program's
constructor, in its serving dtype, loads the weights made from the seed
(``weights.py``), draws a pool of batches and their appearance vectors
from the seed, and runs the window's call on a few of them. The window
then hands the pool's batches over in a seeded order, each as soon as the
last one's outputs (images, boxes, masks) are on the host, until
``seconds`` have passed; the batch in flight then completes. Every batch
is timed from the moment it is handed to ``forward_batch`` to its outputs
on the host.

Afterwards, with the program's state freed, the reference
(``reference/scene_model.py``, f32, TF32 off) recomputes a seeded sample
of the window's batches from the same weights and inputs, and
``compare_serve`` measures the gaps: the boxes and masks against the
reference's own heads, the images against the reference's layout and
generator on the program's boxes and masks (the layout's grid and claims
in the served dtype, ``reference.scene_model.images_on``).
"""
from __future__ import annotations

import gc
import json
import sys
import time
import types
from typing import Dict, List

import numpy as np
import torch
from torch.profiler import record_function

from port_bench import scenes
from port_bench.reference import no_tf32
from port_bench.reference import scene_model as ref
from port_bench.reference.precision import Precision
from port_bench.trace import WINDOW, Trace, profiled
from port_bench.weights import condition_heads, seeded_state, sub_seed

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
WARMUP = 2 ** 40       # call indices of the warm-up, apart from the window's


def model_config(cfg: dict) -> dict:
    """The configuration's model section as it is served."""
    return dict(cfg["model"], compute_dtype=cfg["serve_compute_dtype"])


def draw_traffic(cfg: dict, traffic: dict, seed: int):
    """The pool of batches and each batch's appearance vectors."""
    dc, mc = cfg["data"], cfg["model"]
    pool = scenes.batches(
        sub_seed(seed, 1) % 2 ** 32, traffic["pool_batches"],
        traffic["batch"], dc["image_size"][0], dc["mask_size"],
        mc["num_objs"], traffic["min_objects"], traffic["max_objects"],
        dc["max_objs"], dc["max_triples"])
    table = scenes.cluster_table(sub_seed(seed, 2) % 2 ** 32,
                                 mc["num_objs"], traffic["clusters"],
                                 mc["rep_size"])
    rng = np.random.RandomState(sub_seed(seed, 3) % 2 ** 32)
    feats = [scenes.cluster_features(table, b.objs, b.obj_mask, rng)
             for b in pool]
    return pool, feats


def noise_of(seed: int, i: int) -> torch.Generator:
    """The generator of the i-th call's mask noise."""
    return torch.Generator().manual_seed(sub_seed(seed, 4, i))


def ref_inputs(batch: scenes.Batch, feats, noise: torch.Tensor,
               device) -> dict:
    t = lambda a, dt=torch.float32: torch.as_tensor(  # noqa: E731
        np.asarray(a)).to(device, dt)
    return dict(objs=t(batch.objs, torch.long),
                triples=t(batch.triples, torch.long),
                attributes=t(batch.attributes), obj_mask=t(batch.obj_mask),
                triple_mask=t(batch.triple_mask), boxes=t(batch.boxes),
                masks=t(batch.masks), mask_noise=noise.to(device),
                features=t(feats[0]), features_mask=t(feats[1]))


def make_weights(model: torch.nn.Module, mc: dict, probe: dict, seed: int,
                 device, dtype, ref_dtype=None) -> Dict[str, torch.Tensor]:
    """The seed's weights as they are served (rounded to ``ref_dtype``,
    the served dtype unless a control serves them lower), in f32, for the
    reference; loaded into ``model`` in ``dtype``."""
    shapes = [(k, v.shape) for k, v in model.state_dict().items()]
    P = seeded_state(shapes, sub_seed(seed, 0), device)
    condition_heads(P, mc, probe)
    P = {k: v.to(ref_dtype or dtype).float() for k, v in P.items()}
    model.load_state_dict({k: v.to(dtype) for k, v in P.items()})
    return P


def run(cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, program) -> types.SimpleNamespace:
    """One run of a serving cell. ``program`` is the namespace of the
    program's entries (``run.program``), so a check can break them."""
    cfg, traffic = cell.config, cell.traffic
    marks = [("imports", time.perf_counter())]
    mc = model_config(cfg)
    dtype = DTYPES[mc["compute_dtype"]]
    pc = program.Config.from_json(json.dumps(dict(cfg, model=mc)))
    with torch.device(device):
        model = program.SceneModel(pc.model)
    model = model.to(dtype)
    pool, feats = draw_traffic(cfg, traffic, seed)
    probe = ref_inputs(pool[0], feats[0],
                       torch.zeros(mc["mask_noise_dim"]), device)
    # A control serves lower than the cell: it is judged as the cell is.
    ref_dtype = DTYPES[cfg.get("reference_dtype", mc["compute_dtype"])]
    P = make_weights(model, mc, probe, seed, device, dtype, ref_dtype)
    # The reference's copy waits on the host, out of the window's memory.
    P = {k: v.cpu() for k, v in P.items()}
    im = program.InferenceModel(pc, {}, model)
    marks.append(("model, traffic and weights", time.perf_counter()))
    order = np.random.RandomState(sub_seed(seed, 5) % 2 ** 32).permutation(
        len(pool))

    def call(i: int):
        j = int(order[i % len(pool)])
        with record_function("bench/forward_batch"):
            out = im.forward_batch(pool[j], use_gt_attributes=True,
                                   features=feats[j][0],
                                   features_mask=feats[j][1],
                                   generator=noise_of(seed, i))
        with record_function("bench/readback"):
            return j, (out.imgs_pred.cpu(), out.boxes_pred.cpu(),
                       out.masks_pred.cpu())

    # Warm-up: the window's call on the pool's shapes, for a fixed count
    # and then until warmup_seconds have passed, so that the card's clocks
    # and the host's caches have settled when the window opens.
    t_warm = time.perf_counter()
    w = 0
    while (w < traffic["warmup_batches"]
           or time.perf_counter() - t_warm < traffic["warmup_seconds"]):
        call(WARMUP + w)
        w += 1
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    marks.append(("warm-up", time.perf_counter()))
    gc.collect()
    gc.freeze()
    keep = traffic["check_batches"]
    pick = np.random.RandomState(sub_seed(seed, 6) % 2 ** 32)
    sample: List[tuple] = []
    lat: List[float] = []
    i = 0
    trace_s = min(seconds, traffic["trace_seconds"]) if trace else 0.0
    with profiled(trace, device) as prof:
        t_window = time.perf_counter()
        setup_s = t_window - t_start
        with record_function(WINDOW):
            while time.perf_counter() - t_window < trace_s:
                t0 = time.perf_counter()
                j, outs = call(i)
                lat.append(time.perf_counter() - t0)
                sample = reservoir(sample, keep, i, (i, j, outs), pick)
                i += 1
        traced = i
    while time.perf_counter() - t_window < seconds:
        t0 = time.perf_counter()
        j, outs = call(i)
        lat.append(time.perf_counter() - t0)
        sample = reservoir(sample, keep, i, (i, j, outs), pick)
        i += 1
    window_s = time.perf_counter() - t_window
    say_setup(t_start, marks)
    say_rates(lat, traffic["batch"])
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    tr = Trace(prof) if prof is not None else None
    del im, model
    if device.type == "cuda":
        torch.cuda.empty_cache()

    P = {k: v.to(device) for k, v in P.items()}
    checks = compare_sample(P, mc, pool, feats, sample, seed, device,
                            ref_dtype)
    n = traffic["batch"]
    return types.SimpleNamespace(
        kind="serve", cfg=cfg, mc=mc, traffic=traffic, setup_s=setup_s,
        window_s=window_s, batches=i, images=i * n, latencies_s=lat,
        attempted=i * n, failed=checks.pop("_nonfinite"), peak_bytes=peak,
        trace=tr, traced_batches=traced, checks=checks)


def say_setup(t_start: float, marks) -> None:
    """Set-up's seconds by phase, on standard error."""
    prev, parts = t_start, []
    for name, t in marks:
        parts.append(f"{name} {t - prev:.2f}")
        prev = t
    print("set-up seconds: " + ", ".join(parts), file=sys.stderr)


def say_rates(durations, per_item: int) -> None:
    """Items a second of the window, second by second, on standard error
    (from back-to-back items' durations)."""
    out, t, done, edge = [], 0.0, 0, 1.0
    for d in durations:
        t += d
        done += per_item
        if t >= edge:
            out.append(round(done / t, 1))
            edge += 1.0
    print(f"cumulative rate by second: {out}", file=sys.stderr)


def reservoir(sample: list, keep: int, i: int, item, rng) -> list:
    """Seeded reservoir sampling: a uniform ``keep`` of the items seen."""
    if len(sample) < keep:
        return sample + [item]
    r = rng.randint(i + 1)
    if r < keep:
        sample[r] = item
    return sample


def compare_sample(P, mc: dict, pool, feats, sample, seed: int, device,
                   grid: torch.dtype) -> dict:
    """The reference on each sampled batch, its gaps to the program's
    outputs, worst over the sample."""
    worst: Dict[str, float] = {}
    nonfinite = 0
    for i, j, outs in sample:
        noise = torch.randn(mc["mask_noise_dim"], generator=noise_of(seed, i))
        inp = ref_inputs(pool[j], feats[j], noise, device)
        imgs, boxes, masks = (o.to(device).float() for o in outs)
        with torch.no_grad(), no_tf32():
            r = ref.serve(P, mc, inp)
            r["imgs"], r["empty"] = ref.images_on(
                P, mc, r["vecs"], boxes, masks, inp["obj_mask"], grid)
        gaps = compare_serve(imgs, boxes, masks, r, inp["obj_mask"])
        nonfinite += int(gaps.pop("_nonfinite"))
        print(f"batch {i}: {gaps}, {sum(r['empty'])} empty", file=sys.stderr)
        for k, v in gaps.items():
            worst[k] = max(worst.get(k, 0.0), v)
    worst["_nonfinite"] = nonfinite
    return worst


def compare_serve(imgs, boxes, masks, r: dict,
                  obj_mask: torch.Tensor) -> Dict[str, float]:
    """Gaps of one batch, against the reference's own heads: the largest
    |box| difference and the worst valid object's RMS mask difference
    (the mask head rounds in bf16 at a few parts in a hundred of a logit,
    so single pixels near 0.5 swing; an object's RMS holds still); the
    worst image's RMS
    difference relative to the RMS of the reference's image on the
    program's boxes and masks (``reference.scene_model.images_on``); the
    number of images that are not finite. An image in which nothing is
    claimed is left out of the images' gap: its layout is constant, and
    rounding alone decides it."""
    valid = obj_mask > 0
    nonfinite = (~torch.isfinite(imgs.flatten(1)).all(1)).sum()
    box_gap = (boxes - r["boxes"]).abs()[valid].max()
    mask_gap = ((masks - r["masks"]) ** 2).flatten(2).mean(2).sqrt()[
        valid].max()
    err = ((imgs - r["imgs"]) ** 2).flatten(1).mean(1).sqrt()
    scale = (r["imgs"] ** 2).flatten(1).mean(1).sqrt()
    gap = torch.nan_to_num(err / scale, nan=float("inf"))
    keep = ~torch.tensor(r["empty"], device=gap.device)
    img_gap = gap[keep].max() if bool(keep.any()) else torch.zeros(())
    return dict(boxes_err=float(box_gap), masks_err=float(mask_gap),
                imgs_err=float(img_gap), _nonfinite=float(nonfinite))


class ReferenceInServing:
    """The reference at a lower precision in ``InferenceModel``'s place:
    the serving control. Built as the program's ``InferenceModel`` is, from
    the same (seeded) model, it answers ``forward_batch`` with
    ``reference.scene_model.serve`` at ``precision``."""

    def __init__(self, precision: str):
        self.prec = Precision(precision)

    def __call__(self, cfg, vocab, model):
        self.mc = json.loads(cfg.to_json())["model"]
        self.P = {k: v.float() for k, v in model.state_dict().items()}
        self.device = next(model.parameters()).device
        return self

    def forward_batch(self, batch, use_gt_attributes, features,
                      features_mask, generator):
        noise = torch.randn(self.mc["mask_noise_dim"], generator=generator)
        inp = ref_inputs(batch, (features, features_mask), noise,
                         self.device)
        with torch.no_grad(), no_tf32():
            r = ref.serve(self.P, self.mc, inp, self.prec)
        return types.SimpleNamespace(imgs_pred=r["imgs"],
                                     boxes_pred=r["boxes"],
                                     masks_pred=r["masks"])
