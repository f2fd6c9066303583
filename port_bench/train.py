"""Training traffic: adversarial steps through
``trainer.step.train_step(state, batch, draws)``, back to back.

Set-up builds the generator, the three discriminators and VGG19 through
the program's constructors on the card, loads the weights made from the
seed into them and into one ``TrainState``, draws a pool of host batches
and every step's draws (the ``use_gt`` coin, the mask noise, the pool's
read base) from the seed, and drives that state through its first
``checked_steps`` steps by the window's own call and feed (the loader's
``device_prefetch``: pinned copies on a side stream), recording each
step's losses, the first gradient as Adam holds it after step 1 (mu over
1 - beta1) and the parameters' change after the last. The same state then
runs the window: steps launched back to back until ``seconds`` have
passed, the window closed once the last has completed.

Afterwards, with the program's state freed, the reference
(``reference/train_step.py``, f32, TF32 off) runs the checked steps from
the same weights, batches and draws, and ``compare_train`` measures the
gaps.
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
from port_bench.reference import train_step as ref
from port_bench.reference.precision import F32, Precision
from port_bench.serve import say_rates, say_setup
from port_bench.trace import WINDOW, Trace, profiled
from port_bench.weights import condition_heads, seeded_state, sub_seed

TREES = ("g", "d_img", "d_obj", "d_mask", "vgg")


def plan(cfg: dict, traffic: dict, seed: int, steps: int):
    """The host batches, each step's batch index and its draws (on the
    host): the pool's read base follows the pool's counts, which the
    batches alone decide."""
    dc, mc = cfg["data"], cfg["model"]
    pool = scenes.batches(
        sub_seed(seed, 1) % 2 ** 32, traffic["pool_batches"],
        traffic["batch"], dc["image_size"][0], dc["mask_size"],
        mc["num_objs"], traffic["min_objects"], traffic["max_objects"],
        dc["max_objs"], dc["max_triples"])
    rng = np.random.RandomState(sub_seed(seed, 2) % 2 ** 32)
    order = np.concatenate([rng.permutation(len(pool))
                            for _ in range(steps // len(pool) + 1)])[:steps]
    use_gt = (rng.rand(steps) < 0.5).astype(np.float32)
    noise = rng.standard_normal((steps, mc["mask_noise_dim"])).astype(
        np.float32)
    u = rng.rand(steps, mc["num_objs"])
    counts = np.zeros(mc["num_objs"], np.int64)
    base = np.zeros((steps, mc["num_objs"]), np.int64)
    for i in range(steps):
        high = np.maximum(counts, 1)
        base[i] = np.minimum((u[i] * high).astype(np.int64), high - 1)
        b = pool[order[i]]
        valid = b.obj_mask.reshape(-1) > 0
        counts = np.minimum(counts + np.bincount(
            b.objs.reshape(-1)[valid], minlength=mc["num_objs"]),
            mc["pool_size"])
    return pool, order, use_gt, noise, base


def batch_tensors(b: scenes.Batch, device) -> dict:
    t = lambda a: torch.as_tensor(np.asarray(a)).to(device)  # noqa: E731
    return dict(imgs=t(b.imgs), objs=t(b.objs).long(), boxes=t(b.boxes),
                masks=t(b.masks), triples=t(b.triples).long(),
                attributes=t(b.attributes), obj_mask=t(b.obj_mask),
                triple_mask=t(b.triple_mask))


def leaf_norms(state, fn) -> Dict[str, Dict[str, float]]:
    """{tree: {leaf: fn(module parameter, its Adam state)}} in one read."""
    keys, vals = [], []
    for name, module, opt in state.trees():
        for k, p in module.named_parameters():
            keys.append((name, k))
            vals.append(fn(name, k, p, opt.state[p]))
    flat = torch.stack(vals).cpu().tolist()
    out: Dict[str, Dict[str, float]] = {}
    for (name, k), v in zip(keys, flat):
        out.setdefault(name, {})[k] = v
    return out


def build(cell, seed: int, device, program):
    """The program's modules on the card, the seed's weights loaded into
    them (also returned, by tree), and the step plan."""
    cfg, traffic = cell.config, cell.traffic
    mc = cfg["model"]
    pc = program.Config.from_json(json.dumps(cfg))
    with torch.device(device):
        modules = program.build_modules(pc)
    shapes = [(f"{n}.{k}", v.shape) for n, m in zip(TREES, modules)
              if m is not None for k, v in m.state_dict().items()]
    flat = seeded_state(shapes, sub_seed(seed, 0), device)
    trees = {n: {k[len(n) + 1:]: v for k, v in flat.items()
                 if k.startswith(n + ".")} for n in TREES}
    del flat
    steps = plan(cfg, traffic, seed, traffic["max_steps"])
    probe = dict(batch_tensors(steps[0][0], device),
                 mask_noise=torch.zeros(mc["mask_noise_dim"], device=device))
    condition_heads(trees["g"], mc, probe)
    for n, m in zip(TREES, modules):
        if m is not None:
            m.load_state_dict(trees[n])
    return pc, modules, trees, steps


def run(cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, program) -> types.SimpleNamespace:
    cfg, traffic = cell.config, cell.traffic
    marks = [("imports", time.perf_counter())]
    mc = cfg["model"]
    b1 = cfg["train"]["beta1"]
    checked = traffic["checked_steps"]
    pc, modules, trees, plan_ = build(cell, seed, device, program)
    marks.append(("modules, weights and traffic", time.perf_counter()))
    pool, order, use_gt, noise, base = plan_
    state = program.TrainState(pc, *modules, device=device)
    draws_dev = (torch.as_tensor(use_gt, device=device),
                 torch.as_tensor(noise, device=device),
                 torch.as_tensor(base, device=device))

    def host_batches():
        for i in range(traffic["max_steps"]):
            yield program.Batch(*pool[order[i]])

    feed = program.device_prefetch(host_batches(), device)
    i = 0

    def one_step():
        nonlocal i
        if i >= traffic["max_steps"]:
            raise RuntimeError(f"the window ran past max_steps "
                               f"({traffic['max_steps']})")
        batch = next(feed)
        d = program.Draws(*(t[i] for t in draws_dev))
        with record_function("bench/train_step"):
            metrics = program.train_step(state, batch, d)
        i += 1
        return metrics

    losses: List[Dict[str, float]] = []
    grads = changes = None
    for s in range(checked):
        m = one_step()
        losses.append({k: float(v) for k, v in m.items()
                       if not k.startswith("_") and k != "use_gt"})
        if s == 0:
            grads = leaf_norms(state, lambda n, k, p, st: st["mu"].norm()
                               / (1 - b1))
    changes = leaf_norms(state, lambda n, k, p, st: (p - trees[n][k]).norm())
    # The reference's copy waits on the host, out of the window's memory.
    trees = {n: {k: v.cpu() for k, v in t.items()} for n, t in trees.items()}
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    marks.append(("checked steps", time.perf_counter()))

    t_warm = time.perf_counter()
    while time.perf_counter() - t_warm < traffic["warmup_seconds"]:
        one_step()
    if device.type == "cuda":
        torch.cuda.synchronize()
    marks.append(("warm-up", time.perf_counter()))
    gc.collect()
    gc.freeze()
    first = i
    last = None
    traced_boxes = []
    trace_s = min(seconds, traffic["trace_seconds"]) if trace else 0.0
    with profiled(trace, device) as prof:
        t_window = time.perf_counter()
        setup_s = t_window - t_start
        with record_function(WINDOW):
            while time.perf_counter() - t_window < trace_s:
                traced_boxes.append(torch.as_tensor(pool[order[i]].boxes))
                last = one_step()
            if device.type == "cuda":
                torch.cuda.synchronize()
    durations = []
    while time.perf_counter() - t_window < seconds:
        t0 = time.perf_counter()
        last = one_step()
        durations.append(time.perf_counter() - t0)
    if device.type == "cuda":
        torch.cuda.synchronize()
    window_s = time.perf_counter() - t_window
    say_setup(t_start, marks)
    say_rates(durations, traffic["batch"])
    steps = i - first
    failed = 0 if last is None or bool(torch.isfinite(
        last["total_loss"]).all()) else 1
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    tr = Trace(prof) if prof is not None else None
    del state, modules, feed, last
    if device.type == "cuda":
        torch.cuda.empty_cache()

    trees = {n: {k: v.to(device) for k, v in t.items()}
             for n, t in trees.items()}
    ref_losses, ref_grads, ref_changes = reference_steps(
        cfg, trees, plan_, checked, device)
    checks = compare_train(losses, grads, changes, ref_losses, ref_grads,
                           ref_changes)
    return types.SimpleNamespace(
        kind="train", cfg=cfg, mc=mc, traffic=traffic, setup_s=setup_s,
        window_s=window_s, steps=steps, batch=traffic["batch"],
        attempted=steps, failed=failed, peak_bytes=peak, trace=tr,
        traced_steps=len(traced_boxes), traced_boxes=traced_boxes,
        checks=checks)


def reference_steps(cfg, trees, plan_, count, device, prec=F32,
                    prec_d=F32):
    """The reference's losses, first gradients and changes over ``count``
    steps from the same weights, batches and draws (``plan``)."""
    pool, order, use_gt, noise, base = plan_
    b1 = cfg["train"]["beta1"]
    with no_tf32():
        st = ref.State(cfg, trees, device)
        losses = []
        grads = None
        for i in range(count):
            losses.append(ref.step(
                st, batch_tensors(pool[order[i]], device), float(use_gt[i]),
                torch.as_tensor(noise[i], device=device),
                torch.as_tensor(base[i]), prec, prec_d))
            if i == 0:
                grads = {n: {k: float(st.opt[n].mu[k].norm() / (1 - b1))
                             for k in st.params[n]} for n in st.params}
        changes = {n: {k: float((p.detach() - trees[n][k]).norm())
                       for k, p in st.params[n].items()}
                   for n in st.params}
    return losses, grads, changes


def leaf_gaps(prog: Dict[str, Dict[str, float]],
              refs: Dict[str, Dict[str, float]],
              moving: Dict[str, Dict[str, float]]) -> Dict[str, list]:
    """Per tree, each leaf's |norm_prog - norm_ref| over the larger of the
    reference leaf's norm and the tree's median leaf norm, sorted, with
    its leaf. Leaves whose reference gradient is under a thousandth of the
    tree's median leaf gradient are left out (their change is rounding
    alone: a bias before an instance norm)."""
    out = {}
    for tree, leaves in refs.items():
        med_g = float(np.median(list(moving[tree].values())))
        med = float(np.median(list(leaves.values())))
        out[tree] = sorted((abs(prog[tree][k] - r) / max(r, med, 1e-30), k)
                           for k, r in leaves.items()
                           if moving[tree][k] >= 1e-3 * med_g)
    return out


def median(gaps: list) -> float:
    return float(np.median([g for g, _ in gaps]))


def compare_train(losses, grads, changes, ref_losses, ref_grads,
                  ref_changes) -> Dict[str, float]:
    """The step's gaps: each loss term against the reference's, relative
    to the larger of its value and the step's median term, on the first
    step (``loss_err``) and on every checked step (``loss_all_err``); per
    tree the leaves' gaps of the first gradient and of the parameters'
    change (``leaf_gaps``): the worst leaf and the median leaf, worst over
    the trees. The limits hold the first step's and the medians: later
    steps and single small leaves swing (``PERF.md`` §2)."""
    out = {}
    for i, (p, r) in enumerate(zip(losses, ref_losses)):
        med = float(np.median([abs(v) for v in r.values()]))
        gap = max(abs(p[k] - v) / max(abs(v), med, 1e-30)
                  for k, v in r.items())
        if i == 0:
            out["loss_err"] = gap
        out["loss_all_err"] = max(out.get("loss_all_err", 0.0), gap)
        print(f"step {i + 1} losses: " + ", ".join(
            f"{k} {p[k]:.6g}/{v:.6g}" for k, v in r.items()), file=sys.stderr)
    for name, prog, refs in (("grad", grads, ref_grads),
                             ("change", changes, ref_changes)):
        gaps = leaf_gaps(prog, refs, ref_grads)
        print(f"{name}: worst leaf and median a tree: " + str({
            t: (v[-1], median(v)) for t, v in gaps.items()}), file=sys.stderr)
        out[f"{name}_err"] = max(v[-1][0] for v in gaps.values())
        out[f"{name}_med_err"] = max(median(v) for v in gaps.values())
    return out


def control_readings(cell, seed: int, device, program,
                     precisions: Dict[str, str]) -> Dict[str, float]:
    """The training control: the reference in the program's place, its
    generator's products at ``precisions["g"]`` and the discriminators'
    and VGG's at ``precisions["d"]``, its checked steps compared as a
    run's are. Needs no window."""
    cfg = cell.config
    _, modules, trees, steps = build(cell, seed, device, program)
    del modules
    count = cell.traffic["checked_steps"]
    low = reference_steps(cfg, trees, steps, count, device,
                          Precision(precisions["g"]),
                          Precision(precisions["d"]))
    return compare_train(*low, *reference_steps(cfg, trees, steps, count,
                                                device))
