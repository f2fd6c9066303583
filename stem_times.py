"""Times of the port's stem kernels at the main path's shapes, for comparing
two trees of the repository in one call on the card.

    python3 stem_times.py [--tree DIR]

imports ``scene_generation_tpu_torch`` from DIR (default: this script's
directory; a ``git archive`` of another commit unpacked under ``output/``
for an A/B), builds its stem kernels and, for the f32 kernel at the serving
batch (16) and a val sweep's (12) and the bf16 kernel at the serving
batch, on ``chip_smoke.py``'s inputs (128x128, O = 9, C = 64), prints one
JSON line each: the profiler's device time a call, taken first in the
process (later ones under-count: ``PERF.md`` §6), and the median of 20
calls timed by CUDA events after 3 (host work a launch included). It
checks each kernel against its plain version first (f32 within 1e-4).
Needs an NVIDIA GPU; exits 2 without one.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

import torch

CASES = ((torch.float32, 16), (torch.float32, 12), (torch.bfloat16, 16))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", default=os.path.dirname(
        os.path.abspath(__file__)))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("stem_times: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.tree))
    from scene_generation_tpu_torch.ops import _cuda
    from scene_generation_tpu_torch.ops.stem import stem, stem_plain
    from torch.profiler import ProfilerActivity, profile
    torch.backends.cuda.matmul.allow_tf32 = False
    _cuda.build(["stem"])
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    inputs = {}
    for dtype, n in CASES:
        gen = torch.Generator().manual_seed(1)
        w = torch.rand((n, 134, 134, 9), generator=gen)
        g = 0.1 * torch.randn((n, 7, 7, 9, 64), generator=gen)
        w, g = w.to("cuda", dtype), g.to("cuda", dtype)
        got = stem(w, g)
        want = stem_plain(w.float(), g.float())
        err = float((got.float() - want).abs().max())
        tol = 1e-4 if dtype == torch.float32 else 2 ** -7 * float(
            want.abs().max())
        if err > tol:
            print(f"stem {dtype} at {n}: max abs err {err} > {tol}",
                  file=sys.stderr)
            return 1
        inputs[(dtype, n)] = (w, g, err)
    rows = {}
    for (dtype, n), (w, g, err) in inputs.items():       # device first
        stem(w, g)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                stem(w, g)
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_time_total > 0 and "stem" in e.key]
        rows[(dtype, n)] = dict(
            dtype=str(dtype), batch=n, max_abs_err=err,
            device_ms=(sum(e.device_time_total / e.count for e in kernels)
                       / 1e3 if kernels else "not measured"),
            device_launches=sum(e.count for e in kernels))
    for (dtype, n), (w, g, _) in inputs.items():
        for _ in range(3):
            stem(w, g)
        times = []
        for _ in range(20):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            stem(w, g)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        rows[(dtype, n)]["events_ms"] = statistics.median(times)
    for row in rows.values():
        print(json.dumps(dict(tree=args.tree, card=card, **row)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
