"""Run one cell of the port's benchmark once.

    python3 -m port_bench.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. It loads, warms up, measures for ``seconds``,
checks the window's outputs against the plain reference, and prints one
JSON object as the last line of its standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with its limit,
also printed as the last lines of standard error.

It exits with another code than 0 and prints no result when there is no
CUDA device or fewer than the cell asks for, or when the process holds
JAX or the JAX package once the window has closed.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "scene_generation_tpu")


def cache_dirs() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths,
    so that only a checkout's first run builds."""
    from port_bench.spec import ROOT
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["USE_FLAX"] = "0"


def program_entries() -> types.SimpleNamespace:
    """The program's entries the benchmark drives. A check of the
    benchmark replaces one of them to break the timed path."""
    from scene_generation_tpu_torch.api import InferenceModel
    from scene_generation_tpu_torch.config import Config
    from scene_generation_tpu_torch.data.batching import Batch
    from scene_generation_tpu_torch.data.loader import device_prefetch
    from scene_generation_tpu_torch.models import SceneModel
    from scene_generation_tpu_torch.ops import _cuda
    from scene_generation_tpu_torch.trainer.step import Draws, train_step
    from scene_generation_tpu_torch.trainer.train_state import (
        TrainState, build_modules)
    return types.SimpleNamespace(
        Config=Config, SceneModel=SceneModel, InferenceModel=InferenceModel,
        Batch=Batch, device_prefetch=device_prefetch, Draws=Draws,
        train_step=train_step, TrainState=TrainState,
        build_modules=build_modules, kernels=_cuda)


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the benchmark must not
    load, compared whole (the port's name begins with the JAX
    package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def execute(cell, seed: int, seconds: float, trace: bool, device, program,
            t_start: float, readings: bool = False) -> dict:
    """Run ``cell`` once on ``device`` and return its result line; with
    ``readings``, every number the run compared or could compare, under
    ``readings``."""
    import importlib

    import torch
    from port_bench.spec import read_metrics
    if device.type == "cuda":
        # A checkout's first run compiles the kernels: say so apart.
        built = program.kernels.build()
        if built:
            print("compiled " + ", ".join(
                f"{k} in {v['seconds']:.1f} s" for k, v in built.items()),
                file=sys.stderr)
    runner = importlib.import_module(f"port_bench.{cell.traffic['kind']}")
    run = runner.run(cell, seed, seconds, trace, device, t_start, program)
    # A number the run could not read (no batch sampled) fails.
    numbers = {k: {"value": run.checks.get(k, math.inf), "limit": lim}
               for k, lim in cell.limits["numbers"].items()}
    correct = run.failed == 0 and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in numbers.values())
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell.chips, "memory_peak_bytes": int(run.peak_bytes)}
    result = {"correct": bool(correct), "attempted": int(run.attempted),
              "failed": int(run.failed),
              "metrics": read_metrics(cell.per_layer if trace
                                      else cell.end_to_end, run),
              "device": dev}
    if trace:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.device_ops(),
                               "idle_gaps": run.trace.idle_gaps()}
    if readings:
        result["readings"] = run.checks
    result["checks"] = numbers
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cache_dirs()
    import torch
    from port_bench.spec import Cell, load_bench
    cell = Cell(load_bench(), args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs only on the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA devices, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    program = program_entries()
    result = execute(cell, args.seed, args.seconds, bool(args.trace),
                     torch.device("cuda", 0), program, T_START)
    found = forbidden_modules()
    if found:
        print(f"the run loaded {found}: the benchmark must not load JAX or "
              "the JAX package", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
