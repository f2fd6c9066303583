"""Readings of a cell's compared numbers, for setting its limits.

    python3 -m port_bench.control --workload <cell> --seeds 1,2,... \\
        --control-seeds 7,8,9 --seconds 2

runs the cell (without a trace) once per seed in one process and prints
each run's numbers as a JSON line, then does the same for the cell's
control (``limits/<cell>.json``'s ``control``): the configuration with
``config`` merged in (a lower precision of the program's own, such as
bf16 serving), or the reference at ``reference_precision`` put in the
program's place (for training, a precision for the generator and one for
the discriminators and VGG; its readings need no window). Each number's limit
lies between the program's largest reading and the control's smallest
(``PERF.md`` gives both). ``--faults`` runs the program with each named
fault of ``faults.py`` planted, on the same seeds.
"""
from __future__ import annotations

import argparse
import copy
import json
import sys
import time


def merged(cfg: dict, over: dict) -> dict:
    out = copy.deepcopy(cfg)
    for k, v in over.items():
        if isinstance(v, dict):
            out[k] = merged(out.get(k, {}), v)
        else:
            out[k] = v
    return out


def control_cell(cell, program):
    """(cell, program) with the cell's control in the program's place."""
    ctl = cell.limits["control"]
    cell = copy.copy(cell)
    if "config" in ctl:
        # Judged against the cell's own reference: its weights as the cell
        # serves them.
        cell.config = merged(cell.config, dict(
            ctl["config"], reference_dtype=cell.config["serve_compute_dtype"]))
        return cell, program
    from port_bench.serve import ReferenceInServing
    program = copy.copy(program)
    program.InferenceModel = ReferenceInServing(ctl["reference_precision"])
    return cell, program


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--faults", default="",
                   help="faults (faults.py) to plant, each run on --seeds")
    args = p.parse_args(argv)
    from port_bench import run
    run.cache_dirs()
    import torch
    from port_bench.spec import Cell, load_bench
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = Cell(load_bench(), args.workload)
    program = run.program_entries()
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control_seeds = [int(s) for s in args.control_seeds.split(",") if s]
    for seed in seeds:
        res = run.execute(cell, seed, args.seconds, False, device, program,
                          time.perf_counter(), readings=True)
        report("program", seed, res["readings"], res["metrics"])
    from port_bench import faults
    for name in (f for f in args.faults.split(",") if f):
        broken = faults.planted(name, program)
        for seed in seeds:
            res = run.execute(cell, seed, args.seconds, False, device, broken,
                              time.perf_counter(), readings=True)
            report(name, seed, res["readings"])
    ctl = cell.limits["control"]
    for seed in control_seeds:
        if cell.traffic["kind"] == "train" and "reference_precision" in ctl:
            from port_bench import train
            report("control", seed, train.control_readings(
                cell, seed, device, program, ctl["reference_precision"]))
            continue
        c, prog = control_cell(cell, program)
        res = run.execute(c, seed, args.seconds, False, device, prog,
                          time.perf_counter(), readings=True)
        report("control", seed, res["readings"], res["metrics"])
    return 0


def report(side: str, seed: int, checks: dict, metrics=None) -> None:
    print(json.dumps({"side": side, "seed": seed, "checks": checks,
                      "metrics": metrics or {}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
