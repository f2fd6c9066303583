"""On the card, at each cell's own size: the control comes out not
correct on three seeds, each fault the cell can have makes ``correct``
false, and a sound short run is correct. Run on a card with
``python3 -m pytest -m cuda port_bench/tests/test_bench_cuda.py``."""
from __future__ import annotations

import pytest
import torch

from port_bench import control, faults, run, train
from port_bench.tests.bench_cells import full_cell

pytestmark = pytest.mark.cuda
SEEDS = (6100000001, 6100000002, 6100000003)
FAULTS = {"coco128.serve_b16": ("altered_answer",),
          "paper128_f32.serve_b16": ("altered_answer",),
          "coco128.train_b12": ("half_batch", "unchanged_state")}


def card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    run.cache_dirs()
    return torch.device("cuda", 0)


def outcome(cell, program, seed, device) -> bool:
    return run.execute(cell, seed, 2.0, False, device, program,
                       0.0)["correct"]


@pytest.mark.parametrize("workload", sorted(FAULTS))
def test_control_is_not_correct(workload):
    device = card()
    cell = full_cell(workload)
    program = run.program_entries()
    ctl = cell.limits["control"]
    for seed in SEEDS:
        if cell.traffic["kind"] == "train" and "reference_precision" in ctl:
            checks = train.control_readings(cell, seed, device, program,
                                            ctl["reference_precision"])
            assert any(checks[k] > lim
                       for k, lim in cell.limits["numbers"].items()), checks
        else:
            c, prog = control.control_cell(cell, program)
            assert not outcome(c, prog, seed, device), seed


@pytest.mark.parametrize("workload,fault", [(w, f) for w, fs in
                                            sorted(FAULTS.items())
                                            for f in fs])
def test_fault_is_not_correct(workload, fault):
    device = card()
    cell = full_cell(workload)
    program = run.program_entries()
    assert outcome(cell, program, SEEDS[0], device)
    assert not outcome(cell, faults.planted(fault, program), SEEDS[0],
                       device)
