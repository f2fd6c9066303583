"""``correct`` comes out false when the timed path is broken underneath
(``faults.py``) and when the control stands in the program's place, at a
CPU test's size and against each cell's own limits; and true on a sound
run."""
from __future__ import annotations

import torch

from port_bench import control, faults, run, train
from port_bench.tests.bench_cells import tiny_cell

CPU = torch.device("cpu")


def correct(cell, program, seed=9, seconds=0.5) -> bool:
    res = run.execute(cell, seed, seconds, False, CPU, program, 0.0,
                      readings=True)
    # Judged on numbers read, not on an empty sample.
    assert set(cell.limits["numbers"]) <= set(res["readings"])
    return res["correct"]


def test_sound_runs_are_correct():
    program = run.program_entries()
    for w in ("coco128.serve_b16", "paper128_f32.serve_b16",
              "coco128.train_b12"):
        assert correct(tiny_cell(w), program), w


def test_serving_answer_altered():
    broken = faults.planted("altered_answer", run.program_entries())
    for w in ("coco128.serve_b16", "paper128_f32.serve_b16"):
        assert not correct(tiny_cell(w), broken), w


def test_training_state_unchanged():
    broken = faults.planted("unchanged_state", run.program_entries())
    assert not correct(tiny_cell("coco128.train_b12"), broken)


def test_training_half_batch():
    broken = faults.planted("half_batch", run.program_entries())
    assert not correct(tiny_cell("coco128.train_b12"), broken)


def test_serving_controls_fail():
    # At tiny_config the fp8 control's rounding comes close to the limits
    # set at the cell's own size; test_config is deep enough.
    program = run.program_entries()
    for w in ("coco128.serve_b16", "paper128_f32.serve_b16"):
        cell, prog = control.control_cell(tiny_cell(w, size="test"), program)
        for seed in (1, 2, 3):
            assert not correct(cell, prog, seed, 2.0), (w, seed)


def test_training_control_fails():
    # At tiny_config the control's rounding stays under the cell's limits,
    # which were set at the cell's own size; test_config is deep enough.
    cell = tiny_cell("coco128.train_b12", size="test")
    precisions = cell.limits["control"]["reference_precision"]
    for seed in (1, 2, 3):
        checks = train.control_readings(cell, seed, CPU,
                                        run.program_entries(), precisions)
        assert any(checks[k] > lim
                   for k, lim in cell.limits["numbers"].items()), checks
