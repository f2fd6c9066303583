"""A run's last line has the contract's keys, with ``checks`` last, and a
run without a card exits with an error and prints no result."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from port_bench import run
from port_bench.spec import ROOT
from port_bench.tests.bench_cells import tiny_cell

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("workload", ["coco128.serve_b16",
                                      "coco128.train_b12"])
@pytest.mark.parametrize("trace", [False, True])
def test_result_keys(workload, trace):
    cell = tiny_cell(workload)
    res = run.execute(cell, 2 ** 31 + 5, 1.0, trace, torch.device("cpu"),
                      run.program_entries(), 0.0)
    keys = list(res)
    assert keys[:5] == KEYS and keys[-1] == "checks"
    assert set(keys) <= set(KEYS) | {"breakdown", "checks"}
    assert ("breakdown" in res) == trace
    dev = res["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    assert ("busy_s" in dev and "window_s" in dev) == trace
    names = {m["name"] for m in (cell.per_layer if trace
                                 else cell.end_to_end)}
    assert set(res["metrics"]) <= names
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert set(res["checks"]) == set(cell.limits["numbers"])
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}
    assert res["correct"] is True
    json.dumps(res)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "-m", "port_bench.run", "--workload",
         "coco128.serve_b16", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
