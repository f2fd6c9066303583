"""BENCHMARK.json keeps to the benchmark's contract, and every name it
holds resolves to the files that the harness finds by that name."""
from __future__ import annotations

import importlib
import json
import re

import pytest

from port_bench.spec import HERE, ROOT, Cell, load_bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
BENCH = load_bench()
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def one_line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(one_line(w) and not w.startswith("/") and ".." not in w
               for w in BENCH["command"])
    assert 1 <= len(BENCH["paths"]) <= 16
    assert all(PATH.match(p) and (ROOT / p).is_dir() for p in BENCH["paths"])


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"]
                         + METRICS, ids=lambda e: e["name"])
def test_entry_names_units_and_keys(entry):
    assert NAME.match(entry["name"])
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
        assert entry["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
    for key in ("why", "layer"):
        if key in entry:
            assert one_line(entry[key])
    if "file" in entry:
        assert set(entry) == {"name", "source", "file", "reduced", "why"}
        assert one_line(entry["source"])
        assert entry["file"].startswith(tuple(p + "/" for p in
                                              BENCH["paths"]))
        assert all(NAME.match(k) for k in entry["reduced"])
    elif "traffic" in entry:
        assert set(entry) == {"name", "config", "traffic", "chips", "why"}
        assert entry["chips"] in (1, 4)
        assert NAME.match(entry["config"]) and NAME.match(entry["traffic"])
    elif "layer" in entry:
        assert set(entry) <= {"name", "unit", "better", "source", "layer",
                              "moves", "workloads"}
    else:
        assert set(entry) <= {"name", "unit", "better", "bound", "source",
                              "workloads"}
        assert entry["source"] in ("host_clock", "device_trace")
        assert 0.01 <= entry["bound"] <= 0.25


def test_names_are_unique():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("workload", CELLS)
def test_cell_resolves_its_files(workload):
    cell = Cell(BENCH, workload)
    assert cell.traffic["kind"] in ("serve", "train")
    importlib.import_module(f"port_bench.{cell.traffic['kind']}")
    assert (HERE / "reference" / f"{cell.config['reference']}.py").is_file()
    assert set(cell.limits["numbers"]) and "control" in cell.limits
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_has_a_reader_and_its_cells_exist(metric):
    mod = importlib.import_module(f"port_bench.metrics.{metric['name']}")
    assert callable(mod.read)
    assert set(metric.get("workloads", CELLS)) <= set(CELLS)
    if "moves" in metric:
        moved = next(m for m in BENCH["end_to_end"]
                     if m["name"] == metric["moves"])
        assert set(metric.get("workloads", CELLS)) <= set(
            moved.get("workloads", CELLS))


def test_four_chip_cells_within_their_share():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(CELLS) // 4)


def test_coco128_is_the_programs_default_config():
    from scene_generation_tpu_torch.config import Config
    cfg = json.loads((ROOT / "port_bench/configs/coco128.json").read_text())
    default = json.loads(Config().to_json())
    assert cfg["model"] == default["model"]
    assert cfg["discriminator"] == default["discriminator"]
    assert cfg["loss"] == default["loss"]
    for k, v in cfg["data"].items():
        assert default["data"][k] == v, k
