"""The benchmark's definition, found by name.

``BENCHMARK.json`` at the checkout's root lists the cells (workloads),
configurations and metrics. Everything that belongs to one name lives in
a file of its own under ``port_bench/``, which this module finds by that
name, so that a cell, a mix or a metric is added by adding files and
entries:

- a configuration: the file that its ``BENCHMARK.json`` entry names
  (``configs/<name>.json``), which holds the sizes as they are run and
  names its plain reference (``reference/<reference>.py``);
- a traffic mix: ``traffic/<name>.json``, parameters that one of the
  general runners reads (``kind`` picks ``serve.py`` or ``train.py``);
- a metric: ``metrics/<name>.py``, a reader with ``read(run)`` that
  returns a number or None when it finds nothing to read;
- a cell's limits of the output check: ``limits/<workload>.json``.
"""
from __future__ import annotations

import importlib
import json
from pathlib import Path
from typing import Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class Cell:
    """One workload of ``BENCHMARK.json`` (or ``entry``, a workload entry
    of the same form) with what it names."""

    def __init__(self, bench: dict, name: str, entry: dict = None):
        cells = {w["name"]: w for w in bench["workloads"]}
        if entry is None and name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json (one of "
                           f"{sorted(cells)})")
        self.entry = entry or cells[name]
        self.name = name
        self.chips = int(self.entry["chips"])
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.config = json.loads((ROOT / self.config_entry["file"])
                                 .read_text())
        self.traffic = load_json(HERE / "traffic",
                                 self.entry["traffic"])
        self.limits = load_json(HERE / "limits", name)
        self.end_to_end = [m for m in bench["end_to_end"] if reports(m, name)]
        self.per_layer = [m for m in bench["per_layer"] if reports(m, name)]


def reports(metric: dict, cell: str) -> bool:
    """A metric without ``workloads`` is every cell's."""
    return "workloads" not in metric or cell in metric["workloads"]


def load_json(folder: Path, name: str) -> dict:
    return json.loads((folder / f"{name}.json").read_text())


def load_bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def reader(metric: str):
    """The ``read(run)`` of ``metrics/<metric>.py``."""
    return importlib.import_module(f"port_bench.metrics.{metric}").read


def read_metrics(metrics: List[dict], run) -> Dict[str, dict]:
    """Each metric's reading with its unit; a reader that finds nothing
    leaves its metric out."""
    out = {}
    for m in metrics:
        value = reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
