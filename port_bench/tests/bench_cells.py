"""Cells of the benchmark cut to a size a CPU test holds: the cell's own
traffic, limits and metrics with one of the program's small
configurations in place of its own (f32, the plain versions of the
kernels)."""
from __future__ import annotations

import copy
import json
import types

from port_bench.spec import Cell, load_bench

# A cell whose files are kept under port_bench/ but that BENCHMARK.json
# does not list yet (PERF.md, Open questions).
KEPT = {"coco128.train_b12": {"name": "coco128.train_b12",
                              "config": "coco128", "traffic": "train_b12",
                              "chips": 1}}
SMALL_TRAFFIC = {"batch": 4, "min_objects": 2, "max_objects": 3,
                 "pool_batches": 3, "clusters": 3, "warmup_batches": 1,
                 "warmup_seconds": 0, "check_batches": 2, "trace_seconds": 1,
                 "max_steps": 200}


def tiny_cell(workload: str, serve_dtype: str = "float32",
              d_dtype: str = "float32",
              size: str = "tiny") -> types.SimpleNamespace:
    """``size``: the program's ``tiny_config()``, or its larger
    ``test_config()`` (64 px, two graph layers, two residual blocks)."""
    from scene_generation_tpu_torch import config
    cell = full_cell(workload)
    cfg = json.loads(getattr(config, f"{size}_config")().to_json())
    cfg["serve_compute_dtype"] = serve_dtype
    cfg["discriminator"]["compute_dtype"] = d_dtype
    out = copy.copy(cell)
    out.config = cfg
    out.traffic = dict(cell.traffic, **{k: v for k, v in SMALL_TRAFFIC.items()
                                        if k in cell.traffic})
    return out


def full_cell(workload: str) -> Cell:
    """The cell at its own size, listed or kept."""
    return Cell(load_bench(), workload, KEPT.get(workload))
