"""The program's own serving ranges in the traced window:
``InferenceModel.forward_batch`` runs its host work before the model in
the ``record_function`` range ``infer/inputs`` and the model call in
``infer/model``. Each reader here returns None where the window holds no
``infer/model`` range (a program without these ranges, or an untraced
run). None reads the model's ``model/*`` stage ranges by name: a CUDA
graph of the model would replay it without entering them, and these
readings must hold across such a change.

Times in a ``trace.Trace`` are nanoseconds on the profiler's clock,
which its device events share."""
from __future__ import annotations

from typing import List, Optional, Tuple

INPUTS = "infer/inputs"
MODEL = "infer/model"

Intervals = List[Tuple[int, int]]


def host_ranges(trace, name: str) -> Intervals:
    """The host intervals of the range ``name`` inside the window."""
    return [(s, e) for s, e, n in trace.host
            if n == name and s >= trace.t0 and e <= trace.t1]


def served(run):
    """The run's trace where it holds an ``infer/model`` range in the
    window and the window completed a batch; else None."""
    trace = run.trace
    if (run.kind != "serve" or trace is None or not run.traced_batches
            or not host_ranges(trace, MODEL)):
        return None
    return trace


def union(intervals) -> Intervals:
    """Sorted, disjoint intervals covering ``intervals``' nonempty ones."""
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def overlap(a: Intervals, b: Intervals) -> int:
    """The length of the intersection of two sorted, disjoint lists."""
    total, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def host_ms(run, name: str) -> Optional[float]:
    """Host milliseconds a batch inside the range ``name``."""
    trace = served(run)
    if trace is None:
        return None
    inside = host_ranges(trace, name)
    return sum(e - s for s, e in inside) / 1e6 / run.traced_batches
