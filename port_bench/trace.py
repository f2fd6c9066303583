"""Reading a ``torch.profiler`` trace of the measured window.

The window is the device's timeline between the start and the end of the
benchmark's own ``bench/window`` range. From it:

- ``busy_s``: the union of the intervals in which a kernel, a copy or a
  memset ran on the device (so overlapping streams count once);
- ``idle_gaps``: the rest of the window, each gap named by what the host
  was doing at its middle (the innermost range or operator running then),
  summed by name;
- ``device_ops``: device seconds by kernel or copy name;
- ``kernel_times``: each launch's device seconds of the kernels whose name
  contains a given string;
- ``spans``: the device intervals of the program's ``record_function``
  ranges (``train_step/<phase>``), by name.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
from typing import Dict, List, Optional, Tuple

import torch

WINDOW = "bench/window"
RANGES = ("bench/", "train_step/")     # record_function ranges on the path


@contextlib.contextmanager
def profiled(enabled: bool, device: torch.device):
    """A profiler over the block (CPU, and the card when there is one);
    yields it, or None when not ``enabled``."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof


class Trace:
    def __init__(self, prof):
        from torch.autograd import DeviceType
        self.device: List[Tuple[int, int, str]] = []
        self.host: List[Tuple[int, int, str]] = []
        self.spans: Dict[str, List[Tuple[int, int]]] = collections.defaultdict(
            list)
        window = None
        for e in prof.events():
            start = int(e.time_range.start * 1e3)
            end = int(e.time_range.end * 1e3)
            name = e.name
            annotation = getattr(e, "is_user_annotation", None)
            if annotation is None:      # older profilers: by the range names
                annotation = name.startswith(RANGES)
            if e.device_type == DeviceType.CPU:
                if name == WINDOW:
                    window = (start, end)
                self.host.append((start, end, name))
            elif annotation:
                self.spans[name].append((start, end))
            else:
                self.device.append((start, end, name))
        if window is None:
            raise RuntimeError(f"the trace holds no {WINDOW} range")
        self.t0, self.t1 = window
        self.device.sort()
        self.host.sort()
        self._host_starts = [h[0] for h in self.host]

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def _busy_intervals(self) -> List[Tuple[int, int]]:
        out: List[List[int]] = []
        for s, e, _ in self.device:
            s, e = max(s, self.t0), min(e, self.t1)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self._busy_intervals()) / 1e9

    def _host_at(self, t: int) -> str:
        """The innermost host range or operator running at ``t``."""
        i = bisect.bisect_right(self._host_starts, t) - 1
        while i >= 0:
            s, e, name = self.host[i]
            if e >= t and name != WINDOW:
                return name
            i -= 1
        return "(no host range)"

    def idle_gaps(self, top: int = 10) -> List[list]:
        gaps = collections.Counter()
        prev = self.t0
        for s, e in self._busy_intervals() + [(self.t1, self.t1)]:
            if s > prev:
                gaps[self._host_at((prev + s) // 2)] += (s - prev) / 1e9
            prev = max(prev, e)
        return [[k[:120], v] for k, v in gaps.most_common(top)]

    def device_ops(self, top: int = 10) -> List[list]:
        total = collections.Counter()
        for s, e, name in self.device:
            if s >= self.t0 and e <= self.t1:
                total[name[:120]] += (e - s) / 1e9
        return [[k, v] for k, v in total.most_common(top)]

    def kernel_times(self, part: str) -> List[float]:
        return [(e - s) / 1e9 for s, e, name in self.device
                if part in name and s >= self.t0 and e <= self.t1]

    def span_seconds(self, name: str) -> Optional[float]:
        """Device seconds of every interval of the range ``name`` inside
        the window, or None when the trace has none."""
        inside = [(s, e) for s, e in self.spans.get(name, [])
                  if s >= self.t0 and e <= self.t1]
        return sum(e - s for s, e in inside) / 1e9 if inside else None
