"""Device-busy milliseconds a batch inside the model call's device
intervals: the device work a batch needs once the host no longer sets
the pace. The union of the kernel, copy and memset intervals
(``Trace._busy_intervals``) within each interval, so that the device's
gaps inside the model call do not count. None without device intervals
(the CPU)."""
from port_bench.metrics._program import (INPUTS, MODEL, host_ranges, overlap,
                                         served, union)

# Ranges whose device work is not the model's: the batch's inputs, and
# the benchmark's own ranges around the call (the read-back).
NOT_MODEL = (INPUTS, "bench/")


def model_intervals(trace):
    """Each batch's device interval of the model call: from the first to
    the last device interval of a range, other than ``NOT_MODEL``'s, that
    starts after the host enters ``infer/model`` and before it enters the
    next batch's (or the window ends). The profiler gives a kernel to the
    innermost range its launch ran in, so ``infer/model``'s own device
    interval holds only the kernels launched outside the ranges nested in
    it, and the nested ones', whatever their names, hold the rest. A
    device interval starts after its launch, and may start after the host
    has left ``infer/model`` (a CUDA graph's launch returns at once); the
    read-back waits for the model, so no batch's work starts after the
    next batch's model call starts."""
    starts = [hs for hs, _ in host_ranges(trace, MODEL)] + [trace.t1]
    model = [iv for name, ivs in trace.spans.items()
             if not name.startswith(NOT_MODEL) for iv in ivs]
    out = []
    for hs, hn in zip(starts, starts[1:]):
        inside = [(s, e) for s, e in model if hs <= s < hn and e <= trace.t1]
        if inside:
            out.append((min(s for s, _ in inside),
                        max(e for _, e in inside)))
    return union(out)


def read(run):
    trace = served(run)
    if trace is None:
        return None
    spans = model_intervals(trace)
    if not spans:
        return None
    return overlap(spans, trace._busy_intervals()) / 1e6 / run.traced_batches
