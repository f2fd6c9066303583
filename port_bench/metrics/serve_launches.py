"""The host's runtime calls a batch that put work on the device's queue
(kernel launches, graph launches, copies and memsets; a graph launch
counts as one) and start inside ``forward_batch``'s ``infer/inputs`` or
``infer/model`` range. None where the trace holds no device work (the
CPU)."""
import bisect

from port_bench.metrics._program import (INPUTS, MODEL, host_ranges, served,
                                         union)

LAUNCH_CALLS = frozenset((
    "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
    "cudaGraphLaunch", "cudaMemcpyAsync", "cudaMemsetAsync"))


def read(run):
    trace = served(run)
    if trace is None or not trace.device:
        return None
    starts = sorted(s for s, _, n in trace.host if n in LAUNCH_CALLS)
    ranges = union(host_ranges(trace, INPUTS) + host_ranges(trace, MODEL))
    count = sum(bisect.bisect_left(starts, e) - bisect.bisect_left(starts, s)
                for s, e in ranges)
    return count / run.traced_batches
