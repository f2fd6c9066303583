"""The share of the traced window's model calls (``forward_batch``'s
``infer/model`` ranges) that replayed a CUDA graph, in %: those that hold
the program's ``model/replay`` range. 0 where the program replays no
graph; None without a trace of the program's ranges."""
from port_bench.metrics._program import MODEL, host_ranges, served

REPLAY = "model/replay"


def read(run):
    trace = served(run)
    if trace is None:
        return None
    calls = host_ranges(trace, MODEL)
    replays = host_ranges(trace, REPLAY)
    held = sum(any(s <= rs and re <= e for rs, re in replays)
               for s, e in calls)
    return 100.0 * held / len(calls)
