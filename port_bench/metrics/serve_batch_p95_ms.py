"""The 95th percentile (nearest rank) of every batch's latency in the
window, from its hand-over to ``forward_batch`` to its outputs on the
host (host clock)."""
import math


def read(run):
    if run.kind != "serve" or not run.latencies_s:
        return None
    lat = sorted(run.latencies_s)
    return lat[math.ceil(0.95 * len(lat)) - 1] * 1e3
