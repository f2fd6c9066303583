"""1 - (union of device-busy intervals / the traced window), in %."""
from port_bench.metrics._idle import idle_share


def read(run):
    return idle_share(run, "serve")
