"""Host milliseconds a batch in ``forward_batch``'s ``infer/inputs``
range: the noise draw, the attribute and feature tensors and the
host-to-device copies of the batch."""
from port_bench.metrics._program import INPUTS, host_ms


def read(run):
    return host_ms(run, INPUTS)
