"""Host milliseconds a batch in ``forward_batch``'s ``infer/model``
range: the time the host takes to enqueue the model's work."""
from port_bench.metrics._program import MODEL, host_ms


def read(run):
    return host_ms(run, MODEL)
