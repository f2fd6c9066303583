"""The generator's update a step: the device spans of
``train_step/g_forward``, ``g_losses`` and ``g_backward``."""
from port_bench.metrics._spans import per_step_ms


def read(run):
    return per_step_ms(run, ("g_forward", "g_losses", "g_backward"))
