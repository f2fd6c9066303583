"""Seconds from the process's start to the measured window: imports,
kernel builds or loads, weights, traffic, warm-up (host clock)."""


def read(run):
    return run.setup_s
