"""The device's idle share of the traced window."""


def idle_share(run, kind: str):
    if run.kind != kind or run.trace is None:
        return None
    busy = run.trace.busy_s
    if busy <= 0:
        return None
    return 100.0 * (1.0 - busy / run.trace.window_s)
