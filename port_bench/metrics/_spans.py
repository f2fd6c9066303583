"""Device milliseconds a step of the program's ``train_step/<phase>``
ranges."""


def per_step_ms(run, phases):
    if run.kind != "train" or run.trace is None:
        return None
    steps = len(run.trace.spans.get("train_step/g_forward", []))
    seconds = [run.trace.span_seconds(f"train_step/{p}") for p in phases]
    if steps == 0 or any(s is None for s in seconds):
        return None
    return 1e3 * sum(seconds) / steps
