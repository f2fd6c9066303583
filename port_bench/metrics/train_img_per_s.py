"""Steps times images a step over the whole window, the window closed
once the last launched step has completed (host clock)."""


def read(run):
    if run.kind != "train":
        return None
    return run.steps * run.batch / run.window_s
