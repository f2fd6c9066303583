"""Images completed over the whole window, by the host clock."""


def read(run):
    if run.kind != "serve":
        return None
    return run.images / run.window_s
