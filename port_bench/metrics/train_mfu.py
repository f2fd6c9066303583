"""The least time the card could take for the traced window's steps
(``work.train_parts`` at the published peaks), over the traced window, in
% (the whole window in a run without a trace)."""
from port_bench import work


def read(run):
    if run.kind != "train":
        return None
    steps, window = run.steps, run.window_s
    if run.trace is not None:
        steps, window = run.traced_steps, run.trace.window_s
    if steps == 0:
        return None
    dc = run.cfg["data"]
    parts = work.train_parts(run.cfg, run.batch, dc["max_objs"],
                             dc["max_triples"])
    return 100.0 * work.least_seconds(parts, steps) / window
