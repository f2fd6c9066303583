"""The least time the card could take for the traced window's images
(``work.serve_parts`` at the published peaks), over the traced window, in
% (the whole window in a run without a trace)."""
from port_bench import work


def read(run):
    if run.kind != "serve":
        return None
    images, window = run.images, run.window_s
    if run.trace is not None:
        images = run.traced_batches * run.traffic["batch"]
        window = run.trace.window_s
    if images == 0:
        return None
    dc = run.cfg["data"]
    parts = work.serve_parts(run.mc, dc["max_objs"], dc["max_triples"],
                             run.mc["compute_dtype"])
    return 100.0 * work.least_seconds(parts, images) / window
