"""The stem kernels' share of their bound, from the trace."""
from port_bench import work


def roofline(run, kernel: str, dtype: str):
    """The bound of one launch at the cell's batch over the mean device
    time of the kernel's launches in the window, in %."""
    if run.kind != "serve" or run.trace is None:
        return None
    if run.mc["compute_dtype"] != dtype:
        return None
    times = run.trace.kernel_times(kernel)
    if not times:
        return None
    bound = work.stem_bound_s(run.mc, run.traffic["batch"],
                              run.cfg["data"]["max_objs"], dtype)
    return 100.0 * bound / (sum(times) / len(times))
