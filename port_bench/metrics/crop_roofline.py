"""The step's crop launches (4 forwards, 1 d_img backward of two kernels)
in the window: the sum of their bounds (``work.crop_step_bound_s`` on
each step's boxes) over the sum of their device times, in %. Not read
when the trace holds another number of launches than the steps traced
ask for (the profiler can drop launches)."""
import sys

from port_bench import work

KERNELS = {"crop_fwd_kernel": 4, "crop_col_spans_kernel": 1,
           "crop_bwd_img_kernel": 1}


def read(run):
    if run.kind != "train" or run.trace is None or not run.traced_boxes:
        return None
    steps = len(run.traced_boxes)
    total = 0.0
    for kernel, per_step in KERNELS.items():
        times = run.trace.kernel_times(kernel)
        if len(times) != per_step * steps:
            print(f"crop_roofline not read: {len(times)} launches of "
                  f"{kernel} for {steps} steps", file=sys.stderr)
            return None
        total += sum(times)
    bound = sum(work.crop_step_bound_s(run.cfg, b) for b in run.traced_boxes)
    return 100.0 * bound / total
