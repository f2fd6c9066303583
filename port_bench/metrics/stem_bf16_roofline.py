"""``stem_tc_kernel``: its least time at the batch's shapes (operations
at the bf16 rate, or bytes) over its mean device time a launch, in %."""
from port_bench.metrics._stem import roofline


def read(run):
    return roofline(run, "stem_tc_kernel", "bfloat16")
