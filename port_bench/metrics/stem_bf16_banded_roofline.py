"""``stem_tc_banded_kernel``, the bf16 stem in pixel bands (images wider
than a ring of whole rows allows): the stem's least time at the batch's
shapes over its mean device time a launch, in %. The bound is the same
whatever kernel computes the stem."""
from port_bench.metrics._stem import roofline


def read(run):
    return roofline(run, "stem_tc_banded_kernel", "bfloat16")
