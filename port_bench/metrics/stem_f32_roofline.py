"""``stem_f32_kernel``: its multiply-adds counted once at the TF32 rate
(or its bytes) over its mean device time a launch, in %."""
from port_bench.metrics._stem import roofline


def read(run):
    return roofline(run, "stem_f32_kernel", "float32")
