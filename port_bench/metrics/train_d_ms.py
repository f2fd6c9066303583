"""The discriminators' updates a step: the device spans of
``train_step/d_mask_update``, ``d_obj_update`` and ``d_img_update``."""
from port_bench.metrics._spans import per_step_ms


def read(run):
    return per_step_ms(run, ("d_mask_update", "d_obj_update",
                             "d_img_update"))
