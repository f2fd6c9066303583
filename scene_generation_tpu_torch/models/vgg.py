"""VGG19 features for the perceptual loss (port of the JAX package's
``models/vgg.py``), from plain ``torch.nn``.

The reference slices torchvision's pretrained ``vgg19().features`` at
relu1_1 / relu2_1 / relu3_1 / relu4_1 / relu5_1; this module rebuilds the
convs up to conv5_1 (3x3 SAME, ReLU, 2x2 max pools) and returns those five
taps. ``load_torch_vgg19`` fills it from a torchvision-format state dict
when one is on disk (``SGT_VGG19_WEIGHTS``, or the torch hub cache);
otherwise the weights stay random and the loss reads random-projection
features.
"""
from __future__ import annotations

import os
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from scene_generation_tpu_torch.models.layers import conv_in, lecun_conv_

# Convs of each stage up to and including conv{k}_1; "pool" is a 2x2 max.
STAGES = (
    ((64, "conv1_1"),),
    ((64, "conv1_2"), ("pool",), (128, "conv2_1")),
    ((128, "conv2_2"), ("pool",), (256, "conv3_1")),
    ((256, "conv3_2"), (256, "conv3_3"), (256, "conv3_4"), ("pool",),
     (512, "conv4_1")),
    ((512, "conv4_2"), (512, "conv4_3"), (512, "conv4_4"), ("pool",),
     (512, "conv5_1")),
)
# torchvision's ``features`` indices of the convs above, in order.
TORCHVISION_CONVS = (0, 2, 5, 7, 10, 12, 14, 16, 19, 21, 23, 25, 28)


class Vgg19Features(nn.Module):
    """(N, H, W, 3) NHWC images -> [relu1_1, ..., relu5_1] (NCHW).

    ``dtype`` is the convs' compute dtype (``layers.conv_in``)."""

    def __init__(self, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        convs = {}
        ch = 3
        for stage in STAGES:
            for spec in stage:
                if spec[0] != "pool":
                    convs[spec[1]] = nn.Conv2d(ch, spec[0], 3, padding=1)
                    ch = spec[0]
        self.convs = nn.ModuleDict(convs)

    def init_params(self, gen: torch.Generator) -> None:
        for conv in self.convs.values():
            lecun_conv_(conv, gen)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        h = x.permute(0, 3, 1, 2)
        taps = []
        for stage in STAGES:
            for spec in stage:
                if spec[0] == "pool":
                    h = F.max_pool2d(h, 2, 2)
                else:
                    h = F.relu(conv_in(self.convs[spec[1]], h, self.dtype))
            taps.append(h)
        return taps


def vgg19_checkpoint_path() -> Optional[str]:
    """``SGT_VGG19_WEIGHTS`` if set, else a ``vgg19*.pth`` in the torch hub
    cache, else None."""
    cands = []
    env = os.environ.get("SGT_VGG19_WEIGHTS")
    if env:
        cands.append(env)
    hub = os.path.expanduser("~/.cache/torch/hub/checkpoints")
    if os.path.isdir(hub):
        cands += [os.path.join(hub, f) for f in sorted(os.listdir(hub))
                  if f.startswith("vgg19") and f.endswith(".pth")]
    return next((c for c in cands if os.path.isfile(c)), None)


def load_torch_vgg19(vgg: Vgg19Features, path: Optional[str] = None) -> bool:
    """Copy a torchvision-format ``vgg19`` state dict into ``vgg`` if one
    is found; returns whether it was."""
    path = path or vgg19_checkpoint_path()
    if path is None:
        return False
    sd = torch.load(path, map_location="cpu", weights_only=True)
    with torch.no_grad():
        for idx, conv in zip(TORCHVISION_CONVS, vgg.convs.values()):
            conv.weight.copy_(sd[f"features.{idx}.weight"])
            conv.bias.copy_(sd[f"features.{idx}.bias"])
    return True
