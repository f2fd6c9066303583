"""ResNet in the torchvision layout, the backbone of the object
classification accuracy metric (port of the JAX package's
``models/resnet.py``).

Reference: ``scripts/train_accuracy_net.py:62-101`` fine-tunes torchvision
``resnet101`` (fc swapped to 172 classes) on ground-truth object crops;
the net then scores generated crops (``sample_images.py:224-239``). The
modules carry torchvision's parameter names, which the weight loader
reads. Input is NHWC in [-1, 1], as everywhere in the package.

Every stage's bottleneck is 64 wide, as in the JAX package's ResNet
(its ``features`` is never doubled, ``models/resnet.py:69-75``), where
torchvision's widths are 64, 128, 256 and 512. So this net, like the
reference, cannot take torchvision's resnet101 weights:
``load_torch_resnet`` raises on a file of other shapes.

Batch norm follows flax's ``nn.BatchNorm(momentum=0.9)``, which the JAX
package trains: the running variance takes the batch's biased variance
(torch's ``BatchNorm2d`` would take the unbiased one).
"""
from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn


class BatchNorm(nn.BatchNorm2d):
    """``BatchNorm2d`` whose running statistics update as flax's do:
    ``r = 0.9 r + 0.1 batch``, the variance biased."""

    def __init__(self, channels: int):
        super().__init__(channels, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
            self.num_batches_tracked += 1
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            self.eps)


class Bottleneck(nn.Module):
    def __init__(self, cin: int, features: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, features, 1, bias=False)
        self.bn1 = BatchNorm(features)
        self.conv2 = nn.Conv2d(features, features, 3, stride=stride,
                               padding=1, bias=False)
        self.bn2 = BatchNorm(features)
        self.conv3 = nn.Conv2d(features, features * 4, 1, bias=False)
        self.bn3 = BatchNorm(features * 4)
        self.downsample = (nn.Sequential(
            nn.Conv2d(cin, features * 4, 1, stride=stride, bias=False),
            BatchNorm(features * 4)) if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(h + identity)


class ResNet(nn.Module):
    """torchvision's ResNet layout with 64-wide bottlenecks in every stage
    (the JAX package's); (N, H, W, 3) in, (N, num_classes) logits out."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 23, 3),
                 num_classes: int = 1000):
        super().__init__()
        self.stage_sizes = tuple(stage_sizes)
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm(64)
        cin = 64
        for stage, blocks in enumerate(self.stage_sizes):
            layers = []
            for b in range(blocks):
                stride = 2 if stage > 0 and b == 0 else 1
                layers.append(Bottleneck(cin, 64, stride, b == 0))
                cin = 256
            setattr(self, f"layer{stage + 1}", nn.Sequential(*layers))
        self.fc = nn.Linear(cin, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv1(x.permute(0, 3, 1, 2))))
        # Padded with -inf, as the JAX package pads before its max pool.
        h = F.max_pool2d(h, 3, stride=2, padding=1)
        for stage in range(len(self.stage_sizes)):
            h = getattr(self, f"layer{stage + 1}")(h)
        return self.fc(h.mean((2, 3)))


def resnet101(num_classes: int = 1000) -> ResNet:
    return ResNet((3, 4, 23, 3), num_classes)


def _weights_path(path: Optional[str]) -> Optional[str]:
    """``path``, else ``SGT_RESNET_WEIGHTS``, else a ``resnet101*.pth`` of
    the torch hub cache (the JAX package's lookup)."""
    if path is not None:
        return path
    env = os.environ.get("SGT_RESNET_WEIGHTS")
    hub = os.path.expanduser("~/.cache/torch/hub/checkpoints")
    cands = [env] if env else []
    if os.path.isdir(hub):
        cands += [os.path.join(hub, f) for f in os.listdir(hub)
                  if f.startswith("resnet101") and f.endswith(".pth")]
    return next((c for c in cands if c and os.path.isfile(c)), None)


def load_torch_resnet(model: ResNet, path: Optional[str] = None,
                      skip_fc: bool = False) -> Tuple[ResNet, bool]:
    """Load a torchvision resnet state dict (``path`` or the lookup of
    ``_weights_path``) into ``model``; ``skip_fc`` keeps the model's own
    classifier (another class count). Returns (model, loaded)."""
    path = _weights_path(path)
    if path is None:
        return model, False
    sd = torch.load(path, map_location="cpu", weights_only=True)
    own = model.state_dict()
    want = [k for k in own if not (skip_fc and k.startswith("fc."))
            and not k.endswith("num_batches_tracked")]
    missing = [k for k in want if k not in sd]
    if missing:
        raise KeyError(f"{path} lacks ResNet weights: {missing[:5]}")
    other = [k for k in want if sd[k].shape != own[k].shape]
    if other:
        raise ValueError(
            f"{path} holds ResNet weights of other shapes ({other[0]}: "
            f"{tuple(sd[other[0]].shape)}, this net "
            f"{tuple(own[other[0]].shape)}): this ResNet keeps the JAX "
            f"package's 64-wide bottlenecks in every stage, not "
            f"torchvision's 64-512")
    model.load_state_dict({k: sd[k] for k in want}, strict=False)
    return model, True
