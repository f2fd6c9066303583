"""InceptionV3 in the torchvision layout, for the Inception Score (port of
the JAX package's ``models/inception.py``).

Reference: ``scripts/inception_score.py`` feeds [-1, 1] images bilinearly
resized to 299x299 into torchvision ``inception_v3(transform_input=False)``
and accumulates softmax predictions. This module is that architecture
(BasicConv2d = bias-free conv + BN(eps=1e-3) + ReLU; the aux head left
out) with torchvision's parameter names, so torchvision weights load as
they are. Without a weight file the score is computed over a random-init
network: relative comparisons only.
"""
from __future__ import annotations

import os
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from scene_generation_tpu_torch import resolve_device


class BasicConv2d(nn.Module):
    def __init__(self, cin: int, cout: int, kernel, stride=1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride=stride,
                              padding=padding, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-3)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _avg3(x):
    # Padding counted in the mean, as torchvision and flax's avg_pool do.
    return F.avg_pool2d(x, 3, stride=1, padding=1)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, b3,
                          self.branch_pool(_avg3(x))], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd,
                          F.max_pool2d(x, 3, stride=2)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        return torch.cat([self.branch1x1(x), b7, bd,
                          self.branch_pool(_avg3(x))], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([self.branch3x3_2(self.branch3x3_1(x)), b7,
                          F.max_pool2d(x, 3, stride=2)], 1)


class InceptionE(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        return torch.cat([self.branch1x1(x), b3, bd,
                          self.branch_pool(_avg3(x))], 1)


class InceptionV3(nn.Module):
    """torchvision inception_v3 without the aux head; NHWC input in
    [-1, 1] at 299x299, (N, num_classes) logits."""

    def __init__(self, num_classes: int = 1000):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048)
        self.fc = nn.Linear(2048, num_classes)

    def forward(self, x, return_features: bool = False):
        x = x.permute(0, 3, 1, 2)
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, stride=2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, stride=2)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a",
                     "Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e",
                     "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        pooled = x.mean((2, 3))              # (N, 2048) "pool3" features
        logits = self.fc(pooled)
        return (logits, pooled) if return_features else logits


def resize_bilinear(imgs: torch.Tensor, size=(299, 299)) -> torch.Tensor:
    """NHWC bilinear resize, half-pixel centres (``F.interpolate(mode=
    'bilinear')``, inception_score.py:30)."""
    x = F.interpolate(imgs.permute(0, 3, 1, 2), size=size, mode="bilinear",
                      align_corners=False)
    return x.permute(0, 2, 3, 1)


def _torch_checkpoint_path() -> Optional[str]:
    env = os.environ.get("SGT_INCEPTION_WEIGHTS")
    cands = [env] if env else []
    hub = os.path.expanduser("~/.cache/torch/hub/checkpoints")
    if os.path.isdir(hub):
        cands += [os.path.join(hub, f) for f in sorted(os.listdir(hub))
                  if f.startswith("inception") and f.endswith(".pth")]
    for c in cands:
        if c and os.path.isfile(c):
            return c
    return None


def load_torch_inception(model: InceptionV3) -> bool:
    """Load torchvision inception_v3 weights (``SGT_INCEPTION_WEIGHTS`` or
    the torch hub cache) into ``model``; False when no file is found."""
    path = _torch_checkpoint_path()
    if path is None:
        return False
    sd = torch.load(path, map_location="cpu", weights_only=True)
    sd = {k: v for k, v in sd.items() if not k.startswith("AuxLogits.")
          and not k.endswith("num_batches_tracked")}
    own = {k: v for k, v in model.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    missing = sorted(set(own) - set(sd))
    if missing:
        raise KeyError(f"{path} lacks InceptionV3 weights: {missing[:5]}")
    model.load_state_dict(sd, strict=False)
    return True


def create_inception_probs_fn(device=None) -> Tuple[Callable, bool]:
    """-> (probs_fn(imgs [-1, 1] NHWC) -> (N, 1000) softmax, loaded): the
    network in eval mode on ``device`` (CUDA unless ``"cpu"``), with
    torchvision weights when a file is found, else initialised from seed
    0."""
    dev = resolve_device(device)
    with torch.random.fork_rng(devices=[]):    # the global RNG untouched
        torch.manual_seed(0)
        model = InceptionV3()
    loaded = load_torch_inception(model)
    model = model.to(dev).eval()

    @torch.no_grad()
    def probs_fn(imgs: torch.Tensor) -> torch.Tensor:
        x = resize_bilinear(imgs.to(dev, torch.float32))
        return torch.softmax(model(x), dim=-1)

    return probs_fn, loaded


def create_inception_features_fn(device=None) -> Tuple[Callable, bool]:
    """-> (features_fn(imgs [-1, 1] NHWC) -> (N, 2048) pool3 features,
    loaded): the FID feature extractor, built as ``create_inception_probs_fn``
    builds its network."""
    dev = resolve_device(device)
    with torch.random.fork_rng(devices=[]):    # the global RNG untouched
        torch.manual_seed(0)
        model = InceptionV3()
    loaded = load_torch_inception(model)
    model = model.to(dev).eval()

    @torch.no_grad()
    def features_fn(imgs) -> torch.Tensor:
        x = resize_bilinear(torch.as_tensor(imgs).to(dev, torch.float32))
        return model(x, return_features=True)[1]

    return features_fn, loaded
