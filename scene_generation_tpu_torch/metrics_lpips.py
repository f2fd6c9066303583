"""LPIPS perceptual distance, the diversity metric (port of the JAX
package's ``metrics_lpips.py``; reference protocol #3, README.md:81 ->
richzhang/PerceptualSimilarity).

    LPIPS(x, y) = sum_l mean_hw || w_l . (f_l(x)^ - f_l(y)^) ||_2^2

f_l are VGG16 activations at relu1_2 / relu2_2 / relu3_3 / relu4_3 /
relu5_3, ^ is unit normalization over channels and w_l the per-channel
"lin" weights of LPIPS v0.1 ('vgg'). Weight files (torchvision vgg16 and
the LPIPS lin head) are looked up as the JAX package does
(``SGT_VGG16_WEIGHTS``, ``SGT_LPIPS_WEIGHTS``, the torch hub cache);
without them the metric runs on seeded random VGG features with uniform
lin weights, and distances compare only within one run.

Inputs are NHWC images in [-1, 1].
"""
from __future__ import annotations

import os
from typing import Callable, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from scene_generation_tpu_torch import resolve_device

_VGG16_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
              512, 512, 512, "M", 512, 512, 512]
_TAP_CONVS = (1, 3, 6, 9, 12)    # taps after the ReLU of these convs
_LPIPS_CHANNELS = (64, 128, 256, 512, 512)
# torchvision vgg16.features index of each conv.
_TORCHVISION_CONVS = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
# LPIPS's input scaling (lpips/lpips.py ScalingLayer).
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class Vgg16Features(nn.Module):
    """VGG16's conv stack (``conv0`` ... ``conv12``) with the five LPIPS
    taps; NHWC in, NHWC taps out."""

    def __init__(self):
        super().__init__()
        cin, i = 3, 0
        for spec in _VGG16_CFG:
            if spec != "M":
                setattr(self, f"conv{i}", nn.Conv2d(cin, spec, 3, padding=1))
                cin, i = spec, i + 1

    def init_random(self, gen: torch.Generator) -> None:
        """flax's default init: kernels N(0, 1/fan_in), zero biases."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Conv2d):
                    fan_in = m.weight[0].numel()
                    m.weight.copy_(torch.randn(m.weight.shape, generator=gen)
                                   / fan_in ** 0.5)
                    m.bias.zero_()

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        h, taps, i = x.permute(0, 3, 1, 2), [], 0
        for spec in _VGG16_CFG:
            if spec == "M":
                h = F.max_pool2d(h, 2, 2)
                continue
            h = F.relu(getattr(self, f"conv{i}")(h))
            if i in _TAP_CONVS:
                taps.append(h.permute(0, 2, 3, 1))
            i += 1
        return taps


class LPIPS(nn.Module):
    """VGG16 taps and the five lin weight vectors (buffers ``lin0`` ...
    ``lin4``); ``forward(x, y)`` -> (N,) distances."""

    def __init__(self):
        super().__init__()
        self.vgg = Vgg16Features()
        for i, c in enumerate(_LPIPS_CHANNELS):
            self.register_buffer(f"lin{i}", torch.full((c,), 1.0 / c))

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        shift = x.new_tensor(_SHIFT)
        scale = x.new_tensor(_SCALE)
        fx = self.vgg((x - shift) / scale)
        fy = self.vgg((y - shift) / scale)
        total = 0.0
        for i, (a, b) in enumerate(zip(fx, fy)):
            a = a * torch.rsqrt((a * a).sum(-1, keepdim=True) + 1e-10)
            b = b * torch.rsqrt((b * b).sum(-1, keepdim=True) + 1e-10)
            d = ((a - b) ** 2 * getattr(self, f"lin{i}")).sum(-1)
            total = total + d.mean((1, 2))
        return total


def _find_weights(env: str, prefix: str) -> Optional[str]:
    p = os.environ.get(env)
    if p and os.path.isfile(p):
        return p
    hub = os.path.expanduser("~/.cache/torch/hub/checkpoints")
    if os.path.isdir(hub):
        for f in sorted(os.listdir(hub)):
            if f.startswith(prefix) and f.endswith(".pth"):
                return os.path.join(hub, f)
    return None


def load_torch_vgg16(vgg: Vgg16Features, path: Optional[str] = None) -> bool:
    """torchvision vgg16 weights (``features.{idx}``) into ``vgg``; False
    when no file is found."""
    path = path or _find_weights("SGT_VGG16_WEIGHTS", "vgg16-")
    if path is None or not os.path.isfile(path):
        return False
    sd = torch.load(path, map_location="cpu", weights_only=True)
    vgg.load_state_dict({f"conv{i}.{leaf}": sd[f"features.{idx}.{leaf}"]
                         for i, idx in enumerate(_TORCHVISION_CONVS)
                         for leaf in ("weight", "bias")})
    return True


def load_lpips_lin(lpips: LPIPS, path: Optional[str] = None) -> bool:
    """LPIPS v0.1 'vgg' lin weights (``lin{i}.model.1.weight``, (1, C, 1,
    1)) into ``lpips``; False (uniform 1/C kept) when no file is found."""
    path = path or _find_weights("SGT_LPIPS_WEIGHTS", "lpips_vgg")
    if path is None or not os.path.isfile(path):
        return False
    sd = torch.load(path, map_location="cpu", weights_only=True)
    for i in range(5):
        getattr(lpips, f"lin{i}").copy_(
            sd[f"lin{i}.model.1.weight"].reshape(-1))
    return True


def create_lpips_fn(device=None) -> Tuple[Callable, bool]:
    """-> (lpips_fn(x, y) -> (N,) distances, loaded): the metric on
    ``device`` (CUDA unless ``"cpu"``), pretrained when both weight files
    are found, else VGG16 drawn from seed 0. x, y: NHWC in [-1, 1]
    (tensors or arrays)."""
    dev = resolve_device(device)
    model = LPIPS()
    model.vgg.init_random(torch.Generator().manual_seed(0))
    loaded = load_torch_vgg16(model.vgg)
    with torch.no_grad():
        loaded = load_lpips_lin(model) and loaded
    model = model.to(dev).eval()

    @torch.no_grad()
    def lpips_fn(x, y) -> torch.Tensor:
        return model(torch.as_tensor(x).to(dev, torch.float32),
                     torch.as_tensor(y).to(dev, torch.float32))

    return lpips_fn, loaded
