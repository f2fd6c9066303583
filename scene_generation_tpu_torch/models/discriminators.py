"""The three discriminators (port of the JAX package's
``models/discriminators.py``).

Public images are NHWC, as in the JAX package; inside, the convs run NCHW
(an NHWC tensor seen through ``permute(0, 3, 1, 2)`` is channels-last, which
cuDNN takes as it is). The PatchGANs return their per-stage feature maps
NCHW: the losses that read them (``losses.py``) reduce over every element
and weight only the leading batch axis, so the layout does not enter.

``dtype`` is each module's compute dtype, applied at every conv and dense
layer as flax's ``dtype=`` does (explicit casts, ``layers.conv_in``); the
parameters stay f32. Convs of the PatchGANs are N(0, 0.02) initialised
(``conv_init_gan``), the AC discriminator's convs and dense layers
lecun-normal (flax's defaults).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from scene_generation_tpu_torch.models.layers import (
    CNN, avg_pool_3x3_s2, conv_in, conv_init_gan_, get_activation,
    global_avg_pool, instance_norm, linear_in, linear_init_)
from scene_generation_tpu_torch.ops.crop import crop_bbox_batch


class AcDiscriminator(nn.Module):
    """Object-crop real/fake score and auxiliary classifier.

    (B, S, S, 3) crops -> (scores (B, 1), obj_logits (B, num_objects)); the
    AC cross-entropy is taken in ``losses.py`` (masked), as in the JAX
    package.
    """

    def __init__(self, num_objects: int,
                 arch: str = "C4-64-2,C4-128-2,C4-256-2",
                 normalization: str = "batch",
                 activation: str = "leakyrelu-0.2", padding: str = "valid",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.cnn = CNN(arch, 3, normalization=normalization,
                       activation=activation, padding=padding,
                       pooling="avg", dtype=dtype)
        self.dense = nn.Linear(self.cnn.out_channels, 1024)
        self.real = nn.Linear(1024, 1)
        self.obj = nn.Linear(1024, num_objects)

    def init_params(self, gen: torch.Generator) -> None:
        for lin in (self.dense, self.real, self.obj):
            linear_init_(lin, 1.0, gen)

    def forward(self, crops: torch.Tensor,
                weights: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        h = self.cnn(crops.permute(0, 3, 1, 2), weights)
        vecs = linear_in(self.dense, global_avg_pool(h), self.dtype)
        return (linear_in(self.real, vecs, self.dtype),
                linear_in(self.obj, vecs, self.dtype))


class AcCropDiscriminator(nn.Module):
    """Crops every object slot (``crop_bbox_batch``, the crop kernels on
    the card), then scores the crops with ``AcDiscriminator``; ``obj_mask``
    feeds its masked batch norm.

    Returns (scores (N, O), logits (N, O, num_objects), crops
    (N, O, S, S, 3))."""

    def __init__(self, num_objects: int, object_size: int = 32,
                 arch: str = "C4-64-2,C4-128-2,C4-256-2",
                 normalization: str = "batch",
                 activation: str = "leakyrelu-0.2", padding: str = "valid",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.object_size = object_size
        self.discriminator = AcDiscriminator(
            num_objects, arch, normalization, activation, padding, dtype)

    def forward(self, imgs: torch.Tensor, boxes: torch.Tensor,
                obj_mask: torch.Tensor):
        n, o = boxes.shape[:2]
        s = self.object_size
        crops = crop_bbox_batch(imgs, boxes, s)
        flat = crops.reshape(n * o, s, s, crops.shape[-1])
        scores, logits = self.discriminator(flat, obj_mask.reshape(n * o))
        return scores.reshape(n, o), logits.reshape(n, o, -1), crops


class NLayerDiscriminator(nn.Module):
    """PatchGAN: 4x4 convs with padding 2, stride 2 for the first
    ``n_layers``, then two stride-1 convs; returns every stage's features
    (NCHW), the last being the score map."""

    def __init__(self, input_nc: int, ndf: int = 64, n_layers: int = 3,
                 norm: str = "instance", use_sigmoid: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.norm, self.use_sigmoid, self.dtype = norm, use_sigmoid, dtype
        self.act = get_activation("leakyrelu-0.2")
        chans = [input_nc, ndf]
        for _ in range(1, n_layers):
            chans.append(min(chans[-1] * 2, 512))
        chans.append(min(chans[-1] * 2, 512))
        strides = [2] * n_layers + [1]
        convs = [nn.Conv2d(i, o, 4, stride=s, padding=2)
                 for i, o, s in zip(chans[:-1], chans[1:], strides)]
        convs.append(nn.Conv2d(chans[-1], 1, 4, stride=1, padding=2))
        self.convs = nn.ModuleList(convs)

    def init_params(self, gen: torch.Generator) -> None:
        for conv in self.convs:
            conv_init_gan_(conv, gen)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x: (B, C, H, W) -> per-stage features."""
        feats = []
        h = x
        last = len(self.convs) - 1
        for j, conv in enumerate(self.convs):
            h = conv_in(conv, h, self.dtype)
            if j == last:
                if self.use_sigmoid:
                    h = torch.sigmoid(h)
            else:
                if j > 0 and self.norm == "instance":
                    h = instance_norm(h)
                h = self.act(h)
            feats.append(h)
        return feats


class MultiscaleDiscriminator(nn.Module):
    """``num_d`` PatchGANs over progressively avg-pooled inputs. Takes an
    (N, H, W, C) NHWC input; returns one feature list per scale. Scales are
    named ``scale_{num_d-1-i}`` in the order they run, as in the JAX
    package (and the reference)."""

    def __init__(self, input_nc: int, ndf: int = 64, n_layers: int = 3,
                 norm: str = "instance", use_sigmoid: bool = False,
                 num_d: int = 2, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.scales = nn.ModuleDict(
            (f"scale_{num_d - 1 - i}",
             NLayerDiscriminator(input_nc, ndf, n_layers, norm, use_sigmoid,
                                 dtype))
            for i in range(num_d))

    def forward(self, x: torch.Tensor) -> List[List[torch.Tensor]]:
        results = []
        h = x.permute(0, 3, 1, 2)
        for i, d in enumerate(self.scales.values()):
            results.append(d(h))
            if i != len(self.scales) - 1:
                h = avg_pool_3x3_s2(h)
        return results


class NLayerMaskDiscriminator(nn.Module):
    """Class-conditional mask PatchGAN: 3x3 convs with padding 1; the
    one-hot class is broadcast over space and concatenated before the
    penultimate conv."""

    def __init__(self, num_classes: int, ndf: int = 64, n_layers: int = 2,
                 norm: str = "instance", use_sigmoid: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.norm, self.use_sigmoid, self.dtype = norm, use_sigmoid, dtype
        self.act = get_activation("leakyrelu-0.2")
        chans = [1, ndf]
        for _ in range(1, n_layers):
            chans.append(min(chans[-1] * 2, 512))
        self.downs = nn.ModuleList(
            nn.Conv2d(i, o, 3, stride=2, padding=1)
            for i, o in zip(chans[:-1], chans[1:]))
        nf = min(chans[-1] * 2, 512)
        self.penultimate = nn.Conv2d(chans[-1] + num_classes, nf, 3,
                                     padding=1)
        self.head = nn.Conv2d(nf, 1, 3, padding=1)

    def init_params(self, gen: torch.Generator) -> None:
        for conv in (*self.downs, self.penultimate, self.head):
            conv_init_gan_(conv, gen)

    def forward(self, x: torch.Tensor,
                cond: torch.Tensor) -> List[torch.Tensor]:
        """x: (B, 1, M, M), cond: (B, num_classes) -> per-stage features."""
        feats = []
        h = x
        for j, conv in enumerate(self.downs):
            h = conv_in(conv, h, self.dtype)
            if j > 0 and self.norm == "instance":
                h = instance_norm(h)
            h = self.act(h)
            feats.append(h)
        b, _, hh, ww = h.shape
        c = cond[:, :, None, None].expand(b, cond.shape[-1], hh, ww)
        h = torch.cat([h, c.to(h.dtype)], dim=1)
        h = conv_in(self.penultimate, h, self.dtype)
        if self.norm == "instance":
            h = instance_norm(h)
        h = self.act(h)
        feats.append(h)
        h = conv_in(self.head, h, self.dtype)
        if self.use_sigmoid:
            h = torch.sigmoid(h)
        feats.append(h)
        return feats


class MultiscaleMaskDiscriminator(nn.Module):
    """Multi-scale wrapper over ``NLayerMaskDiscriminator``. Takes
    (B, M, M, 1) NHWC masks and (B, num_classes) one-hot classes."""

    def __init__(self, num_classes: int, ndf: int = 64, n_layers: int = 2,
                 norm: str = "instance", use_sigmoid: bool = False,
                 num_d: int = 1, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.scales = nn.ModuleDict(
            (f"scale_{num_d - 1 - i}",
             NLayerMaskDiscriminator(num_classes, ndf, n_layers, norm,
                                     use_sigmoid, dtype))
            for i in range(num_d))

    def forward(self, x: torch.Tensor,
                cond: torch.Tensor) -> List[List[torch.Tensor]]:
        results = []
        h = x.permute(0, 3, 1, 2)
        for i, d in enumerate(self.scales.values()):
            results.append(d(h, cond))
            if i != len(self.scales) - 1:
                h = avg_pool_3x3_s2(h)
        return results
