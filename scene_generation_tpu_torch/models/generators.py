"""Generator-side networks (port of the JAX package's
``models/generators.py``). Images run NCHW inside; the public tensors of
``GlobalGenerator`` are NHWC, as in the JAX package."""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from scene_generation_tpu_torch.models.layers import (
    CNN, MaskedBatchNorm, ResnetBlock, conv_init_gan_, global_avg_pool,
    instance_norm, linear_init_, reflect_pad_2d, relu)
from scene_generation_tpu_torch.ops.stem import stem, stem_patches


class MaskNet(nn.Module):
    """Per-object mask generator: (B, dim) vectors seen as 1x1 maps,
    repeated [2x nearest upsample, 3x3 SAME conv, masked BN, ReLU] up to
    ``mask_size``, then a 1x1 conv to one channel. Returns (B, M, M)
    logits; the caller applies the sigmoid."""

    def __init__(self, dim: int, mask_size: int):
        super().__init__()
        if mask_size & (mask_size - 1):
            raise ValueError("Mask size must be a power of 2")
        n_up = int(math.log2(mask_size))
        self.convs = nn.ModuleList(nn.Conv2d(dim, dim, 3, padding=1)
                                   for _ in range(n_up))
        self.bns = nn.ModuleList(MaskedBatchNorm(dim) for _ in range(n_up))
        self.out = nn.Conv2d(dim, 1, 1)

    def init_params(self, gen: torch.Generator) -> None:
        for conv in (*self.convs, self.out):
            conv_init_gan_(conv, gen)

    def forward(self, x: torch.Tensor,
                weights: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = x[:, :, None, None]
        for conv, bn in zip(self.convs, self.bns):
            h = h.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
            h = relu(bn(conv(h), weights))
        return self.out(h)[:, 0]


class AppearanceEncoder(nn.Module):
    """Object-crop appearance encoder: conv-only CNN ('valid' padding,
    masked BN, leakyrelu), global average pool, dense to ``vecs_size``.
    It reads the ground-truth crops of the train-mode forward."""

    def __init__(self, arch: str, vecs_size: int,
                 normalization: str = "batch",
                 activation: str = "leakyrelu-0.2"):
        super().__init__()
        self.cnn = CNN(arch, 3, normalization=normalization,
                       activation=activation, pooling="avg")
        self.dense = nn.Linear(self.cnn.out_channels, vecs_size)

    def init_params(self, gen: torch.Generator) -> None:
        linear_init_(self.dense, 1.0, gen)

    def forward(self, crops: torch.Tensor,
                weights: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, S, S, 3) NHWC crops -> (B, vecs_size)."""
        h = self.cnn(crops.permute(0, 3, 1, 2), weights)
        return self.dense(global_avg_pool(h))


class StemConv(nn.Module):
    """The generator's 7x7 VALID stem, dense or factored.

    The test-mode layout is rank O in the object axis,
    ``layout[n,y,x,:] = sum_o w[n,y,x,o] * F[n,o,:]``, and the conv is
    linear, so ``conv(layout) = sum_{taps,o} w_pad * g`` with
    ``g[n,dy,dx,o,c] = sum_d F[n,o,d] * kernel[c,d,dy,dx]``: a 7x7
    contraction over O channels instead of D. In test mode that contraction
    is the stem kernel (``ops/stem.py``, forward-only); in train mode it is
    the differentiable ``patches`` form, on every device, as in the JAX
    package. Both paths share one ``weight``/``bias``.
    """

    def __init__(self, in_channels: int, features: int, kernel_size: int = 7):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, features, kernel_size)

    def init_params(self, gen: torch.Generator) -> None:
        conv_init_gan_(self.conv, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Dense: padded (N, D, H+6, W+6) layout -> (N, C, H, W)."""
        return self.conv(x)

    def factored(self, weights: torch.Tensor,
                 vecs: torch.Tensor) -> torch.Tensor:
        """Factored: padded (N, H+6, W+6, O) weight field and (N, O, D)
        vectors -> (N, H, W, C)."""
        g = torch.einsum("nod,cdhw->nhwoc", vecs,
                         self.conv.weight.to(vecs.dtype)).contiguous()
        contract = stem_patches if self.training else stem
        # Under autocast g comes out in the autocast dtype: the weight
        # field follows it (the stem kernel takes one dtype).
        return contract(weights.to(g.dtype), g) + self.conv.bias.to(
            vecs.dtype)


class GlobalGenerator(nn.Module):
    """pix2pixHD global generator: reflect-pad 7x7 stem, ``n_downsampling``
    stride-2 convs, ``n_blocks`` resnet blocks, as many stride-2 transpose
    convs, reflect-pad 7x7 conv, tanh; instance norm and ReLU between.

    Upsampling: ``torch_deconv=False`` (the default) is flax's 'SAME'
    transpose conv, which is ``conv_transpose2d(x, flip_hw(K), stride=2)``
    cropped to 2H x 2W; ``torch_deconv=True`` is torch's
    ``ConvTranspose2d(k=3, s=2, p=1, output_padding=1)``. The up weights
    are stored in torch's (in, out, kh, kw) layout for both.
    """

    def __init__(self, input_nc: int, output_nc: int = 3, ngf: int = 64,
                 n_downsampling: int = 4, n_blocks: int = 9,
                 torch_deconv: bool = False):
        super().__init__()
        self.torch_deconv = torch_deconv
        self.stem = StemConv(input_nc, ngf)
        self.downs = nn.ModuleList(
            nn.Conv2d(ngf * 2 ** i, ngf * 2 ** (i + 1), 3, stride=2,
                      padding=1) for i in range(n_downsampling))
        width = ngf * 2 ** n_downsampling
        self.blocks = nn.ModuleList(ResnetBlock(width)
                                    for _ in range(n_blocks))
        self.ups = nn.ModuleList(
            nn.ConvTranspose2d(ngf * 2 ** (n_downsampling - i),
                               ngf * 2 ** (n_downsampling - i) // 2, 3,
                               stride=2)
            for i in range(n_downsampling))
        self.head = nn.Conv2d(ngf, output_nc, 7)

    def init_params(self, gen: torch.Generator) -> None:
        for conv in (*self.downs, *self.ups, self.head):
            conv_init_gan_(conv, gen)

    def forward(self, layout: Optional[torch.Tensor] = None, *,
                weights: Optional[torch.Tensor] = None,
                vecs: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Either an (N, H, W, D) layout, or its factorization: the
        (N, O, H, W) weight field and (N, O, D) vectors. -> (N, H, W, 3)."""
        if layout is not None:
            h = self.stem(reflect_pad_2d(layout.permute(0, 3, 1, 2), 3))
        else:
            w_pad = reflect_pad_2d(weights, 3).permute(0, 2, 3, 1)
            h = self.stem.factored(w_pad.contiguous(), vecs).permute(0, 3, 1, 2)
        h = relu(instance_norm(h))
        for conv in self.downs:
            h = relu(instance_norm(conv(h)))
        for block in self.blocks:
            h = block(h)
        for up in self.ups:
            hh, ww = h.shape[2], h.shape[3]
            if self.torch_deconv:
                h = F.conv_transpose2d(h, up.weight, up.bias, stride=2,
                                       padding=1, output_padding=1)
            else:
                h = F.conv_transpose2d(h, up.weight, up.bias,
                                       stride=2)[:, :, :2 * hh, :2 * ww]
            h = relu(instance_norm(h))
        h = self.head(reflect_pad_2d(h, 3))
        return torch.tanh(h).permute(0, 2, 3, 1)
