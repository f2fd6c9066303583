"""NN building blocks (port of the JAX package's ``models/layers.py``).

Images run NCHW inside the port; a (B, C) batch of vectors has its channels
at dim 1 too, so ``MaskedBatchNorm`` serves both.

Initialisation follows the JAX package's families: N(0, 0.02) for the
generator-side convs (``conv_init_gan``), BN scale 1 + N(0, 0.02),
truncated kaiming-normal for MLP linears and truncated lecun-normal for the
other dense and conv layers (flax's defaults). Each module that owns
parameters has ``init_params(gen)``; ``init_weights`` walks a model.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from scene_generation_tpu_torch.parallel import data_parallel

# flax's truncated normal: stddev / this constant has unit variance after
# truncation at +-2 standard deviations.
_TRUNC_STD = 0.87962566103423978


def normal_(t: torch.Tensor, std: float, gen: torch.Generator) -> None:
    with torch.no_grad():
        t.copy_(torch.randn(t.shape, generator=gen) * std)


def variance_scaling_(t: torch.Tensor, scale: float, fan_in: int,
                      gen: torch.Generator) -> None:
    """flax ``variance_scaling(scale, 'fan_in', 'truncated_normal')``."""
    std = math.sqrt(scale / fan_in) / _TRUNC_STD
    lo, hi = [0.5 * (1 + math.erf(b / math.sqrt(2))) for b in (-2.0, 2.0)]
    u = torch.rand(t.shape, generator=gen, dtype=torch.float64) * (hi - lo) + lo
    with torch.no_grad():
        t.copy_(torch.erfinv(2 * u - 1) * math.sqrt(2) * std)


def conv_init_gan_(conv: nn.Module, gen: torch.Generator) -> None:
    normal_(conv.weight, 0.02, gen)
    nn.init.zeros_(conv.bias)


def lecun_conv_(conv: nn.Conv2d, gen: torch.Generator) -> None:
    fan_in = conv.weight[0].numel()
    variance_scaling_(conv.weight, 1.0, fan_in, gen)
    nn.init.zeros_(conv.bias)


def linear_init_(lin: nn.Linear, scale: float, gen: torch.Generator) -> None:
    variance_scaling_(lin.weight, scale, lin.in_features, gen)
    nn.init.zeros_(lin.bias)


def init_weights(model: nn.Module, seed: int) -> nn.Module:
    """Seed-initialise every parameter of ``model`` (on the CPU, in a fixed
    module order, from one ``torch.Generator``)."""
    gen = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if hasattr(m, "init_params"):
            m.init_params(gen)
    return model


def get_activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """Every name maps to LeakyReLU (the reference's ``get_activation``
    quirk): slope from 'leakyrelu-S', torch's default 0.01 otherwise."""
    slope = 0.01
    if name and name.lower().startswith("leakyrelu") and "-" in name:
        slope = float(name.split("-")[1])
    return lambda x: F.leaky_relu(x, negative_slope=slope)


def relu(x: torch.Tensor) -> torch.Tensor:
    return F.relu(x)


def reflect_pad_2d(x: torch.Tensor, pad: int) -> torch.Tensor:
    """ReflectionPad2d on NCHW."""
    return F.pad(x, (pad, pad, pad, pad), mode="reflect")


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm2d(affine=False) on NCHW: biased variance, eps 1e-5."""
    return F.instance_norm(x, eps=eps)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, C)."""
    return x.mean(dim=(2, 3))


def avg_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """AvgPool2d(3, stride=2, padding=1, count_include_pad=False) on NCHW:
    the multiscale discriminators' downsampler between scales.

    The input is made contiguous first: for a channels-last input (the
    discriminators' NHWC images seen as NCHW) the CUDA backward of
    ``avg_pool2d`` with ``count_include_pad=False`` returned wrong
    gradients (torch 2.11 on the H100, against the CPU and against a
    contiguous input; tests/test_torch_kernels_cuda.py holds it)."""
    return F.avg_pool2d(x.contiguous(), 3, stride=2, padding=1,
                        count_include_pad=False)


def conv_in(conv: nn.Conv2d, x: torch.Tensor,
            dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``conv(x)`` computed in ``dtype``, as flax's ``dtype=`` does: input,
    weight and bias cast to it (the f32 parameters stay f32 and get f32
    gradients). ``None`` computes in the parameters' dtype."""
    if dtype is None:
        return conv(x)
    return F.conv2d(x.to(dtype), conv.weight.to(dtype), conv.bias.to(dtype),
                    conv.stride, conv.padding)


def linear_in(lin: nn.Linear, x: torch.Tensor,
              dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``lin(x)`` computed in ``dtype`` (see ``conv_in``)."""
    if dtype is None:
        return lin(x)
    return F.linear(x.to(dtype), lin.weight.to(dtype), lin.bias.to(dtype))


class MaskedBatchNorm(nn.Module):
    """BatchNorm with optional per-row weights for padded batches.

    torch BatchNorm semantics (momentum 0.1, eps 1e-5, biased variance to
    normalise, unbiased for the running update), channels at dim 1.
    ``weights`` gives each row of dim 0 a weight; zero-weight rows are left
    out of the statistics but still normalised. ``scale`` is stored as an
    offset from 1, as the JAX package stores it. Batch statistics (in
    training mode) are taken in at least f32; eval mode uses the running
    averages, which is what serving does.
    """

    def __init__(self, features: int, momentum: float = 0.1,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.scale = nn.Parameter(torch.zeros(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def init_params(self, gen: torch.Generator) -> None:
        normal_(self.scale, 0.02, gen)
        nn.init.zeros_(self.bias)
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor,
                weights: Optional[torch.Tensor] = None) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.ndim - 2)
        if self.training:
            mean, var = self._batch_stats(x, weights)
        else:
            mean, var = self.running_mean, self.running_var
        scale = (self.scale.float() + 1.0).to(x.dtype)
        y = (x - mean.to(x.dtype).view(shape)) * torch.rsqrt(
            var.to(x.dtype).view(shape) + self.eps)
        return y * scale.view(shape) + self.bias.to(x.dtype).view(shape)

    def _batch_stats(self, x: torch.Tensor, weights: Optional[torch.Tensor]):
        """Mean and biased variance over the rows of every rank (and the
        spatial positions), rows weighted by ``weights``: the weighted sums
        and the count all-reduced in one differentiable call, GSPMD's
        global batch statistics (in one process the sum is the identity)."""
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        dims = [0] + list(range(2, x.ndim))
        feat = x.shape[1]
        if weights is None:
            xw = xf
            count = torch.full((1,), xf.numel() / feat, dtype=xf.dtype,
                               device=xf.device)
        else:
            w = weights.to(xf.dtype).reshape((-1,) + (1,) * (x.ndim - 1))
            xw = xf * w
            count = (w.sum() * (xf.numel() / feat / x.shape[0])).reshape(1)
        sums = data_parallel.all_reduce_sum(
            data_parallel.current().comm,
            torch.cat([xw.sum(dims), (xw * xf).sum(dims), count]))
        count = torch.clamp(sums[-1], min=1.0)
        mean = sums[:feat] / count
        var = torch.clamp(sums[feat:2 * feat] / count - mean * mean, min=0.0)
        self._update_running(mean, var, count)
        return mean, var

    @torch.no_grad()
    def _update_running(self, mean: torch.Tensor, var: torch.Tensor,
                        count: torch.Tensor) -> None:
        m = self.momentum
        unbias = count / torch.clamp(count - 1.0, min=1.0)
        self.running_mean.mul_(1 - m).add_(m * mean.to(
            self.running_mean.dtype))
        self.running_var.mul_(1 - m).add_(m * (var * unbias).to(
            self.running_var.dtype))


class MLP(nn.Module):
    """``build_mlp``: ``dims`` = [in, hidden..., out]; activation (and
    optional masked BN) after every layer, the last only when
    ``final_nonlinearity``. Linears are kaiming-normal initialised."""

    def __init__(self, dims: Sequence[int], activation: str = "relu",
                 batch_norm: str = "none", final_nonlinearity: bool = True):
        super().__init__()
        n = len(dims) - 1
        self.act = relu if activation == "relu" else get_activation(activation)
        self.final_nonlinearity = final_nonlinearity
        self.layers = nn.ModuleList(
            nn.Linear(dims[i], dims[i + 1]) for i in range(n))
        n_act = n if final_nonlinearity else n - 1
        self.bns = nn.ModuleList(
            MaskedBatchNorm(dims[i + 1]) for i in range(n_act)
            if batch_norm == "batch")

    def init_params(self, gen: torch.Generator) -> None:
        for lin in self.layers:
            linear_init_(lin, 2.0, gen)

    def forward(self, x: torch.Tensor,
                weights: Optional[torch.Tensor] = None) -> torch.Tensor:
        n = len(self.layers)
        for i, lin in enumerate(self.layers):
            x = lin(x)
            if i < n - 1 or self.final_nonlinearity:
                if len(self.bns):
                    x = self.bns[i](x, weights)
                x = self.act(x)
        return x


class ResnetBlock(nn.Module):
    """pix2pixHD block: reflect-pad 3x3 conv -> instance norm -> ReLU ->
    reflect-pad 3x3 conv -> instance norm, plus the skip (NCHW)."""

    def __init__(self, features: int):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3)
        self.conv2 = nn.Conv2d(features, features, 3)

    def init_params(self, gen: torch.Generator) -> None:
        conv_init_gan_(self.conv1, gen)
        conv_init_gan_(self.conv2, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = relu(instance_norm(self.conv1(reflect_pad_2d(x, 1))))
        h = instance_norm(self.conv2(reflect_pad_2d(h, 1)))
        return x + h


class CNN(nn.Module):
    """``build_cnn`` for conv-only archs with 'valid' padding, such as the
    appearance encoder's and D_obj's 'C4-64-2,C4-128-2,C4-256-2': each
    'CK-X[-S]' is a KxK conv with X channels and stride S; every conv but
    the first is preceded by normalization and activation. Convs are
    lecun-normal initialised (flax's default). ``pooling`` is the kind of
    the DSL's 'P' layers, which are not ported yet (no default arch has
    one); ``dtype`` is the convs' compute dtype (``conv_in``)."""

    def __init__(self, arch: str, in_channels: int,
                 normalization: str = "batch", activation: str = "relu",
                 padding: str = "valid", pooling: str = "max",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if pooling not in ("max", "avg"):
            raise ValueError(f"unknown pooling '{pooling}'")
        self.pooling = pooling
        self.dtype = dtype
        specs = [s for s in arch.split(",") if not s.startswith("I")]
        if any(s[0] != "C" for s in specs) or padding != "valid":
            raise NotImplementedError(
                f"only conv-only archs with 'valid' padding are ported (got "
                f"'{arch}', '{padding}')")
        if normalization not in ("batch", "instance", "none"):
            raise ValueError(f"unknown normalization '{normalization}'")
        self.normalization = normalization
        self.act = get_activation(activation)
        convs, bns = [], []
        ch = in_channels
        for j, s in enumerate(specs):
            vals = [int(v) for v in s[1:].split("-")]
            k, feat = vals[0], vals[1]
            stride = vals[2] if len(vals) == 3 else 1
            if j > 0 and normalization == "batch":
                bns.append(MaskedBatchNorm(ch))
            convs.append(nn.Conv2d(ch, feat, k, stride=stride))
            ch = feat
        self.convs = nn.ModuleList(convs)
        self.bns = nn.ModuleList(bns)
        self.out_channels = ch

    def init_params(self, gen: torch.Generator) -> None:
        for conv in self.convs:
            lecun_conv_(conv, gen)

    def forward(self, x: torch.Tensor,
                weights: Optional[torch.Tensor] = None) -> torch.Tensor:
        for j, conv in enumerate(self.convs):
            if j > 0:
                if self.normalization == "batch":
                    x = self.bns[j - 1](x, weights)
                elif self.normalization == "instance":
                    x = instance_norm(x)
                x = self.act(x)
            x = conv_in(conv, x, self.dtype)
        return x
