"""GAN, perceptual and feature-matching losses (port of the JAX package's
``losses.py``).

Every per-object variant takes a validity weight so padded object slots
contribute nothing. Each loss is computed in its inputs' dtype and reduced
in float32 (``_masked_mean``), as in the JAX package; feature maps may be
in any layout, since every reduction runs over all elements and weights
only the leading batch axis.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from scene_generation_tpu_torch.parallel import data_parallel


def _mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` in its dtype; under data parallelism this rank's
    share of the global batch's mean (equal shapes on every rank)."""
    return x.mean() / data_parallel.current().comm.world_size


def _masked_mean(x: torch.Tensor, w: Optional[torch.Tensor]) -> torch.Tensor:
    """``sum(x * w) / max(sum(w), 1)`` in f32, ``w`` broadcast over the
    trailing axes; under data parallelism the denominator is the global
    batch's (``parallel/data_parallel.py``)."""
    x = x.float()
    if w is None:
        return _mean(x)
    total = data_parallel.current().total(w) * (x.numel() // w.numel())
    w = w.reshape(w.shape + (1,) * (x.ndim - w.ndim)).float()
    return (x * w).sum() / torch.clamp(total, min=1.0)


def bce_loss(scores: torch.Tensor, target: torch.Tensor,
             w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Numerically stable BCE with logits."""
    loss = (torch.clamp(scores, min=0.0) - scores * target
            + torch.log1p(torch.exp(-scores.abs())))
    return _masked_mean(loss, w)


def gan_g_loss(scores_fake, w=None):
    return bce_loss(scores_fake, torch.ones_like(scores_fake), w)


def gan_d_loss(scores_real, scores_fake, w=None):
    return (bce_loss(scores_real, torch.ones_like(scores_real), w)
            + bce_loss(scores_fake, torch.zeros_like(scores_fake), w))


def wgan_g_loss(scores_fake, w=None):
    return -_masked_mean(scores_fake, w)


def wgan_d_loss(scores_real, scores_fake, w=None):
    return _masked_mean(scores_fake, w) - _masked_mean(scores_real, w)


def lsgan_g_loss(scores_fake, w=None):
    return _masked_mean(torch.square(torch.sigmoid(scores_fake) - 1.0), w)


def lsgan_d_loss(scores_real, scores_fake, w=None):
    return (_masked_mean(torch.square(torch.sigmoid(scores_real) - 1.0), w)
            + _masked_mean(torch.square(torch.sigmoid(scores_fake)), w))


def get_gan_losses(gan_type: str) -> Tuple[Callable, Callable]:
    """(g_loss(scores_fake, w), d_loss(scores_real, scores_fake, w))."""
    table = {"gan": (gan_g_loss, gan_d_loss),
             "wgan": (wgan_g_loss, wgan_d_loss),
             "lsgan": (lsgan_g_loss, lsgan_d_loss)}
    if gan_type not in table:
        raise ValueError(f'Unrecognized GAN type "{gan_type}"')
    return table[gan_type]


def multiscale_gan_loss(pred: List[List[torch.Tensor]], target_is_real: bool,
                        use_lsgan: bool = True,
                        w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The reference ``GANLoss``: MSE (LSGAN) or BCE of each scale's final
    score map against a constant target, summed over scales."""
    target = 1.0 if target_is_real else 0.0
    loss = 0.0
    for scale in pred:
        s = scale[-1]
        if use_lsgan:
            loss = loss + _masked_mean(torch.square(s - target), w)
        else:
            sw = torch.clamp(s, 1e-7, 1 - 1e-7)
            loss = loss + _masked_mean(
                -(target * torch.log(sw) + (1 - target) * torch.log1p(-sw)),
                w)
    return loss


def feature_matching_loss(pred_fake: List[List[torch.Tensor]],
                          pred_real: List[List[torch.Tensor]],
                          w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Feature-matching L1 over every stage but the score map, weighted
    4/len(stages) per stage and 1/num_D per scale; the real features are
    detached."""
    num_d = len(pred_fake)
    feat_w = 4.0 / len(pred_fake[0])
    d_w = 1.0 / num_d
    loss = 0.0
    for i in range(num_d):
        for j in range(len(pred_fake[i]) - 1):
            diff = torch.abs(pred_fake[i][j] - pred_real[i][j].detach())
            loss = loss + d_w * feat_w * _masked_mean(diff, w)
    return loss


def masked_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                         w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """AC-GAN auxiliary classification loss."""
    logp = F.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    return _masked_mean(nll, w)


def mse_loss(a: torch.Tensor, b: torch.Tensor,
             w: Optional[torch.Tensor] = None) -> torch.Tensor:
    return _masked_mean(torch.square(a - b), w)


def l1_loss(a: torch.Tensor, b: torch.Tensor,
            w: Optional[torch.Tensor] = None) -> torch.Tensor:
    return _masked_mean(torch.abs(a - b), w)


VGG_SLICE_WEIGHTS = (1.0 / 32, 1.0 / 16, 1.0 / 8, 1.0 / 4, 1.0)


def vgg_perceptual_loss(feats_x: Sequence[torch.Tensor],
                        feats_y: Sequence[torch.Tensor]) -> torch.Tensor:
    """Weighted L1 over the five relu_k_1 taps, each a mean in the
    features' dtype (as the JAX package takes it); the target features are
    detached."""
    loss = 0.0
    for wgt, fx, fy in zip(VGG_SLICE_WEIGHTS, feats_x, feats_y):
        loss = loss + wgt * _mean(torch.abs(fx - fy.detach()))
    return loss
