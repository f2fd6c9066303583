"""Frechet Inception Distance (port of the JAX package's
``metrics_fid.py``; the reference computes FID out of repo with the TTUR
script, README.md:77-79): InceptionV3 pool3 (2048-d) statistics and

    FID = |mu_x - mu_y|^2 + Tr(Sx + Sy - 2 (Sx Sy)^{1/2}).

    fid = FIDAccumulator(device="cuda")
    fid.add_real(real_imgs); fid.add_fake(fake_imgs)   # [-1, 1] NHWC
    score = fid.compute()

Without InceptionV3 weights the features come from a shallow random CNN
drawn from a seed (``create_shallow_features_fn``), and values compare
only within one run, as in the JAX package.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from scene_generation_tpu_torch import resolve_device


def frechet_distance(mu1: np.ndarray, sigma1: np.ndarray, mu2: np.ndarray,
                     sigma2: np.ndarray, eps: float = 1e-6) -> float:
    """Frechet distance between two Gaussians (numerically guarded sqrtm;
    ``sqrtm`` without ``disp``, which newer SciPy removed)."""
    import scipy.linalg

    diff = mu1 - mu2
    covmean = scipy.linalg.sqrtm(sigma1 @ sigma2)
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = scipy.linalg.sqrtm(
            (sigma1 + offset) @ (sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2)
                 - 2 * np.trace(covmean))


def _stats(feats: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    return feats.mean(axis=0), np.cov(feats, rowvar=False)


SHALLOW_CHANNELS = (3, 64, 128, 256, 512)


def _conv_same_s2(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A 3x3 stride-2 conv with XLA's 'SAME' padding (the extra row and
    column, where there is one, at the bottom and right)."""
    pads = []
    for size in (x.shape[-1], x.shape[-2]):
        total = max((-(-size // 2) - 1) * 2 + 3 - size, 0)
        pads += [total // 2, total - total // 2]
    return F.conv2d(F.pad(x, pads), w, stride=2)


def create_shallow_features_fn(seed: int = 0, device=None,
                               kernels: Optional[Sequence[torch.Tensor]]
                               = None) -> Callable:
    """The fixed-seed shallow random-CNN extractor (the fallback without
    InceptionV3 weights; JAX ``metrics_fid.py:46-84``): four 3x3 stride-2
    He-init convs (3 -> 64 -> 128 -> 256 -> 512) with leaky ReLU 0.2, each
    layer's mean-pooled output concatenated into a 960-d descriptor.
    ``kernels`` (OIHW; ``convert.shallow_kernels_from_jax``) replaces the
    draw from ``torch.Generator().manual_seed(seed)``."""
    dev = resolve_device(device)
    if kernels is None:
        gen = torch.Generator().manual_seed(seed)
        kernels = [torch.randn((cout, cin, 3, 3), generator=gen)
                   * (2.0 / (9 * cin)) ** 0.5
                   for cin, cout in zip(SHALLOW_CHANNELS,
                                        SHALLOW_CHANNELS[1:])]
    kernels = [k.to(dev, torch.float32) for k in kernels]

    @torch.no_grad()
    def features_fn(imgs) -> torch.Tensor:
        x = torch.as_tensor(imgs).to(dev, torch.float32).permute(0, 3, 1, 2)
        taps = []
        for w in kernels:
            x = F.leaky_relu(_conv_same_s2(x, w), 0.2)
            taps.append(x.mean((2, 3)))
        return torch.cat(taps, -1)

    return features_fn


class FIDAccumulator:
    """Streams real and fake batches through InceptionV3 pool3 features
    (or the shallow fallback, with the JAX package's warning)."""

    def __init__(self, features_fn: Optional[Callable] = None, device=None):
        if features_fn is None:
            from scene_generation_tpu_torch.models.inception import (
                _torch_checkpoint_path, create_inception_features_fn)
            if _torch_checkpoint_path() is None:
                print("[metrics_fid] WARNING: no InceptionV3 weights; "
                      "falling back to a shallow fixed-seed random-CNN "
                      "extractor — FID values are relative-only")
                features_fn = create_shallow_features_fn(device=device)
            else:
                features_fn, loaded = create_inception_features_fn(device)
                if not loaded:
                    print("[metrics_fid] WARNING: InceptionV3 weight file "
                          "found but not loadable; using the shallow "
                          "random-CNN fallback")
                    features_fn = create_shallow_features_fn(device=device)
        self.features_fn = features_fn
        self._real: List[np.ndarray] = []
        self._fake: List[np.ndarray] = []

    def _features(self, imgs) -> np.ndarray:
        f = self.features_fn(imgs)
        if isinstance(f, torch.Tensor):
            f = f.detach().cpu().numpy()
        return np.asarray(f, np.float64)

    def add_real(self, imgs) -> None:
        self._real.append(self._features(imgs))

    def add_fake(self, imgs) -> None:
        self._fake.append(self._features(imgs))

    def compute(self) -> float:
        real = np.concatenate(self._real)
        fake = np.concatenate(self._fake)
        if len(real) < 2 or len(fake) < 2:
            raise ValueError("need >= 2 samples on each side for FID")
        return frechet_distance(*_stats(real), *_stats(fake))
