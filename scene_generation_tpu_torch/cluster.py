"""Per-class appearance clusters (port of ``cluster`` in the JAX package's
``scripts/encode_features.py:38-59``, which calls scikit-learn), in torch
on the features' device.

For each class: k-means with k-means++ seeding (scikit-learn's greedy
variant, 2 + log k candidates a centre), Lloyd iterations to a centre
shift of ``1e-4`` times the features' mean variance (at most 300) and
``n_init=10`` restarts run side by side, keeping the lowest inertia;
k = min(n_clusters, the class's sample count). For k > 2 the centres are
ordered by a one-dimensional exact t-SNE (PCA start, perplexity
``min(30, max(2, (k - 1) / 3))``, 250 iterations with the early
exaggeration 12 and momentum 0.5, then 750 at 0.8, scikit-learn's
schedule), all classes of a table in one batch: k <= 100, so the exact
O(k^2) gradient needs no Barnes-Hut tree.

The result cannot equal scikit-learn's bit for bit (another random
stream, another summation order); what it keeps is the k = 1 centre,
which is the class mean, and inertia and an order as good
(``tests/test_torch_cluster.py``).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from scene_generation_tpu_torch import resolve_device

N_INIT = 10
MAX_ITER = 300
TOL = 1e-4
TSNE_ITERS = (250, 750)        # exploration, then the rest
EXAGGERATION = 12.0


def _sq_dists(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Squared distances (..., n, k) between rows of x (n, d) and c
    (..., k, d), by the expanded form, clamped at 0."""
    d = ((x * x).sum(-1)[:, None] - 2 * x @ c.transpose(-1, -2)
         + (c * c).sum(-1)[..., None, :])
    return d.clamp_min_(0)


def _kmeans_pp(x: torch.Tensor, k: int, gen: torch.Generator) -> torch.Tensor:
    """k-means++ seeding of ``N_INIT`` restarts at once: (R, k, d)."""
    n = x.shape[0]
    trials = 2 + int(math.log(k))
    first = torch.randint(n, (N_INIT,), generator=gen).to(x.device)
    draws = torch.rand((max(k - 1, 0), N_INIT, trials),
                       generator=gen, dtype=x.dtype).to(x.device)
    centers = torch.empty((N_INIT, k, x.shape[1]), dtype=x.dtype,
                          device=x.device)
    centers[:, 0] = x[first]
    closest = _sq_dists(x, centers[:, :1])[..., 0]               # (R, n)
    pot = closest.sum(-1)
    for c in range(1, k):
        # Candidates drawn with probability proportional to the distance
        # to the nearest centre; keep the one that lowers the sum most.
        cand = torch.searchsorted(closest.cumsum(-1).contiguous(),
                                  (draws[c - 1] * pot[:, None]).contiguous())
        cand = cand.clamp_max_(n - 1)                            # (R, t)
        dist = torch.minimum(closest[:, None], _sq_dists(x, x[cand]).
                             transpose(-1, -2))                  # (R, t, n)
        best = dist.sum(-1).argmin(-1)                           # (R,)
        rows = torch.arange(N_INIT, device=x.device)
        closest = dist[rows, best]
        pot = closest.sum(-1)
        centers[:, c] = x[cand[rows, best]]
    return centers


def kmeans(x: torch.Tensor, k: int, gen: torch.Generator
           ) -> Tuple[torch.Tensor, float]:
    """(k, d) centres of the lowest-inertia restart, and its inertia, for
    the rows of ``x`` (n, d), k <= n."""
    mean = x.mean(0)
    x = x - mean                 # as scikit-learn, for the expanded form
    tol = TOL * float(x.var(0, unbiased=False).mean())
    centers = _kmeans_pp(x, k, gen)
    rows = torch.arange(N_INIT, device=x.device)[:, None]
    for _ in range(MAX_ITER):
        d = _sq_dists(x, centers)                                # (R, n, k)
        labels = d.argmin(-1)
        onehot = torch.zeros((N_INIT, x.shape[0], k), dtype=x.dtype,
                             device=x.device)
        onehot[rows, torch.arange(x.shape[0], device=x.device), labels] = 1
        counts = onehot.sum(1)                                   # (R, k)
        sums = onehot.transpose(1, 2) @ x
        new = torch.where(counts[..., None] > 0,
                          sums / counts.clamp_min(1)[..., None], centers)
        shift = ((new - centers) ** 2).sum((1, 2))
        done = bool((shift <= tol).all())
        if bool((counts == 0).any()):
            # Empty clusters take the points farthest from their centres.
            far = d.gather(-1, labels[..., None])[..., 0].argsort(
                -1, descending=True)
            for r in range(N_INIT):
                gone = (counts[r] == 0).nonzero()[:, 0]
                new[r, gone] = x[far[r, :len(gone)]]
            done = False
        centers = new
        if done:
            break
    inertia = _sq_dists(x, centers).min(-1).values.sum(-1)       # (R,)
    best = int(inertia.argmin())
    return centers[best] + mean, float(inertia[best])


def _conditional_p(d: torch.Tensor, valid: torch.Tensor,
                   perplexity: torch.Tensor, steps: int = 100
                   ) -> torch.Tensor:
    """Rows of P_{j|i} with entropy log(perplexity) (scikit-learn's
    binary search on the precision beta), batched (B, K, K)."""
    pair = valid[:, :, None] & valid[:, None, :]
    pair &= ~torch.eye(d.shape[-1], dtype=torch.bool, device=d.device)
    target = torch.log(perplexity)[:, None]
    beta = torch.ones(d.shape[:2], dtype=d.dtype, device=d.device)
    lo = torch.full_like(beta, -math.inf)
    hi = torch.full_like(beta, math.inf)
    for _ in range(steps):
        p = torch.where(pair, torch.exp(-d * beta[..., None]), 0)
        sum_p = p.sum(-1).clamp_min(1e-8)
        p = p / sum_p[..., None]
        entropy = torch.log(sum_p) + beta * (d * p).sum(-1)
        up = entropy > target
        lo = torch.where(up, beta, lo)
        hi = torch.where(up, hi, beta)
        beta = torch.where(
            up, torch.where(torch.isinf(hi), beta * 2, (beta + hi) / 2),
            torch.where(torch.isinf(lo), beta / 2, (beta + lo) / 2))
    return p


def tsne_1d(points: List[torch.Tensor]) -> List[torch.Tensor]:
    """A one-dimensional exact t-SNE embedding (K_b,) of each (K_b, d)
    point set, all sets in one padded batch, in float64."""
    dev = points[0].device
    b, kmax = len(points), max(len(p) for p in points)
    dim = points[0].shape[1]
    x = torch.zeros((b, kmax, dim), dtype=torch.float64, device=dev)
    valid = torch.zeros((b, kmax), dtype=torch.bool, device=dev)
    y = torch.zeros((b, kmax), dtype=torch.float64, device=dev)
    for i, p in enumerate(points):
        k = len(p)
        x[i, :k] = p.double()
        valid[i, :k] = True
        # PCA start: the first principal component, sign fixed by its
        # largest entry, scaled to std 1e-4.
        c = x[i, :k] - x[i, :k].mean(0)
        v = torch.linalg.svd(c, full_matrices=False).Vh[0]
        v = v * torch.sign(v[v.abs().argmax()])
        proj = c @ v
        y[i, :k] = proj / proj.std(unbiased=False).clamp_min(1e-12) * 1e-4
    ks = valid.sum(-1).double()
    perplexity = torch.clamp((ks - 1) / 3, min=2.0, max=30.0)
    lr = torch.clamp(ks / EXAGGERATION / 4, min=50.0)[:, None]
    d = (x[:, :, None] - x[:, None]).pow(2).sum(-1)
    p = _conditional_p(d, valid, perplexity)
    p = p + p.transpose(1, 2)
    p = p / p.sum((1, 2), keepdim=True)
    pair = valid[:, :, None] & valid[:, None, :]
    pair &= ~torch.eye(kmax, dtype=torch.bool, device=dev)
    eps = torch.finfo(torch.float64).eps
    p = torch.where(pair, p.clamp_min(eps), 0)
    for phase, (iters, momentum) in enumerate(zip(TSNE_ITERS, (0.5, 0.8))):
        pp = p * EXAGGERATION if phase == 0 else p
        update = torch.zeros_like(y)
        gains = torch.ones_like(y)
        for _ in range(iters):
            diff = y[:, :, None] - y[:, None]
            num = torch.where(pair, 1 / (1 + diff * diff), 0)
            q = (num / num.sum((1, 2), keepdim=True)).clamp_min(eps)
            grad = 4 * ((pp - q) * num * diff).sum(-1)
            grad = torch.where(valid, grad, 0)
            inc = update * grad < 0
            gains = torch.where(inc, gains + 0.2, gains * 0.8).clamp_min(0.01)
            update = momentum * update - lr * gains * grad
            y = y + update
    return [y[i, :len(pts)] for i, pts in enumerate(points)]


def cluster(features: Dict[int, np.ndarray], n_clusters: int,
            save_path: Optional[str] = None, device=None
            ) -> Dict[int, np.ndarray]:
    """Per-class k-means centres, ordered by 1-D t-SNE for k > 2, as a
    dict class -> (k, rep) float32 array; saved with ``np.save`` (the JAX
    package's ``features_clustered_*.npy`` format) when ``save_path`` is
    given. Runs on ``device`` (CUDA when None, as every entry point of
    the package: ``resolve_device``); each class's draws come
    from ``torch.Generator().manual_seed(0)`` (scikit-learn's
    ``random_state=0``)."""
    dev = resolve_device(device)
    centers: Dict[int, torch.Tensor] = {}
    for cls, feats in features.items():
        feats = np.asarray(feats, np.float32)
        if len(feats) == 0:
            continue
        k = min(n_clusters, len(feats))
        gen = torch.Generator().manual_seed(0)
        centers[cls], _ = kmeans(torch.from_numpy(feats).to(dev), k, gen)
    ordered = [c for c in centers if len(centers[c]) > 2]
    if ordered:
        for cls, y in zip(ordered, tsne_1d([centers[c] for c in ordered])):
            centers[cls] = centers[cls][torch.argsort(y, stable=True)]
    out = {cls: c.float().cpu().numpy() for cls, c in centers.items()}
    if save_path is not None:
        np.save(save_path, out, allow_pickle=True)
    return out
