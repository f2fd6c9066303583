"""FID between two directories of PNG images (port of the JAX package's
``scripts/compute_fid.py``, its replacement of the TTUR script the
reference README points at, README.md:77-79).

    python -m scene_generation_tpu_torch.tools.compute_fid \\
        --real_dir <gt pngs> --fake_dir <samples> [--out_json f.json] [--cpu]

Images are read with ``decode_png`` and resized to 299x299 by PIL's
bicubic filter, rebuilt in numpy (``resize_bicubic``: the same
coefficients and the same 8-bit fixed-point rounding), so the arrays equal
the JAX script's; features are InceptionV3's pool3 or, without its
weights, the shallow random CNN (``metrics_fid.py``).
"""
from __future__ import annotations

import argparse
import functools
import json
import os
from typing import Iterator, Tuple

import numpy as np

from scene_generation_tpu_torch.data.image_utils import read_png
from scene_generation_tpu_torch.metrics_fid import FIDAccumulator
from scene_generation_tpu_torch.tools import device_of

_PRECISION_BITS = 22          # PIL's 8-bit resample: 32 - 8 - 2


def _bicubic(x: np.ndarray) -> np.ndarray:
    """PIL's bicubic kernel (a = -0.5)."""
    a, x = -0.5, np.abs(x)
    return np.where(x < 1, ((a + 2) * x - (a + 3)) * x * x + 1,
                    np.where(x < 2, (((x - 5) * x + 8) * x - 4) * a, 0.0))


@functools.lru_cache(maxsize=8)
def _pil_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) int64 fixed-point weights of one PIL resample pass
    (``precompute_coeffs`` + ``normalize_coeffs_8bpc``)."""
    scale = n_in / n_out
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    w = np.zeros((n_out, n_in), np.float64)
    for xx in range(n_out):
        center = (xx + 0.5) * scale
        lo = max(int(center - support + 0.5), 0)
        hi = min(int(center + support + 0.5), n_in)
        k = _bicubic((np.arange(lo, hi) - center + 0.5) / filterscale)
        w[xx, lo:hi] = k / k.sum() if k.sum() != 0 else k
    fixed = w * (1 << _PRECISION_BITS)
    return np.trunc(np.where(fixed < 0, fixed - 0.5, fixed + 0.5)).astype(
        np.int64)


def _pass(img: np.ndarray, weights: np.ndarray, axis: int) -> np.ndarray:
    x = np.moveaxis(img, axis, -1).astype(np.int64)
    acc = x @ weights.T + (1 << (_PRECISION_BITS - 1))
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, -1, axis)


def resize_bicubic(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """(H, W, C) uint8 -> (size[0], size[1], C): ``PIL.Image.resize``
    with its default bicubic filter, horizontal pass first."""
    h, w = size
    if img.shape[1] != w:
        img = _pass(img, _pil_weights(img.shape[1], w), 1)
    if img.shape[0] != h:
        img = _pass(img, _pil_weights(img.shape[0], h), 0)
    return img


def iter_image_batches(directory: str, batch_size: int,
                       size=(299, 299)) -> Iterator[np.ndarray]:
    """Batches (B, size, 3) float32 in [-1, 1] of the directory's images in
    name order (PNG only: the reader is ``decode_png``)."""
    files = sorted(f for f in os.listdir(directory)
                   if f.lower().endswith((".png", ".jpg", ".jpeg")))
    batch = []
    for f in files:
        arr = resize_bicubic(read_png(os.path.join(directory, f)), size)
        batch.append(arr.astype(np.float32) / 255.0 * 2.0 - 1.0)
        if len(batch) == batch_size:
            yield np.stack(batch)
            batch = []
    if batch:
        yield np.stack(batch)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--real_dir", required=True)
    p.add_argument("--fake_dir", required=True)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU")
    p.add_argument("--out_json", default=None)
    a = p.parse_args(argv)

    fid = FIDAccumulator(device=device_of(a))
    n_real = n_fake = 0
    for batch in iter_image_batches(a.real_dir, a.batch_size):
        fid.add_real(batch)
        n_real += len(batch)
    for batch in iter_image_batches(a.fake_dir, a.batch_size):
        fid.add_fake(batch)
        n_fake += len(batch)
    score = fid.compute()
    print(f"FID({n_real} real, {n_fake} fake) = {score:.4f}")
    result = {"fid": score, "n_real": n_real, "n_fake": n_fake}
    if a.out_json:
        with open(a.out_json, "w") as f:
            json.dump(result, f)
    return result


if __name__ == "__main__":
    main()
