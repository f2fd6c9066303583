"""FID between two directories of PNG images (port of the JAX package's
``scripts/compute_fid.py``, its replacement of the TTUR script the
reference README points at, README.md:77-79).

    python -m scene_generation_tpu_torch.tools.compute_fid \\
        --real_dir <gt pngs> --fake_dir <samples> [--out_json f.json] [--cpu]

Images are read with ``decode_png`` and resized to 299x299 by PIL's
bicubic filter, rebuilt in numpy (``image_utils.resize``: the same
coefficients and the same 8-bit fixed-point rounding), so the arrays equal
the JAX script's; features are InceptionV3's pool3 or, without its
weights, the shallow random CNN (``metrics_fid.py``).
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Iterator

import numpy as np

from scene_generation_tpu_torch.data.image_utils import read_png, resize
from scene_generation_tpu_torch.metrics_fid import FIDAccumulator
from scene_generation_tpu_torch.tools import device_of


def iter_image_batches(directory: str, batch_size: int,
                       size=(299, 299)) -> Iterator[np.ndarray]:
    """Batches (B, size, 3) float32 in [-1, 1] of the directory's images in
    name order (PNG only: the reader is ``decode_png``)."""
    files = sorted(f for f in os.listdir(directory)
                   if f.lower().endswith((".png", ".jpg", ".jpeg")))
    batch = []
    for f in files:
        arr = resize(read_png(os.path.join(directory, f)), size, "bicubic")
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
