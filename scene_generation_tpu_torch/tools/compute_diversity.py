"""Diversity (port of the JAX package's ``scripts/compute_diversity.py``;
reference protocol #3, README.md:81 -> richzhang/PerceptualSimilarity):
mean LPIPS distance between two images generated from the same scene
graph with independently drawn appearance clusters.

    python -m scene_generation_tpu_torch.tools.compute_diversity \\
        --output_dir <run> --features_path <dir>/features_clustered_100.npy \\
        --coco_dir <coco> [--num_samples 64] [--out_json d.json] [--cpu]

Without VGG16 / LPIPS-lin weights the distance runs on seeded random
features with uniform lin weights: values are then relative only
(``pretrained: false``), and ``diversity_over_between_scene`` (against
the LPIPS between different scenes) is the unitless figure.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from scene_generation_tpu_torch.api import InferenceModel
from scene_generation_tpu_torch.metrics_lpips import create_lpips_fn
from scene_generation_tpu_torch.tools import device_of
from scene_generation_tpu_torch.tools.sample_images import build_loader


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--output_dir", default="output")
    p.add_argument("--checkpoint_name", default="checkpoint")
    p.add_argument("--best", type=int, default=0)
    p.add_argument("--features_path", default=None)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--num_samples", type=int, default=64)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--coco_dir", default="datasets/coco")
    p.add_argument("--sample_attributes", type=int, default=0)
    p.add_argument("--test_part", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out_json", default=None)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the kernels' plain versions)")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    a = parse_args(argv)
    model = InferenceModel.from_checkpoint(
        a.output_dir, a.checkpoint_name, best=bool(a.best),
        features_path=a.features_path, device=device_of(a))
    loader = build_loader(model, a)
    lpips_fn, loaded = create_lpips_fn(model.device)
    if not loaded:
        print("WARNING: no VGG16/LPIPS weights found; diversity values are "
              "relative-only (random-feature LPIPS). Install via "
              "scripts/fetch_pretrained.py.")
    rng = np.random.RandomState(a.seed)

    dists, baseline = [], []
    for batch in loader:
        if sum(len(d) for d in dists) >= a.num_samples:
            break
        f1, m1 = model.sample_cluster_features(batch.objs, batch.obj_mask,
                                               rng)
        f2, m2 = model.sample_cluster_features(batch.objs, batch.obj_mask,
                                               rng)
        out1 = model.forward_batch(batch, features=f1, features_mask=m1)
        out2 = model.forward_batch(batch, features=f2, features_mask=m2)
        dists.append(lpips_fn(out1.imgs_pred, out2.imgs_pred))
        # Between different scenes: the scale anchor of the relative-only
        # fallback.
        baseline.append(lpips_fn(out1.imgs_pred,
                                 torch.roll(out1.imgs_pred, 1, 0)))
    dists = torch.cat(dists).cpu().numpy()[:a.num_samples].astype(np.float64)
    baseline = torch.cat(baseline).cpu().numpy()[:a.num_samples].astype(
        np.float64)
    result = {"diversity_lpips_mean": float(dists.mean()),
              "diversity_lpips_std": float(dists.std()),
              "between_scene_lpips_mean": float(baseline.mean()),
              "diversity_over_between_scene": float(
                  dists.mean() / max(baseline.mean(), 1e-12)),
              "n": int(dists.size), "pretrained": bool(loaded)}
    print(json.dumps(result))
    if a.out_json:
        with open(a.out_json, "w") as f:
            json.dump(result, f)
    return result


if __name__ == "__main__":
    main()
