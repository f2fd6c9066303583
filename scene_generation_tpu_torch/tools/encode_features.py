"""Builds the appearance dictionary offline (port of the JAX package's
``scripts/encode_features.py``; reference ``scripts/encode_features.py``).

    python -m scene_generation_tpu_torch.tools.encode_features \\
        --output_dir <run> --coco_dir <coco> [--num_samples 512] [--cpu]

Crops every object of the dataset at ``object_size`` (the crop forward
kernel on the card), encodes ``repr_net(image_encoder(crop))`` into a
per-class feature matrix saved as ``features.npy``, then clusters each
class with k in {100, 10, 1} (``cluster.py``, on the same device) into
``features_clustered_{100,010,001}.npy``: the files that sampling and the
GUI read (``InferenceModel.from_checkpoint(features_path=)``).

Every image is encoded: the loader keeps the last, partial batch (the JAX
script drops it).
"""
from __future__ import annotations

import argparse
import os
from collections import defaultdict
from typing import Dict

import numpy as np
import torch

from scene_generation_tpu_torch.api import InferenceModel
from scene_generation_tpu_torch.cluster import cluster
from scene_generation_tpu_torch.data.loader import DataLoader
from scene_generation_tpu_torch.data.synthetic import SyntheticDataset
from scene_generation_tpu_torch.ops.crop import crop_bbox_batch
from scene_generation_tpu_torch.ops.images import wire_to_float
from scene_generation_tpu_torch.tools import (checkpoint_coco_dataset,
                                              device_of)

TABLES = ((100, "100"), (10, "010"), (1, "001"))


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--output_dir", default="output")
    p.add_argument("--checkpoint_name", default="checkpoint")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--num_samples", type=int, default=None)
    p.add_argument("--save_dir", default=None,
                   help="defaults to <output_dir>")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--coco_dir", default="datasets/coco")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the kernels' plain versions)")
    return p.parse_args(argv)


@torch.no_grad()
def encode(model: InferenceModel, loader) -> Dict[int, np.ndarray]:
    """class -> (count, rep_size) float32 appearance vectors of every real
    object of ``loader``'s batches: crops of the f32 images at
    ``object_size``, encoded in the model's dtype."""
    s = model.cfg.model.object_size
    dtype = next(model.model.parameters()).dtype
    by_class = defaultdict(list)
    for batch in loader:
        n, o = batch.objs.shape
        imgs, boxes, obj_mask = (torch.as_tensor(a, device=model.device)
                                 for a in (batch.imgs, batch.boxes,
                                           batch.obj_mask))
        crops = crop_bbox_batch(wire_to_float(imgs), boxes, s)
        weights = obj_mask.to(dtype).reshape(n * o)
        enc = model.model.encode_crops(
            crops.reshape(n * o, s, s, 3).to(dtype), weights)
        enc = enc.float().cpu().numpy().reshape(n, o, -1)
        for i, j in zip(*np.nonzero(batch.obj_mask > 0)):
            by_class[int(batch.objs[i, j])].append(enc[i, j])
    return {c: np.stack(v) for c, v in by_class.items()}


def main(argv=None) -> Dict[int, np.ndarray]:
    a = parse_args(argv)
    model = InferenceModel.from_checkpoint(a.output_dir, a.checkpoint_name,
                                           device=device_of(a))
    cfg = model.cfg
    if a.synthetic:
        dset = SyntheticDataset(cfg, size=a.num_samples or 64, seed=a.seed)
    else:
        # The train split, filtered by the checkpoint's data config (the
        # reference reads checkpoint_args, encode_features.py:44-47), so
        # the dictionary covers the objects the repr space trained on.
        dset = checkpoint_coco_dataset(model, a, "train")
    loader = DataLoader(dset, batch_size=a.batch_size,
                        max_objs=cfg.data.max_objs,
                        max_triples=cfg.data.max_triples, shuffle=False,
                        drop_last=False)
    features = encode(model, loader)
    save_dir = a.save_dir or a.output_dir
    os.makedirs(save_dir, exist_ok=True)
    np.save(os.path.join(save_dir, "features.npy"), features,
            allow_pickle=True)
    for k, name in TABLES:
        cluster(features, k,
                os.path.join(save_dir, f"features_clustered_{name}.npy"),
                device=model.device)
    print(f"encoded {sum(len(v) for v in features.values())} objects of "
          f"{len(dset)} images; saved features for {len(features)} classes "
          f"to {save_dir}")
    return features


if __name__ == "__main__":
    main()
