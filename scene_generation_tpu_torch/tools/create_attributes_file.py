"""Per-class size and location attribute histograms (port of the JAX
package's ``scripts/create_attributes_file.py``; reference
``scripts/create_attributes_file.py:111-137``) ->
``attributes_10_25.pickle``, read by the datasets' attribute-sampling mode.

    python -m scene_generation_tpu_torch.tools.create_attributes_file \\
        --coco_dir <coco> [--num_samples 128] \
        [--save_path models/attributes_10_25.pickle]

Host-only (numpy): it runs no model.
"""
from __future__ import annotations

import argparse
import os
import pickle
from collections import defaultdict

import numpy as np

from scene_generation_tpu_torch.config import Config
from scene_generation_tpu_torch.data.coco import coco_split
from scene_generation_tpu_torch.data.synthetic import SyntheticDataset


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--coco_dir", default="datasets/coco")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--num_samples", type=int, default=None)
    p.add_argument("--save_path", default="models/attributes_10_25.pickle")
    p.add_argument("--size_attribute_len", type=int, default=10)
    p.add_argument("--grid_size", type=int, default=25)
    p.add_argument("--image_size", type=str, default="128,128")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    a = parse_args(argv)
    if a.synthetic:
        dset = SyntheticDataset(Config(), size=a.num_samples or 128)
    else:
        size = tuple(int(x) for x in a.image_size.split(","))
        dset = coco_split(a.coco_dir, "train", image_size=size,
                          max_samples=a.num_samples,
                          size_attribute_len=a.size_attribute_len,
                          grid_size=a.grid_size)
    names = dset.vocab["my_idx_to_obj"]
    size_hist = defaultdict(lambda: np.zeros(a.size_attribute_len))
    loc_hist = defaultdict(lambda: np.zeros(a.grid_size))
    n = len(dset)
    for i in range(n):
        ex = dset[i]
        for j in range(len(ex.objs)):
            cls = int(ex.objs[j])
            if cls == 0:
                continue
            size_hist[names[cls]] += ex.attributes[j, :a.size_attribute_len]
            loc_hist[names[cls]] += ex.attributes[j, a.size_attribute_len:]

    # Laplace-smoothed, so that sampling never sees an all-zero histogram.
    attributes = {
        "size": {k: (v + 1).tolist() for k, v in size_hist.items()},
        "location": {k: (v + 1).tolist() for k, v in loc_hist.items()},
    }
    os.makedirs(os.path.dirname(a.save_path) or ".", exist_ok=True)
    with open(a.save_path, "wb") as f:
        pickle.dump(attributes, f)
    print(f"wrote {a.save_path} ({len(size_hist)} classes over {n} images)")
    return attributes


if __name__ == "__main__":
    main()
