"""A COCO directory written by the fake-COCO generator (port of the JAX
package's ``scripts/make_fake_coco_dir.py``), in the layout a real COCO
download has and the train CLI and the tools read with ``--coco_dir``:

    <root>/images/{train,val}2017/*.{jpg,png}
    <root>/annotations/{instances,stuff,panoptic}_{train,val}2017.json
    <root>/annotations/panoptic_coco_categories.json
    <root>/panoptic/annotations/panoptic_{train,val}2017/*.png

    python -m scene_generation_tpu_torch.tools.make_fake_coco_dir \\
        --root /tmp/fake_coco [--num_train 96] [--num_val 24] \\
        [--size 480,360] [--image_format png]

The annotations and pixels are the JAX generator's for the same seeds
(0 for train, 1 for val). ``--image_format jpg`` (the default) writes
JPEGs through PIL, as the JAX script does; ``png`` writes PNGs, which the
readers decode without PIL.
"""
from __future__ import annotations

import argparse
import os
import shutil

from scene_generation_tpu_torch.data.fake_coco import make_fake_coco


def build(root: str, num_train: int, num_val: int, size,
          image_format: str = "jpg") -> None:
    ann = os.path.join(root, "annotations")
    os.makedirs(ann, exist_ok=True)
    for split, n, seed in (("train2017", num_train, 0),
                           ("val2017", num_val, 1)):
        tmp = os.path.join(root, f"_tmp_{split}")
        paths = make_fake_coco(tmp, num_images=n, image_size=size, seed=seed,
                               image_format=image_format)
        moves = {
            paths["image_dir"]: os.path.join(root, "images", split),
            paths["panoptic_dir"]: os.path.join(
                root, "panoptic", "annotations", f"panoptic_{split}"),
            paths["instances_json"]: os.path.join(
                ann, f"instances_{split}.json"),
            paths["stuff_json"]: os.path.join(ann, f"stuff_{split}.json"),
            paths["panoptic_json"]: os.path.join(
                ann, f"panoptic_{split}.json"),
            paths["panoptic_categories"]: os.path.join(
                ann, "panoptic_coco_categories.json"),
        }
        for src, dst in moves.items():
            if os.path.isdir(dst):
                shutil.rmtree(dst)
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            shutil.move(src, dst)
        shutil.rmtree(tmp)
    print(f"fake COCO layout ready under {root}: "
          f"{num_train} train / {num_val} val images ({image_format})")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", required=True)
    p.add_argument("--num_train", type=int, default=96)
    p.add_argument("--num_val", type=int, default=24)
    p.add_argument("--size", default="480,360",
                   help="on-disk image size W,H")
    p.add_argument("--image_format", choices=("jpg", "png"), default="jpg")
    a = p.parse_args(argv)
    w, h = (int(x) for x in a.size.split(","))
    build(a.root, a.num_train, a.num_val, (w, h), a.image_format)


if __name__ == "__main__":
    main()
