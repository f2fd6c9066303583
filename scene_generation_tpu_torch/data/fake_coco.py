"""A tiny COCO-format dataset on disk for hermetic tests and runs (port of
the JAX package's ``data/fake_coco.py``): images, instances / stuff JSONs
with polygon, uncompressed-RLE and compressed-RLE segmentations, and the
panoptic variant (segments_info and id-coloured PNGs).
"""
from __future__ import annotations

import json
import os
from typing import Tuple

import numpy as np

from scene_generation_tpu_torch.data.image_utils import write_png
from scene_generation_tpu_torch.data.rle import encode_counts_py

INSTANCE_CATEGORIES = [
    {"id": 1, "name": "person"}, {"id": 2, "name": "car"},
    {"id": 3, "name": "dog"},
]
STUFF_CATEGORIES = [
    {"id": 101, "name": "sky"}, {"id": 102, "name": "grass"},
    {"id": 103, "name": "other"},
]


def _compress_counts(counts) -> str:
    out = []
    for i, x in enumerate(counts):
        if i > 2:
            x -= counts[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = (x != -1) if (c & 0x10) else (x != 0)
            if more:
                c |= 0x20
            out.append(chr(c + 48))
    return "".join(out)


def _write_image(path: str, arr: np.ndarray) -> None:
    if path.endswith(".png"):
        write_png(path, arr)
        return
    import PIL.Image          # JPEG only: PNG needs no PIL
    PIL.Image.fromarray(arr).save(path)


def make_fake_coco(root: str, num_images: int = 8,
                   image_size: Tuple[int, int] = (96, 96),
                   seed: int = 0, image_format: str = "jpg") -> dict:
    """Write images + annotation JSONs under ``root``; return paths.

    ``image_format`` "jpg" writes the JPEGs of the JAX package's generator
    (through PIL), "png" the same pixels as PNG (``encode_png``, no PIL);
    the JSONs name the files with that extension. The annotations are the
    JAX generator's for the same seed."""
    if image_format not in ("jpg", "png"):
        raise ValueError(f"image_format {image_format!r}: 'jpg' or 'png'")
    rng = np.random.RandomState(seed)
    img_dir = os.path.join(root, "images")
    ann_dir = os.path.join(root, "annotations")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(ann_dir, exist_ok=True)
    W, H = image_size

    images, inst_anns, stuff_anns = [], [], []
    ann_id = 1
    for iid in range(1, num_images + 1):
        fname = f"{iid:06d}.{image_format}"
        arr = (rng.rand(H, W, 3) * 255).astype(np.uint8)
        _write_image(os.path.join(img_dir, fname), arr)
        images.append({"id": iid, "file_name": fname, "width": W,
                       "height": H})

        n_inst = rng.randint(2, 4)
        for k in range(n_inst):
            bw = rng.randint(W // 5, W // 2)
            bh = rng.randint(H // 5, H // 2)
            x = rng.randint(0, W - bw)
            y = rng.randint(0, H - bh)
            cat = int(rng.choice([c["id"] for c in INSTANCE_CATEGORIES]))
            style = k % 3
            if style == 0:  # polygon rectangle
                seg = [[float(x), float(y), float(x + bw), float(y),
                        float(x + bw), float(y + bh), float(x), float(y + bh)]]
            else:
                mask = np.zeros((H, W), np.uint8)
                mask[y:y + bh, x:x + bw] = 1
                counts = encode_counts_py(mask)
                if style == 1:  # uncompressed RLE
                    seg = {"counts": counts, "size": [H, W]}
                else:           # compressed RLE string
                    seg = {"counts": _compress_counts(counts),
                           "size": [H, W]}
            inst_anns.append({
                "id": ann_id, "image_id": iid, "category_id": cat,
                "bbox": [float(x), float(y), float(bw), float(bh)],
                "segmentation": seg, "area": float(bw * bh), "iscrowd": 0})
            ann_id += 1

        # One stuff region per image so stuff_only keeps every image.
        cat = int(rng.choice([c["id"] for c in STUFF_CATEGORIES[:2]]))
        bw, bh = W // 2, H // 3
        x, y = rng.randint(0, W - bw), rng.randint(0, H - bh)
        mask = np.zeros((H, W), np.uint8)
        mask[y:y + bh, x:x + bw] = 1
        stuff_anns.append({
            "id": ann_id, "image_id": iid, "category_id": cat,
            "bbox": [float(x), float(y), float(bw), float(bh)],
            "segmentation": {"counts": encode_counts_py(mask),
                             "size": [H, W]},
            "area": float(bw * bh), "iscrowd": 0})
        ann_id += 1

    # --- panoptic variant: segments_info + id-colored PNGs ---
    pan_dir = os.path.join(root, "panoptic")
    os.makedirs(pan_dir, exist_ok=True)
    pan_images, pan_anns = [], []
    pan_categories = (
        [{"id": c["id"], "name": c["name"], "isthing": 1}
         for c in INSTANCE_CATEGORIES]
        + [{"id": c["id"], "name": c["name"], "isthing": 0}
           for c in STUFF_CATEGORIES])
    rng2 = np.random.RandomState(seed + 1)
    for img in images:
        iid = img["id"]
        seg_png = np.zeros((H, W, 3), np.uint8)
        segments = []
        for k in range(rng2.randint(2, 4)):
            sid = iid * 100 + k + 1
            bw = rng2.randint(W // 4, W // 2)
            bh = rng2.randint(H // 4, H // 2)
            x = rng2.randint(0, W - bw)
            y = rng2.randint(0, H - bh)
            seg_png[y:y + bh, x:x + bw] = [sid % 256, (sid // 256) % 256,
                                           sid // 65536]
            cat = int(rng2.choice([c["id"] for c in pan_categories[:4]]))
            segments.append({"id": sid, "category_id": cat,
                             "area": int(bw * bh),
                             "bbox": [float(x), float(y), float(bw),
                                      float(bh)], "iscrowd": 0})
        fname = img["file_name"][:-3] + "png"
        write_png(os.path.join(pan_dir, fname), seg_png)
        pan_images.append(img)
        pan_anns.append({"image_id": iid, "file_name": fname,
                         "segments_info": segments})
    pan_json = os.path.join(ann_dir, "panoptic.json")
    with open(pan_json, "w") as f:
        json.dump({"images": pan_images, "annotations": pan_anns,
                   "categories": pan_categories}, f)
    pan_cat_json = os.path.join(ann_dir, "panoptic_categories.json")
    with open(pan_cat_json, "w") as f:
        json.dump(pan_categories, f)

    inst_json = os.path.join(ann_dir, "instances.json")
    stuff_json = os.path.join(ann_dir, "stuff.json")
    with open(inst_json, "w") as f:
        json.dump({"images": images, "annotations": inst_anns,
                   "categories": INSTANCE_CATEGORIES}, f)
    with open(stuff_json, "w") as f:
        json.dump({"images": images, "annotations": stuff_anns,
                   "categories": STUFF_CATEGORIES}, f)
    return {"image_dir": img_dir, "instances_json": inst_json,
            "stuff_json": stuff_json, "panoptic_json": pan_json,
            "panoptic_categories": pan_cat_json, "panoptic_dir": pan_dir}
