"""Synthetic dataset for hermetic testing and benchmarking (a copy of the
JAX package's ``data/synthetic.py``: the same seed gives the same batch).

Generates images + scene graphs with the exact semantics of the COCO
pipeline (random-partner triples, geometric predicates, __image__ node,
size/location attributes) but from procedurally drawn rectangles/ellipses —
no downloads, no pycocotools. This fills the reference's test-strategy gap
(SURVEY.md §4(c)).
"""
from __future__ import annotations

import functools
from typing import Dict, Optional

import numpy as np

from scene_generation_tpu_torch.config import Config
from scene_generation_tpu_torch.data.batching import Batch, Example, collate
from scene_generation_tpu_torch.data.scene_graph import (
    PREDICATES, build_triples, encode_attributes, mask_centroid)


def synthetic_vocab(num_objs: int = 12) -> Dict:
    """Vocab dict shaped like the reference's (coco.py:92-209)."""
    names = ["__image__"] + [f"class_{i}" for i in range(1, num_objs)]
    return {
        "object_to_idx": {i: i for i in range(num_objs)},
        "object_name_to_idx": {n: i for i, n in enumerate(names)},
        "object_idx_to_name": names,
        "my_idx_to_obj": names,
        "pred_idx_to_name": ["__in_image__"] + PREDICATES,
        "pred_name_to_idx": {n: i for i, n in enumerate(
            ["__in_image__"] + PREDICATES)},
        "num_attributes": 35,
    }


@functools.lru_cache(maxsize=64)
def _shape_mask(shape: int, mask_size: int) -> np.ndarray:
    """Cached M x M template mask (identical values to the inline
    computation it replaced; the host loader is on the critical path)."""
    if shape == 0:  # rectangle
        return np.ones((mask_size, mask_size), np.float32)
    ys, xs = np.mgrid[0:mask_size, 0:mask_size]
    cy, cx = (mask_size - 1) / 2, (mask_size - 1) / 2
    return (((ys - cy) / (mask_size / 2)) ** 2
            + ((xs - cx) / (mask_size / 2)) ** 2 <= 1).astype(np.float32)


def _draw_object(img: np.ndarray, box: np.ndarray, color: np.ndarray,
                 shape: int, mask_size: int) -> np.ndarray:
    """Rasterize a rectangle/ellipse into the image; return its M x M mask."""
    h, w, _ = img.shape
    x0, y0, x1, y1 = (box * [w, h, w, h]).astype(int)
    x1, y1 = max(x1, x0 + 1), max(y1, y0 + 1)
    mask_m = _shape_mask(shape, mask_size)
    # Paint the (resized) mask into the image region.
    bh, bw = y1 - y0, x1 - x0
    yy = np.clip((np.arange(bh) * mask_size // max(bh, 1)), 0, mask_size - 1)
    xx = np.clip((np.arange(bw) * mask_size // max(bw, 1)), 0, mask_size - 1)
    region = mask_m[np.ix_(yy, xx)][..., None]
    y0c, x0c = max(y0, 0), max(x0, 0)
    y1c, x1c = min(y1, h), min(x1, w)
    region = region[y0c - y0: y0c - y0 + (y1c - y0c),
                    x0c - x0: x0c - x0 + (x1c - x0c)]
    img[y0c:y1c, x0c:x1c] = (img[y0c:y1c, x0c:x1c] * (1 - region)
                             + region * color)
    return mask_m


@functools.lru_cache(maxsize=4096)
def _class_base_color(cls: int):
    """RandomState construction is ~0.4ms; the per-class base is fixed, so
    cache it (values identical to the uncached computation)."""
    return np.random.RandomState(cls * 7919 + 13).rand(3)


def _class_color(cls: int, rng: np.random.RandomState,
                 jitter: float = 0.15) -> np.ndarray:
    """Deterministic per-class base color + per-instance jitter: makes the
    class->appearance mapping learnable (meaningful AC loss / IS / accuracy
    trends), while the jitter keeps the appearance encoder's 32-d latent
    informative beyond the class label."""
    base = _class_base_color(cls)
    return np.clip(base + jitter * (rng.rand(3) - 0.5), 0.0, 1.0).astype(
        np.float32)


def synthetic_example(cfg: Config, rng: np.random.RandomState) -> Example:
    dc, mc = cfg.data, cfg.model
    h, w = dc.image_size
    m = dc.mask_size
    num_classes = mc.num_objs
    o_real = rng.randint(dc.min_objects_per_image,
                         dc.max_objects_per_image + 1)
    o_real = min(o_real, dc.max_objs - 1)

    img = np.full((h, w, 3), 0.2, np.float32) \
        + 0.1 * rng.rand(h, w, 3).astype(np.float32)
    objs, boxes, masks = [], [], []
    for _ in range(o_real):
        cls = rng.randint(1, num_classes)
        bw = rng.uniform(0.15, 0.6)
        bh = rng.uniform(0.15, 0.6)
        x0 = rng.uniform(0, 1 - bw)
        y0 = rng.uniform(0, 1 - bh)
        box = np.array([x0, y0, x0 + bw, y0 + bh], np.float32)
        color = _class_color(cls, rng)
        mask = _draw_object(img, box, color, rng.randint(2), m)
        objs.append(cls)
        boxes.append(box)
        masks.append(mask)

    boxes_arr = np.stack(boxes)
    masks_arr = np.stack(masks)
    centers = np.array([mask_centroid(b, mk)
                        for b, mk in zip(boxes_arr, masks_arr)], np.float32)
    triples = build_triples(boxes_arr, centers, rng)
    attrs = encode_attributes(boxes_arr, masks_arr, dc.size_attribute_len,
                              dc.grid_size)

    # Append the __image__ object (coco.py:312-317).
    objs_full = np.asarray(objs + [0], np.int32)
    boxes_full = np.concatenate(
        [boxes_arr, np.array([[0, 0, 1, 1]], np.float32)])
    masks_full = np.concatenate(
        [masks_arr, np.ones((1, m, m), np.float32)])

    # uint8 HWC wire format (see data/image_utils.load_image): device-side
    # wire_to_float maps back to the reference's [-1, 1] convention.
    img = (np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8)
    return Example(image=img, objs=objs_full, boxes=boxes_full,
                   masks=masks_full, triples=triples, attributes=attrs)


def synthetic_batch(cfg: Config, seed: int = 0,
                    batch_size: Optional[int] = None) -> Batch:
    rng = np.random.RandomState(seed)
    n = batch_size or cfg.data.batch_size
    examples = [synthetic_example(cfg, rng) for _ in range(n)]
    return collate(examples, cfg.data.max_objs, cfg.data.max_triples)


class SyntheticDataset:
    """Map-style dataset over procedurally generated scenes: example ``i``
    is drawn from ``RandomState(seed * 100003 + i)``, as in the JAX
    package, so both give the same example for the same (seed, i)."""

    def __init__(self, cfg: Config, size: int = 256, seed: int = 0):
        self.cfg = cfg
        self.size = size
        self.seed = seed
        self.vocab = synthetic_vocab(cfg.model.num_objs)

    def __len__(self) -> int:
        return self.size

    def __getitem__(self, index: int) -> Example:
        rng = np.random.RandomState(self.seed * 100003 + index)
        return synthetic_example(self.cfg, rng)
