"""Synthetic scene graphs, frozen for the benchmark.

A copy of ``scene_generation_tpu_torch/data/synthetic.py`` (the example
generator), of ``data/scene_graph.py`` (triples and attributes) and of
``data/batching.py`` (the padded batch), so that a later change to the
program cannot move the traffic the benchmark draws. Only ``Batch`` and the
padded layout are shared with the program: they are its input contract.

Each example has ``min_objects_per_image`` to ``max_objects_per_image`` real
objects (random class, box, rectangle or ellipse, colour) plus the
``__image__`` object, one random-partner geometric triple per real object
and one ``__in_image__`` triple per real object (the reference's
``coco.py:351-416``), size and location attributes, and a uint8 image.
"""
from __future__ import annotations

import math
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np

PREDICATES = ["left of", "right of", "above", "below", "inside", "surrounding"]
PRED_IDX = {name: i + 1 for i, name in enumerate(PREDICATES)}
IN_IMAGE_IDX = 0


class Batch(NamedTuple):
    """The padded batch (field order as the program's ``Batch``)."""
    imgs: np.ndarray          # (N, H, W, 3) uint8
    objs: np.ndarray          # (N, O) int32, 0 = __image__ / pad
    boxes: np.ndarray         # (N, O, 4) float32 [x0, y0, x1, y1]
    masks: np.ndarray         # (N, O, M, M) float32
    triples: np.ndarray       # (N, T, 3) int32 local [s, p, o]
    attributes: np.ndarray    # (N, O, A) float32
    obj_mask: np.ndarray      # (N, O) float32
    triple_mask: np.ndarray   # (N, T) float32


class Example(NamedTuple):
    image: np.ndarray
    objs: np.ndarray
    boxes: np.ndarray
    masks: np.ndarray
    triples: np.ndarray
    attributes: np.ndarray


def geometric_predicate(box_s, box_o, center_s, center_o) -> str:
    sx0, sy0, sx1, sy1 = box_s
    ox0, oy0, ox1, oy1 = box_o
    d = (center_s[0] - center_o[0], center_s[1] - center_o[1])
    theta = math.atan2(d[1], d[0])
    if sx0 < ox0 and sx1 > ox1 and sy0 < oy0 and sy1 > oy1:
        return "surrounding"
    if sx0 > ox0 and sx1 < ox1 and sy0 > oy0 and sy1 < oy1:
        return "inside"
    if theta >= 3 * math.pi / 4 or theta <= -3 * math.pi / 4:
        return "left of"
    if -3 * math.pi / 4 <= theta < -math.pi / 4:
        return "above"
    if -math.pi / 4 <= theta < math.pi / 4:
        return "right of"
    return "below"


def mask_centroid(box, mask: np.ndarray) -> Tuple[float, float]:
    x0, y0, x1, y1 = box
    mh, mw = mask.shape
    sel = mask > 0
    if not sel.any():
        return 0.5 * (x0 + x1), 0.5 * (y0 + y1)
    xs = np.linspace(x0, x1, mw)[None, :].repeat(mh, 0)
    ys = np.linspace(y0, y1, mh)[:, None].repeat(mw, 1)
    return float(xs[sel].mean()), float(ys[sel].mean())


def build_triples(boxes: np.ndarray, centers: np.ndarray,
                  rng: np.random.RandomState) -> np.ndarray:
    o_real = boxes.shape[0]
    triples: List[List[int]] = []
    if o_real > 1:
        for cur in range(o_real):
            choices = [i for i in range(o_real) if i != cur]
            other = choices[rng.randint(len(choices))]
            if rng.rand() > 0.5:
                s, o = cur, other
            else:
                s, o = other, cur
            p = geometric_predicate(boxes[s], boxes[o], centers[s], centers[o])
            triples.append([s, PRED_IDX[p], o])
    for i in range(o_real):
        triples.append([i, IN_IMAGE_IDX, o_real])
    return np.asarray(triples, np.int32).reshape(-1, 3)


def encode_attributes(boxes: np.ndarray, masks: np.ndarray, size_len: int,
                      grid_size: int) -> np.ndarray:
    o_real = boxes.shape[0]
    attrs = np.zeros((o_real + 1, size_len + grid_size), np.float32)
    l_root = grid_size ** 0.5
    for i in range(o_real):
        w = boxes[i, 2] - boxes[i, 0]
        h = boxes[i, 3] - boxes[i, 1]
        attrs[i, min(int(round((size_len - 1) * (w * h))), size_len - 1)] = 1
        cx, cy = mask_centroid(boxes[i], masks[i])
        loc = int(round(cx * (l_root - 1)) + l_root * round(cy * (l_root - 1)))
        attrs[i, size_len + min(max(loc, 0), grid_size - 1)] = 1.0
    attrs[-1, size_len - 1] = 1.0
    attrs[-1, size_len + grid_size // 2] = 1.0
    return attrs


def _shape_mask(shape: int, m: int) -> np.ndarray:
    if shape == 0:
        return np.ones((m, m), np.float32)
    ys, xs = np.mgrid[0:m, 0:m]
    c = (m - 1) / 2
    return (((ys - c) / (m / 2)) ** 2 + ((xs - c) / (m / 2)) ** 2
            <= 1).astype(np.float32)


def _draw_object(img, box, color, shape: int, m: int) -> np.ndarray:
    h, w, _ = img.shape
    x0, y0, x1, y1 = (box * [w, h, w, h]).astype(int)
    x1, y1 = max(x1, x0 + 1), max(y1, y0 + 1)
    mask_m = _shape_mask(shape, m)
    bh, bw = y1 - y0, x1 - x0
    yy = np.clip((np.arange(bh) * m // max(bh, 1)), 0, m - 1)
    xx = np.clip((np.arange(bw) * m // max(bw, 1)), 0, m - 1)
    region = mask_m[np.ix_(yy, xx)][..., None]
    y0c, x0c = max(y0, 0), max(x0, 0)
    y1c, x1c = min(y1, h), min(x1, w)
    region = region[y0c - y0: y0c - y0 + (y1c - y0c),
                    x0c - x0: x0c - x0 + (x1c - x0c)]
    img[y0c:y1c, x0c:x1c] = (img[y0c:y1c, x0c:x1c] * (1 - region)
                             + region * color)
    return mask_m


def _class_color(cls: int, rng: np.random.RandomState) -> np.ndarray:
    base = np.random.RandomState(cls * 7919 + 13).rand(3)
    return np.clip(base + 0.15 * (rng.rand(3) - 0.5), 0.0, 1.0).astype(
        np.float32)


def example(rng: np.random.RandomState, size: int, mask_size: int,
            num_classes: int, min_objs: int, max_objs: int,
            size_len: int = 10, grid_size: int = 25) -> Example:
    """One scene: ``min_objs``..``max_objs`` real objects and __image__."""
    h = w = size
    m = mask_size
    o_real = rng.randint(min_objs, max_objs + 1)
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
        masks.append(_draw_object(img, box, color, rng.randint(2), m))
        objs.append(cls)
        boxes.append(box)
    boxes_arr = np.stack(boxes)
    masks_arr = np.stack(masks)
    centers = np.array([mask_centroid(b, mk)
                        for b, mk in zip(boxes_arr, masks_arr)], np.float32)
    triples = build_triples(boxes_arr, centers, rng)
    attrs = encode_attributes(boxes_arr, masks_arr, size_len, grid_size)
    img = (np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8)
    return Example(
        image=img, objs=np.asarray(objs + [0], np.int32),
        boxes=np.concatenate([boxes_arr, np.array([[0, 0, 1, 1]],
                                                  np.float32)]),
        masks=np.concatenate([masks_arr, np.ones((1, m, m), np.float32)]),
        triples=triples, attributes=attrs)


def collate(examples: Sequence[Example], max_objs: int,
            max_triples: int) -> Batch:
    n = len(examples)
    ex0 = examples[0]
    h, w, _ = ex0.image.shape
    m = ex0.masks.shape[-1]
    a = ex0.attributes.shape[-1]
    imgs = np.empty((n, h, w, 3), ex0.image.dtype)
    objs = np.zeros((n, max_objs), np.int32)
    boxes = np.zeros((n, max_objs, 4), np.float32)
    boxes[..., 2:] = 1.0
    masks = np.zeros((n, max_objs, m, m), np.float32)
    triples = np.zeros((n, max_triples, 3), np.int32)
    attrs = np.zeros((n, max_objs, a), np.float32)
    om = np.zeros((n, max_objs), np.float32)
    tm = np.zeros((n, max_triples), np.float32)
    for i, ex in enumerate(examples):
        o, t = ex.objs.shape[0], ex.triples.shape[0]
        if o > max_objs or t > max_triples:
            raise ValueError(f"{o} objects / {t} triples exceed the padded "
                             f"{max_objs} / {max_triples}")
        imgs[i] = ex.image
        objs[i, :o] = ex.objs
        boxes[i, :o] = ex.boxes
        masks[i, :o] = ex.masks
        triples[i, :t] = ex.triples
        attrs[i, :o] = ex.attributes
        om[i, :o] = 1.0
        tm[i, :t] = 1.0
    return Batch(imgs, objs, boxes, masks, triples, attrs, om, tm)


def batches(seed: int, count: int, batch: int, size: int, mask_size: int,
            num_classes: int, min_objs: int, max_objs: int, max_slots: int,
            max_triples: int) -> List[Batch]:
    """``count`` padded batches of ``batch`` scenes, all drawn from one
    ``RandomState(seed)``."""
    rng = np.random.RandomState(seed)
    return [collate([example(rng, size, mask_size, num_classes, min_objs,
                             max_objs) for _ in range(batch)],
                    max_slots, max_triples) for _ in range(count)]


def cluster_table(seed: int, num_classes: int, clusters: int,
                  rep_size: int) -> np.ndarray:
    """(classes, clusters, rep) appearance cluster centres. The model's
    appearance vectors come out of a ReLU, so the centres are
    non-negative: half-normal, unit scale."""
    rng = np.random.RandomState(seed)
    return np.abs(rng.standard_normal((num_classes, clusters, rep_size))
                  ).astype(np.float32)


def cluster_features(table: np.ndarray, objs: np.ndarray,
                     obj_mask: np.ndarray, rng: np.random.RandomState
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """A random cluster centre per real slot, as ``sample_images`` picks
    one per object; the mask is 1 on every real slot."""
    pick = rng.randint(table.shape[1], size=objs.shape)
    feats = table[objs, pick] * obj_mask[..., None]
    return feats.astype(np.float32), obj_mask.astype(np.float32)
