"""Scene-graph synthesis rules (host-side, numpy).

The reference builds a random scene graph per epoch from box geometry
(coco.py:351-416): each real object picks one random partner, subject/object
order is a coin flip, and the predicate comes from box containment or the
angle between centers. Plus one __in_image__ edge per real object to the
dummy __image__ node. Attributes: 10-bin size one-hot by box area
(coco.py:296) and a sqrt(grid)-square location one-hot from the mask
centroid (coco.py:347-348).
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np

# Geometric predicates (coco.py:18); vocab prepends __in_image__ (coco.py:206).
PREDICATES = ["left of", "right of", "above", "below", "inside", "surrounding"]
PRED_IDX = {name: i + 1 for i, name in enumerate(PREDICATES)}
IN_IMAGE_IDX = 0


def opposite_of(p: str) -> str:
    """coco.py:489-498 (palindromic predicate list)."""
    order = ["left of", "above", "inside", "surrounding", "below", "right of"]
    return order[-order.index(p) - 1]


def geometric_predicate(box_s: Sequence[float], box_o: Sequence[float],
                        center_s: Sequence[float],
                        center_o: Sequence[float]) -> str:
    """Predicate selection rules (coco.py:368-385)."""
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


def mask_centroid(box: Sequence[float], mask: np.ndarray) -> Tuple[float, float]:
    """Mean position of mask pixels in image coords (coco.py:330-341)."""
    x0, y0, x1, y1 = box
    mh, mw = mask.shape
    sel = mask > 0
    if not sel.any():
        return 0.5 * (x0 + x1), 0.5 * (y0 + y1)
    xs = np.linspace(x0, x1, mw)[None, :].repeat(mh, 0)
    ys = np.linspace(y0, y1, mh)[:, None].repeat(mw, 1)
    return float(xs[sel].mean()), float(ys[sel].mean())


def size_attribute_index(w: float, h: float, size_len: int = 10) -> int:
    """coco.py:296: round((len-1) * area_fraction)."""
    return int(round((size_len - 1) * (w * h)))


def location_attribute_index(cx: float, cy: float, grid_size: int = 25) -> int:
    """coco.py:347: centroid snapped to a sqrt(grid) x sqrt(grid) grid."""
    l_root = grid_size ** 0.5
    idx = round(cx * (l_root - 1)) + l_root * round(cy * (l_root - 1))
    return int(idx)


def build_triples(boxes: np.ndarray, centers: np.ndarray,
                  rng: np.random.RandomState,
                  add_in_image: bool = True) -> np.ndarray:
    """Random-partner triples over real objects + __in_image__ edges.

    Args:
      boxes: (o_real, 4) real-object boxes (excluding __image__).
      centers: (o_real, 2).
    Returns:
      (t, 3) int32 local triples; the __image__ node is index o_real.
    """
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
    if add_in_image:
        img_idx = o_real
        for i in range(o_real):
            triples.append([i, IN_IMAGE_IDX, img_idx])
    return np.asarray(triples, np.int32).reshape(-1, 3)


def encode_attributes(boxes: np.ndarray, masks: np.ndarray,
                      size_len: int = 10, grid_size: int = 25,
                      image_slot: bool = True) -> np.ndarray:
    """Size+location one-hots per object, incl. the __image__ row
    (coco.py:278-348,312-317): __image__ gets the max size bin and (the
    reference leaves its location cell implicit via the center — here cell
    center index, matching encode_scene_graphs model.py:242)."""
    o_real = boxes.shape[0]
    rows = o_real + (1 if image_slot else 0)
    attrs = np.zeros((rows, size_len + grid_size), np.float32)
    for i in range(o_real):
        w = boxes[i, 2] - boxes[i, 0]
        h = boxes[i, 3] - boxes[i, 1]
        attrs[i, min(size_attribute_index(w, h, size_len), size_len - 1)] = 1.0
        cx, cy = mask_centroid(boxes[i], masks[i])
        loc = min(max(location_attribute_index(cx, cy, grid_size), 0),
                  grid_size - 1)
        attrs[i, size_len + loc] = 1.0
    if image_slot:
        attrs[-1, size_len - 1] = 1.0                 # coco.py:315
        attrs[-1, size_len + (grid_size // 2)] = 1.0  # center cell (model.py:242)
    return attrs
