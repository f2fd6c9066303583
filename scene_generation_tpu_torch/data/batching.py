"""The padded batch contract (a copy of the JAX package's
``data/batching.py``).

This replaces the reference's ragged-flat collate (``coco_collate_fn``,
coco.py:501-547) with fixed shapes:

  imgs        (N, H, W, 3) uint8 wire format (float32 [-1, 1] also
              accepted)
  objs        (N, MAX_O)   int32 contiguous class ids (0 = __image__/pad)
  boxes       (N, MAX_O, 4) float32 [x0, y0, x1, y1] in [0, 1]
  masks       (N, MAX_O, M, M) float32 binary
  triples     (N, MAX_T, 3) int32 local [s, p, o]
  attributes  (N, MAX_O, A) float32 (size ++ location one-hots)
  obj_mask    (N, MAX_O)   float32 validity
  triple_mask (N, MAX_T)   float32 validity

``obj_to_img`` / ``triple_to_img`` disappear: object slot o of image n IS the
mapping. Padded boxes are unit boxes so interpolation matrices stay benign.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np


class Batch(NamedTuple):
    imgs: np.ndarray
    objs: np.ndarray
    boxes: np.ndarray
    masks: np.ndarray
    triples: np.ndarray
    attributes: np.ndarray
    obj_mask: np.ndarray
    triple_mask: np.ndarray

    @property
    def num_images(self) -> int:
        return self.imgs.shape[0]


class Example(NamedTuple):
    """One image with its ragged scene graph (host-side, pre-padding)."""
    image: np.ndarray        # (H, W, 3) normalized
    objs: np.ndarray         # (o,)
    boxes: np.ndarray        # (o, 4)
    masks: np.ndarray        # (o, M, M)
    triples: np.ndarray      # (t, 3) local indices
    attributes: np.ndarray   # (o, A)


def collate(examples: Sequence[Example], max_objs: int,
            max_triples: int) -> Batch:
    """Stack padded examples into a Batch (device-ready numpy).

    Fills preallocated batch arrays in place (no per-example pad + stack +
    astype copies — the loader runs on the host's critical path)."""
    n = len(examples)
    ex0 = examples[0]
    h, w, _ = ex0.image.shape
    m = ex0.masks.shape[-1]
    a = ex0.attributes.shape[-1]
    imgs = np.empty((n, h, w, 3), ex0.image.dtype)  # uint8 wire format
    objs = np.zeros((n, max_objs), np.int32)
    boxes = np.zeros((n, max_objs, 4), np.float32)
    boxes[..., 2:] = 1.0
    masks = np.zeros((n, max_objs, m, m), np.float32)
    triples = np.zeros((n, max_triples, 3), np.int32)
    attrs = np.zeros((n, max_objs, a), np.float32)
    om = np.zeros((n, max_objs), np.float32)
    tm = np.zeros((n, max_triples), np.float32)
    for i, ex in enumerate(examples):
        o = ex.objs.shape[0]
        t = ex.triples.shape[0]
        if o > max_objs:
            raise ValueError(f"{o} objects > max_objs={max_objs}")
        if t > max_triples:
            raise ValueError(f"{t} triples > max_triples={max_triples}")
        imgs[i] = ex.image
        objs[i, :o] = ex.objs
        boxes[i, :o] = ex.boxes
        masks[i, :o] = ex.masks
        triples[i, :t] = ex.triples
        attrs[i, :o] = ex.attributes
        om[i, :o] = 1.0
        tm[i, :t] = 1.0
    return Batch(imgs=imgs, objs=objs, boxes=boxes, masks=masks,
                 triples=triples, attributes=attrs, obj_mask=om,
                 triple_mask=tm)
