"""COCO-Stuff scene-graph dataset (host side; port of the JAX package's
``data/coco.py``, reference ``CocoSceneGraphDataset``, coco.py:21-472).

The same vocabulary, filters, ``Example``s and attributes pickle as the
JAX package's, and the same randomness: every draw of an example comes
from ``np.random.default_rng((seed, epoch, index))``, so the loader's
stream is the JAX loader's. Masks are decoded by the native codec
(``data/rle.py``); a PNG image is read and resized without PIL
(``image_utils.load_image``), a JPEG through PIL.

  * vocab: contiguous ``object_to_idx`` over the observed classes with
    0 = __image__ (coco.py:167-204);
  * object filters: box area, category whitelists, stuff-only images,
    3..8 objects an image (coco.py:124-187);
  * a random scene graph an epoch: one random partner an object,
    geometric predicates, __in_image__ edges (coco.py:351-416);
  * box-cropped binary masks (coco.py:298-310);
  * 10-bin size and 5x5-grid location attributes (coco.py:278-348), and
    the attribute-sampling mode with constraint propagation between
    related objects (coco.py:419-472), on the true grid root (the
    reference hard-codes 4x4);
  * ``test_part=True`` skips the first 1024 images (coco.py:188-189).
"""
from __future__ import annotations

import json
import os
import pickle
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np

from scene_generation_tpu_torch.data.batching import Example
from scene_generation_tpu_torch.data.image_utils import (load_image,
                                                       resize_mask)
from scene_generation_tpu_torch.data.rle import seg_to_mask
from scene_generation_tpu_torch.data.scene_graph import (
    PREDICATES, geometric_predicate, opposite_of)


class CocoSceneGraphDataset:
    # Mask re-binarization threshold after resize: the reference uses
    # > 128 for instances (coco.py:309) but > 127 for panoptic
    # (coco_panoptic.py:355); the subclass overrides.
    _mask_threshold = 128

    def __init__(self, image_dir: str, instances_json: str,
                 stuff_json: Optional[str] = None, stuff_only: bool = True,
                 image_size: Tuple[int, int] = (64, 64), mask_size: int = 16,
                 max_samples: Optional[int] = None,
                 min_object_size: float = 0.02,
                 min_objects_per_image: int = 3,
                 max_objects_per_image: int = 8,
                 include_other: bool = False,
                 instance_whitelist: Optional[List[str]] = None,
                 stuff_whitelist: Optional[List[str]] = None,
                 no_image_obj: bool = False,
                 sample_attributes: bool = False,
                 attributes_pickle: Optional[str] = None,
                 test_part: bool = False,
                 size_attribute_len: int = 10,
                 grid_size: int = 25,
                 seed: Optional[int] = None):
        self.image_dir = image_dir
        self.image_size = image_size
        self.mask_size = mask_size
        self.max_samples = max_samples
        self.no_image_obj = no_image_obj
        self.size_attribute_len = size_attribute_len
        self.grid_size = grid_size
        # All per-example randomness (partner choice, subject/object coin,
        # attribute sampling) derives from (seed, epoch, index) inside
        # get_example — a pure function, so any worker count/type and any
        # restart reproduce identical scene graphs (SURVEY.md §7
        # "deterministic per-epoch PRNG"; the reference's shared
        # random.Random, coco.py:373-387, is scheduling-dependent).
        self.seed = 0 if seed is None else int(seed)

        with open(instances_json) as f:
            instances_data = json.load(f)
        stuff_data = None
        if stuff_json:
            with open(stuff_json) as f:
                stuff_data = json.load(f)

        self.image_ids: List[int] = []
        self.image_id_to_filename: Dict[int, str] = {}
        self.image_id_to_size: Dict[int, Tuple[int, int]] = {}
        for image_data in instances_data["images"]:
            iid = image_data["id"]
            self.image_ids.append(iid)
            self.image_id_to_filename[iid] = image_data["file_name"]
            self.image_id_to_size[iid] = (image_data["width"],
                                          image_data["height"])

        # --- vocab (coco.py:92-122) ---
        self.vocab: Dict = {"object_name_to_idx": {}, "pred_name_to_idx": {}}
        self.vocab["num_attributes"] = size_attribute_len + grid_size
        object_idx_to_name: Dict[int, str] = {}
        all_instance_categories = []
        for cat in instances_data["categories"]:
            all_instance_categories.append(cat["name"])
            object_idx_to_name[cat["id"]] = cat["name"]
            self.vocab["object_name_to_idx"][cat["name"]] = cat["id"]
        all_stuff_categories = []
        if stuff_data:
            for cat in stuff_data["categories"]:
                all_stuff_categories.append(cat["name"])
                object_idx_to_name[cat["id"]] = cat["name"]
                self.vocab["object_name_to_idx"][cat["name"]] = cat["id"]

        if instance_whitelist is None:
            instance_whitelist = all_instance_categories
        if stuff_whitelist is None:
            stuff_whitelist = all_stuff_categories
        self.vocab["instance"] = list(instance_whitelist)
        self.vocab["stuff"] = list(stuff_whitelist)
        whitelist = set(instance_whitelist) | set(stuff_whitelist)

        # --- object filtering (coco.py:124-165) ---
        self.image_id_to_objects: Dict[int, List[dict]] = defaultdict(list)
        for sources in ([instances_data["annotations"]]
                        + ([stuff_data["annotations"]] if stuff_data else [])):
            for obj in sources:
                iid = obj["image_id"]
                _, _, ww, hh = obj["bbox"]
                iw, ih = self.image_id_to_size[iid]
                box_ok = (ww * hh) / (iw * ih) > min_object_size
                name = object_idx_to_name[obj["category_id"]]
                category_ok = name in whitelist
                other_ok = name != "other" or include_other
                if box_ok and category_ok and other_ok:
                    self.image_id_to_objects[iid].append(obj)
        if stuff_data and stuff_only:
            with_stuff = {o["image_id"] for o in stuff_data["annotations"]}
            self.image_ids = [i for i in self.image_ids if i in with_stuff]

        self.vocab["object_name_to_idx"]["__image__"] = 0
        name_to_idx = self.vocab["object_name_to_idx"]
        max_idx = max(name_to_idx.values())
        idx_to_name = ["NONE"] * (1 + max_idx)
        for name, idx in name_to_idx.items():
            idx_to_name[idx] = name
        self.vocab["object_idx_to_name"] = idx_to_name

        # --- prune by object count (coco.py:179-189) ---
        self.image_ids = [
            iid for iid in self.image_ids
            if min_objects_per_image <= len(self.image_id_to_objects[iid])
            <= max_objects_per_image]
        if test_part:
            self.image_ids = self.image_ids[1024:]

        # --- contiguous class mapping (coco.py:191-204) ---
        observed = sorted({obj["category_id"]
                           for iid in self.image_ids
                           for obj in self.image_id_to_objects[iid]})
        object_to_idx = {cid: k + 1 for k, cid in enumerate(observed)}
        object_to_idx[0] = 0
        self.object_to_idx = object_to_idx
        self.idx_to_object = {v: k for k, v in object_to_idx.items()}
        self.vocab["object_to_idx"] = object_to_idx
        # Indexed by CONTIGUOUS class id (0 = __image__); the reference's
        # list omits the 0 slot and is 1-off (coco.py:203).
        self.vocab["my_idx_to_obj"] = ["__image__"] + [
            self.vocab["object_idx_to_name"][cid] for cid in observed]

        self.vocab["pred_idx_to_name"] = ["__in_image__"] + PREDICATES
        self.vocab["pred_name_to_idx"] = {
            n: i for i, n in enumerate(self.vocab["pred_idx_to_name"])}
        # Checkpoints carry the vocab; eval scripts branch on this to
        # rebuild the matching dataset family (reference
        # sample_images.py:179 vocab['is_panoptic']).
        self.vocab["is_panoptic"] = False

        self.sample_attributes = None
        if sample_attributes:
            path = attributes_pickle or (
                f"./models/attributes_{size_attribute_len}_{grid_size}.pickle")
            with open(path, "rb") as f:
                self.sample_attributes = pickle.load(f)

    def insert_pre_trained_vocab(self, object_to_idx: Dict) -> None:
        """Adopt a checkpoint's class mapping (coco.py:217-223)."""
        object_to_idx = {int(k): v for k, v in object_to_idx.items()}
        self.object_to_idx = object_to_idx
        self.idx_to_object = {v: k for k, v in object_to_idx.items()}
        self.vocab["object_to_idx"] = object_to_idx
        my_idx_to_obj = [None] * len(object_to_idx)
        for real, mine in object_to_idx.items():
            my_idx_to_obj[mine] = self.vocab["object_idx_to_name"][real]
        self.vocab["my_idx_to_obj"] = my_idx_to_obj

    @property
    def num_classes(self) -> int:
        return len(self.object_to_idx)

    def total_objects(self) -> int:
        n = 0
        for i, iid in enumerate(self.image_ids):
            if self.max_samples and i >= self.max_samples:
                break
            n += len(self.image_id_to_objects[iid])
        return n

    def __len__(self) -> int:
        if self.max_samples is None:
            return len(self.image_ids)
        return min(len(self.image_ids), self.max_samples)

    def __getitem__(self, index: int) -> Example:
        return self.get_example(index, 0)

    def get_example(self, index: int, epoch: int = 0) -> Example:
        """Pure function of (self.seed, epoch, index) — see __init__."""
        rng = np.random.default_rng((self.seed, epoch, index))
        iid = self.image_ids[index]
        iw, ih = self.image_id_to_size[iid]
        image = load_image(os.path.join(
            self.image_dir, self.image_id_to_filename[iid]), self.image_size)

        anns = self.image_id_to_objects[iid]
        item_ctx = self._prepare_item(iid)
        o_real = len(anns)
        objs, boxes, masks = [], [], []
        size_attr = np.zeros((o_real + 1, self.size_attribute_len), np.float32)
        loc_attr = np.zeros((o_real + 1, self.grid_size), np.float32)

        for i, ann in enumerate(anns):
            objs.append(self.object_to_idx[ann["category_id"]])
            x, y, bw, bh = ann["bbox"]
            boxes.append([x / iw, y / ih, (x + bw) / iw, (y + bh) / ih])
            if self.sample_attributes is not None:
                name = self.vocab["object_idx_to_name"][ann["category_id"]]
                distr = np.asarray(self.sample_attributes["size"][name],
                                   np.float64)
                distr = distr / distr.sum()
                size_idx = int(rng.choice(self.size_attribute_len,
                                          p=distr))
            else:
                size_idx = round((self.size_attribute_len - 1)
                                 * (bw * bh) / (iw * ih))
            size_attr[i, size_idx] = 1.0

            # Mask: decode full-size, crop to box, resize, binarize
            # (coco.py:298-310).
            mask = self._decode_mask(ann, item_ctx, iw, ih)
            mx0, mx1 = int(round(x)), int(round(x + bw))
            my0, my1 = int(round(y)), int(round(y + bh))
            mx1 = max(mx0 + 1, mx1)
            my1 = max(my0 + 1, my1)
            masks.append(resize_mask(mask[my0:my1, mx0:mx1], self.mask_size,
                                     threshold=self._mask_threshold))

        if not self.no_image_obj:
            objs.append(0)
            size_attr[-1, self.size_attribute_len - 1] = 1.0
            boxes.append([0.0, 0.0, 1.0, 1.0])
            masks.append(np.ones((self.mask_size, self.mask_size), np.int64))

        objs_arr = np.asarray(objs, np.int32)
        boxes_arr = np.asarray(boxes, np.float32)
        masks_arr = np.stack(masks).astype(np.float32)

        # Centers from mask pixels (coco.py:326-349).
        centers = []
        loc_distr = []
        l_root = self.grid_size ** 0.5
        for i in range(len(objs)):
            x0, y0, x1, y1 = boxes_arr[i]
            m = masks_arr[i] > 0
            if not m.any():
                cx, cy = 0.5 * (x0 + x1), 0.5 * (y0 + y1)
            else:
                mh, mw = m.shape
                xs = np.linspace(x0, x1, mw)[None].repeat(mh, 0)
                ys = np.linspace(y0, y1, mh)[:, None].repeat(mw, 1)
                cx, cy = float(xs[m].mean()), float(ys[m].mean())
            centers.append((cx, cy))
            name = self.vocab["object_idx_to_name"][
                self.idx_to_object[int(objs_arr[i])]]
            if self.sample_attributes is not None and name != "__image__":
                loc_distr.append(np.asarray(
                    self.sample_attributes["location"][name], np.float64))
            else:
                loc_idx = int(round(cx * (l_root - 1))
                              + l_root * round(cy * (l_root - 1)))
                loc_attr[i, min(max(loc_idx, 0), self.grid_size - 1)] = 1.0
                loc_distr.append(None)
        centers_arr = np.asarray(centers, np.float32)

        # Random-partner triples (coco.py:351-416).
        triples = []
        real_idx = [i for i in range(len(objs)) if objs_arr[i] != 0]
        for cur in real_idx:
            choices = [i for i in real_idx if i != cur]
            if not choices:
                break
            other = choices[int(rng.integers(len(choices)))]
            if rng.random() > 0.5:
                s, o = cur, other
            else:
                s, o = other, cur
            p = geometric_predicate(boxes_arr[s], boxes_arr[o],
                                    centers_arr[s], centers_arr[o])
            if self.sample_attributes is not None:
                self._propagate(s, p, o, loc_attr, size_attr, loc_distr,
                                rng)
                self._propagate(o, opposite_of(p), s, loc_attr, size_attr,
                                loc_distr, rng)
            triples.append([s, self.vocab["pred_name_to_idx"][p], o])

        if not self.no_image_obj:
            img_idx = len(objs) - 1
            for i in range(img_idx):
                triples.append([i, self.vocab["pred_name_to_idx"]
                                ["__in_image__"], img_idx])

        attributes = np.concatenate([size_attr, loc_attr], axis=1)
        return Example(image=image, objs=objs_arr, boxes=boxes_arr,
                       masks=masks_arr,
                       triples=np.asarray(triples, np.int32).reshape(-1, 3),
                       attributes=attributes.astype(np.float32))

    # --- hooks for the panoptic variant -----------------------------------
    def _prepare_item(self, iid: int):
        return None

    def _decode_mask(self, ann, ctx, iw: int, ih: int) -> np.ndarray:
        return seg_to_mask(ann["segmentation"], iw, ih)

    def _propagate(self, s: int, p: str, o: int, loc_attr, size_attr,
                   loc_distr, rng) -> None:
        """Attribute-sampling constraint propagation (coco.py:419-472),
        generalized to the real grid root (the reference hard-codes 4x4)."""
        g = int(self.grid_size ** 0.5)
        if loc_attr[s].sum() == 1:
            return
        s_distr = loc_distr[s].copy()
        if loc_attr[o].sum() == 1:
            o_loc = int(np.argwhere(loc_attr[o] == 1)[0, 0])
            o_col, o_row = o_loc % g, o_loc // g
            cols = np.arange(self.grid_size) % g
            rows = np.arange(self.grid_size) // g
            if p == "surrounding":
                o_size = int(np.argwhere(size_attr[o] == 1)[0, 0])
                s_size = int(np.argwhere(size_attr[s] == 1)[0, 0])
                if o_size <= s_size:
                    size_attr[s, s_size] = 0
                    size_attr[s, max(0, o_size - 1)] = 1
                loc_attr[s, o_loc] = 1.0
                return
            if p == "inside":
                o_size = int(np.argwhere(size_attr[o] == 1)[0, 0])
                s_size = int(np.argwhere(size_attr[s] == 1)[0, 0])
                if o_size >= s_size:
                    size_attr[s, s_size] = 0
                    size_attr[s, min(size_attr.shape[1] - 1, o_size + 1)] = 1
                loc_attr[s, o_loc] = 1.0
                return
            if p == "left of":
                s_distr[cols >= o_col] = 0
            elif p == "right of":
                s_distr[cols <= o_col] = 0
            elif p == "above":
                s_distr[rows >= o_row] = 0
            elif p == "below":
                s_distr[rows <= o_row] = 0
        total = s_distr.sum()
        if total <= 0:
            s_distr = loc_distr[s].copy()
            total = s_distr.sum()
        s_distr = s_distr / total
        loc = int(rng.choice(self.grid_size, p=s_distr))
        loc_attr[s, loc] = 1.0


def coco_split(coco_dir: str, split: str, panoptic: bool = False, **kw):
    """The ``split`` ("train" or "val") dataset of ``coco_dir``, laid out as
    a COCO download is (``images/<split>2017``, ``annotations/``,
    ``panoptic/annotations/panoptic_<split>2017``): instances + stuff, or
    the panoptic family; ``kw`` goes to the dataset."""
    ann = os.path.join(coco_dir, "annotations")
    images = os.path.join(coco_dir, "images", f"{split}2017")
    if panoptic:
        from scene_generation_tpu_torch.data.coco_panoptic import \
            CocoPanopticSceneGraphDataset
        return CocoPanopticSceneGraphDataset(
            image_dir=images,
            panoptic=os.path.join(ann, f"panoptic_{split}2017.json"),
            panoptic_segmentation=os.path.join(
                coco_dir, "panoptic", "annotations", f"panoptic_{split}2017"),
            panoptic_categories=os.path.join(
                ann, "panoptic_coco_categories.json"), **kw)
    return CocoSceneGraphDataset(
        image_dir=images,
        instances_json=os.path.join(ann, f"instances_{split}2017.json"),
        stuff_json=os.path.join(ann, f"stuff_{split}2017.json"), **kw)
