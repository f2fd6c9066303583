"""COCO-Panoptic scene-graph dataset (port of the JAX package's
``data/coco_panoptic.py``; reference ``CocoPanopticSceneGraphDataset``,
coco_panoptic.py:19-...). Against the instances + stuff dataset:

  * objects come from the panoptic JSON's per-image ``segments_info``,
    filtered by segment area (coco_panoptic.py:151-171);
  * categories come from a panoptic category list whose ``isthing``
    splits them into instance and stuff whitelists
    (coco_panoptic.py:126-136);
  * masks are read from the panoptic PNGs (``read_png``: no PIL) through
    ``rgb2id`` and matched by segment id (coco_panoptic.py:325-349), and
    re-binarized at > 127.

The reference class dies with an AttributeError at the end of
``__getitem__`` (``include_sentence`` never set, coco_panoptic.py:463);
the JAX package fixed it and so does this port.
"""
from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import List, Optional, Tuple

import numpy as np

from scene_generation_tpu_torch.data.coco import CocoSceneGraphDataset
from scene_generation_tpu_torch.data.image_utils import read_png
from scene_generation_tpu_torch.data.scene_graph import PREDICATES


def rgb2id(color: np.ndarray) -> np.ndarray:
    """Panoptic PNG color -> segment id (reference data/utils.py:103-108)."""
    color = color.astype(np.uint32)
    return color[..., 0] + 256 * color[..., 1] + 256 * 256 * color[..., 2]


class CocoPanopticSceneGraphDataset(CocoSceneGraphDataset):
    _mask_threshold = 127  # reference coco_panoptic.py:355 'mask > 127'

    def __init__(self, image_dir: str, panoptic: str,
                 panoptic_segmentation: str,
                 panoptic_categories: Optional[str] = None,
                 categories_list: Optional[List[dict]] = None,
                 stuff_included: bool = True,
                 image_size: Tuple[int, int] = (64, 64), mask_size: int = 16,
                 max_samples: Optional[int] = None,
                 min_object_size: float = 0.02,
                 min_objects_per_image: int = 3,
                 max_objects_per_image: int = 8,
                 include_other: bool = False,
                 instance_whitelist=None, stuff_whitelist=None,
                 no_image_obj: bool = False, sample_attributes: bool = False,
                 attributes_pickle: Optional[str] = None,
                 test_part: bool = False, size_attribute_len: int = 10,
                 grid_size: int = 25, seed: Optional[int] = None):
        # NOTE: intentionally does NOT call super().__init__ — the vocab /
        # filtering source is entirely different; shared logic lives in the
        # __getitem__ / helpers inherited from CocoSceneGraphDataset.
        self.image_dir = image_dir
        self.panoptic_segmentation = panoptic_segmentation
        self.image_size = image_size
        self.mask_size = mask_size
        self.max_samples = max_samples
        self.no_image_obj = no_image_obj
        self.size_attribute_len = size_attribute_len
        self.grid_size = grid_size
        # Deterministic per-(epoch, index) randomness via the inherited
        # get_example (see CocoSceneGraphDataset.__init__).
        self.seed = 0 if seed is None else int(seed)

        with open(panoptic) as f:
            coco_d = json.load(f)
        if categories_list is None:
            with open(panoptic_categories) as f:
                categories_list = json.load(f)

        self.image_ids = []
        self.image_id_to_filename = {}
        self.image_id_to_size = {}
        for image_data in coco_d["images"]:
            iid = image_data["id"]
            self.image_ids.append(iid)
            self.image_id_to_filename[iid] = image_data["file_name"]
            self.image_id_to_size[iid] = (image_data["width"],
                                          image_data["height"])

        # --- vocab from panoptic categories (coco_panoptic.py:117-144) ---
        self.vocab = {"object_name_to_idx": {}, "pred_name_to_idx": {}}
        self.vocab["num_attributes"] = size_attribute_len + grid_size
        object_idx_to_name = {}
        all_instance_categories, all_stuff_categories = [], []
        for cat in categories_list:
            if cat.get("isthing", 0) == 1:
                all_instance_categories.append(cat["name"])
            elif stuff_included:
                all_stuff_categories.append(cat["name"])
            else:
                continue
            object_idx_to_name[cat["id"]] = cat["name"]
            self.vocab["object_name_to_idx"][cat["name"]] = cat["id"]

        if instance_whitelist is None:
            instance_whitelist = all_instance_categories
        if stuff_whitelist is None:
            stuff_whitelist = all_stuff_categories
        self.vocab["instance"] = list(instance_whitelist)
        self.vocab["stuff"] = list(stuff_whitelist)
        whitelist = set(instance_whitelist) | set(stuff_whitelist)

        # --- per-image segment filtering (coco_panoptic.py:146-172) ---
        self.image_id_to_objects = defaultdict(list)
        new_image_ids = []
        for ann in coco_d["annotations"]:
            iid = ann["image_id"]
            iw, ih = self.image_id_to_size[iid]
            segments = []
            for seg in ann["segments_info"]:
                area_ok = seg["area"] / (iw * ih) > min_object_size
                name = object_idx_to_name.get(seg["category_id"])
                if name is None:
                    continue
                category_ok = name in whitelist
                other_ok = name != "other" or include_other
                if area_ok and category_ok and other_ok:
                    segments.append(seg)
            if min_objects_per_image <= len(segments) <= max_objects_per_image:
                new_image_ids.append(iid)
                self.image_id_to_objects[iid] = segments

        self.vocab["object_name_to_idx"]["__image__"] = 0
        name_to_idx = self.vocab["object_name_to_idx"]
        max_idx = max(name_to_idx.values())
        idx_to_name = ["NONE"] * (1 + max_idx)
        for name, idx in name_to_idx.items():
            idx_to_name[idx] = name
        self.vocab["object_idx_to_name"] = idx_to_name

        self.image_ids = new_image_ids
        if test_part:
            self.image_ids = self.image_ids[1024:]

        observed = sorted({seg["category_id"]
                           for iid in self.image_ids
                           for seg in self.image_id_to_objects[iid]})
        object_to_idx = {cid: k + 1 for k, cid in enumerate(observed)}
        object_to_idx[0] = 0
        self.object_to_idx = object_to_idx
        self.idx_to_object = {v: k for k, v in object_to_idx.items()}
        self.vocab["object_to_idx"] = object_to_idx
        self.vocab["my_idx_to_obj"] = ["__image__"] + [
            self.vocab["object_idx_to_name"][cid] for cid in observed]

        self.vocab["pred_idx_to_name"] = ["__in_image__"] + PREDICATES
        self.vocab["pred_name_to_idx"] = {
            n: i for i, n in enumerate(self.vocab["pred_idx_to_name"])}
        # Eval scripts rebuild the panoptic dataset family off this flag
        # (reference sample_images.py:179).
        self.vocab["is_panoptic"] = True

        self.sample_attributes = None
        if sample_attributes:
            import pickle
            path = attributes_pickle or (
                f"./models/attributes_{size_attribute_len}_{grid_size}.pickle")
            with open(path, "rb") as f:
                self.sample_attributes = pickle.load(f)

    # --- mask source: panoptic PNG (coco_panoptic.py:325-357) ---
    def _prepare_item(self, iid: int):
        fname = self.image_id_to_filename[iid]
        png = os.path.join(self.panoptic_segmentation, fname[:-3] + "png")
        return rgb2id(read_png(png))

    def _decode_mask(self, ann, ctx, iw: int, ih: int) -> np.ndarray:
        return (ctx == ann["id"]).astype(np.uint8)
