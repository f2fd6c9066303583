"""Inference API: load a port checkpoint and generate images from batches
or GUI-style JSON scene graphs (port of the JAX package's ``api.py``)."""
from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from scene_generation_tpu_torch.config import Config
from scene_generation_tpu_torch.convert import load_checkpoint
from scene_generation_tpu_torch.data.batching import Batch, Example, collate
from scene_generation_tpu_torch.models.model import ModelOutput, SceneModel
from scene_generation_tpu_torch.profiling import span


class InferenceModel:
    """A SceneModel in eval mode + vocab + (optional) clustered features."""

    def __init__(self, cfg: Config, vocab: Dict, model: SceneModel,
                 features: Optional[Dict] = None,
                 features_one: Optional[Dict] = None, seed: int = 0):
        self.cfg = cfg
        self.vocab = vocab
        self.model = model.eval()
        self.device = next(model.parameters()).device
        self.features = features        # class -> (k, rep) cluster centers
        self.features_one = features_one
        self.generator = torch.Generator().manual_seed(seed)

    @classmethod
    def from_checkpoint(cls, output_dir: str,
                        checkpoint_name: str = "checkpoint",
                        best: bool = False,
                        features_path: Optional[str] = None,
                        device: Optional[str] = None) -> "InferenceModel":
        """The generator of ``<output_dir>/<checkpoint_name>``'s ``last/``
        (``best/`` with ``best``) state, with ``meta.json``'s config and
        vocab, on ``device`` (CUDA unless ``device="cpu"``): a training
        run's checkpoint or ``convert.save_checkpoint``'s."""
        cfg, vocab, model = load_checkpoint(output_dir, device,
                                            checkpoint_name, best)
        features = features_one = None
        if features_path:
            features = np.load(features_path, allow_pickle=True).item()
            one_path = features_path.replace("features_clustered_100",
                                             "features_clustered_001")
            if one_path != features_path and os.path.exists(one_path):
                features_one = np.load(one_path, allow_pickle=True).item()
        return cls(cfg, vocab, model, features, features_one)

    def _tensor(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    @torch.no_grad()
    def forward_batch(self, batch: Batch, use_gt_boxes: bool = False,
                      use_gt_masks: bool = False,
                      use_gt_attributes: bool = False,
                      features: Optional[np.ndarray] = None,
                      features_mask: Optional[np.ndarray] = None,
                      generator: Optional[torch.Generator] = None
                      ) -> ModelOutput:
        """Test-mode forward with the Figure-3 switches (GT boxes, GT masks,
        GT attributes). The mask noise comes from ``generator`` (the
        model's own seeded generator by default). ``features`` with an
        all-zero ``features_mask`` gives every object its repr_net
        appearance; ``features=None`` gives every object the appearance
        encoded from its crop of ``batch.imgs`` at its GT box (the crop
        kernel on the card). The noise draw and the host-to-device copies
        run in the profiler range ``infer/inputs``, the model call in
        ``infer/model`` (``profiling.span``)."""
        mc = self.cfg.model
        with span("infer/inputs"):
            noise = torch.randn(mc.mask_noise_dim,
                                generator=generator or self.generator)
            n, o = batch.objs.shape
            attributes = self._tensor(batch.attributes, torch.float32)
            if not use_gt_attributes:
                attributes = torch.zeros_like(attributes)
            if features is None:
                feats = fmask = None
            else:
                feats = self._tensor(features, torch.float32)
                fmask = (torch.ones((n, o), device=self.device)
                         if features_mask is None
                         else self._tensor(features_mask, torch.float32))
            objs = self._tensor(batch.objs)
            triples = self._tensor(batch.triples)
            obj_mask = self._tensor(batch.obj_mask, torch.float32)
            triple_mask = self._tensor(batch.triple_mask, torch.float32)
            noise = noise.to(self.device)
            imgs = self._tensor(batch.imgs)
            boxes_gt = self._tensor(batch.boxes, torch.float32)
            masks_gt = (self._tensor(batch.masks, torch.float32)
                        if use_gt_masks else None)
        with span("infer/model"):
            return self.model(
                objs, triples, attributes, obj_mask, triple_mask, noise,
                imgs=imgs, boxes_gt=boxes_gt, masks_gt=masks_gt,
                use_gt_box=use_gt_boxes, features=feats, features_mask=fmask)

    def sample_cluster_features(self, objs: np.ndarray, obj_mask: np.ndarray,
                                rng: np.random.RandomState
                                ) -> Tuple[np.ndarray, np.ndarray]:
        """A random cluster feature per object of a known class; the mask is
        1 only where a cluster entry exists, so other objects keep the
        model's repr_net appearance."""
        if self.features is None:
            raise ValueError(
                "No features file: pass features_path to sample appearance "
                "clusters")
        n, o = objs.shape
        rep = self.cfg.model.rep_size
        out = np.zeros((n, o, rep), np.float32)
        mask = np.zeros((n, o), np.float32)
        for i in range(n):
            for j in range(o):
                if obj_mask[i, j] == 0:
                    continue
                feats = self.features.get(int(objs[i, j]))
                if feats is None or len(feats) == 0:
                    continue
                out[i, j] = feats[rng.randint(len(feats))]
                mask[i, j] = 1.0
        return out, mask

    def encode_scene_graphs(self, scene_graphs):
        """GUI JSON dicts -> (padded Batch, features, features_mask).

        Input: {"objects": [names], "relationships": [[s, pred_name, o]],
        "attributes": {"size": [...], "location": [...]}, "features":
        [cluster indices, -1 = the single-cluster table], "image_id": int}.
        """
        if isinstance(scene_graphs, dict):
            scene_graphs = [scene_graphs]
        dc, mc = self.cfg.data, self.cfg.model
        size_len = dc.size_attribute_len
        examples = []
        feats_list = []
        name_to_global = self.vocab["object_name_to_idx"]
        obj_to_idx = {int(k): v for k, v
                      in self.vocab["object_to_idx"].items()}
        pred_to_idx = self.vocab["pred_name_to_idx"]
        h, w = dc.image_size

        for sg in scene_graphs:
            names = list(sg["objects"]) + ["__image__"]
            # The __image__ node's appearance cluster is the background
            # style, chosen by the GUI's image_id.
            feature_ids = list(sg.get("features", [-1] * (len(names) - 1)))
            feature_ids = feature_ids + [int(sg.get("image_id", -1))]
            o = len(names)
            objs = np.asarray(
                [obj_to_idx[int(name_to_global[nm])] for nm in names],
                np.int32)
            attributes = np.zeros((o, dc.num_attributes), np.float32)
            for i, s in enumerate(sg.get("attributes", {}).get("size", [])):
                attributes[i, int(s)] = 1
            attributes[-1, size_len - 1] = 1
            for i, l in enumerate(sg.get("attributes", {}).get("location",
                                                               [])):
                attributes[i, size_len + int(l)] = 1
            attributes[-1, size_len + 12] = 1  # center cell

            triples = []
            for s, p, o_idx in sg.get("relationships", []):
                triples.append([int(s), pred_to_idx[p], int(o_idx)])
            for i in range(o - 1):
                triples.append([i, pred_to_idx["__in_image__"], o - 1])

            feats = np.zeros((o, mc.rep_size), np.float32)
            fmask = np.zeros((o,), np.float32)
            table = self.features if self.features is not None else {}
            one = self.features_one or table
            for ind, (cls, fid) in enumerate(zip(objs, feature_ids)):
                cls = int(cls)
                if fid == -1 and cls in (one or {}):
                    feats[ind] = one[cls][0]
                    fmask[ind] = 1.0
                elif table and cls in table:
                    k = len(table[cls])
                    feats[ind] = table[cls][min(int(fid), k - 1)]
                    fmask[ind] = 1.0
                # No cluster entry: mask 0, so repr_net supplies the
                # appearance instead of a forced zero vector.
            feats_list.append((feats, fmask))

            examples.append(Example(
                image=np.zeros((h, w, 3), np.float32),
                objs=objs,
                boxes=np.tile(np.asarray([0, 0, 1, 1], np.float32), (o, 1)),
                masks=np.ones((o, dc.mask_size, dc.mask_size), np.float32),
                triples=np.asarray(triples, np.int32).reshape(-1, 3),
                attributes=attributes))

        batch = collate(examples, dc.max_objs, dc.max_triples)
        n = batch.num_images
        features = np.zeros((n, dc.max_objs, mc.rep_size), np.float32)
        features_mask = np.zeros((n, dc.max_objs), np.float32)
        for i, (f, fm) in enumerate(feats_list):
            features[i, :f.shape[0]] = f
            features_mask[i, :fm.shape[0]] = fm
        return batch, features, features_mask

    def forward_json(self, scene_graphs) -> Tuple[ModelOutput, Batch]:
        """GUI scene graphs -> (model output, the padded batch)."""
        batch, features, features_mask = self.encode_scene_graphs(
            scene_graphs)
        out = self.forward_batch(batch, use_gt_attributes=True,
                                 features=features,
                                 features_mask=features_mask)
        return out, batch
