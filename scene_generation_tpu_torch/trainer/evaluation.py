"""Training-time evaluation (port of the JAX package's
``trainer/evaluation.py``; reference ``check_model``, train.py:80-116).

Runs the generator in test mode over the val loader, with the GT layout
(``use_gt``) or from the scene graph alone, and reports box IoU
(``jaccard``) and the Inception score. The classifier is pluggable:
``probs_fn(imgs in [-1, 1], NHWC) -> (N, K) softmax`` (see
``models/inception.py``).
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from scene_generation_tpu_torch.data.batching import Batch
from scene_generation_tpu_torch.metrics import jaccard
from scene_generation_tpu_torch.models.model import SceneModel
from scene_generation_tpu_torch.parallel.data_parallel import (SINGLE,
                                                               Collectives,
                                                               gather)
from scene_generation_tpu_torch.trainer.step import batch_to, generator_dtype


def make_eval_step(use_gt: bool) -> Callable:
    """``eval_step(model, batch, noise) -> (imgs_pred, iou_sum, recall05,
    recall03, n_boxes)``: the test-mode forward (GT boxes, masks and
    attributes with ``use_gt``; predicted boxes and masks and zero
    attributes without), with every object's appearance encoded from its
    crop of the batch's images. IoU leaves the ``__image__`` rows out
    (sample_images.py:241-249). The model is left in the mode it was in."""

    @torch.no_grad()
    def eval_step(model: SceneModel, batch: Batch, noise: torch.Tensor):
        dev = next(model.parameters()).device
        b = batch_to(batch, dev)
        attributes = b.attributes.float()
        if not use_gt:
            attributes = torch.zeros_like(attributes)
        obj_mask = b.obj_mask.float()
        training = model.training
        model.eval()
        try:
            with generator_dtype(model.cfg, dev):
                out = model(b.objs, b.triples, attributes, obj_mask,
                            b.triple_mask.float(), noise.to(dev),
                            imgs=b.imgs, boxes_gt=b.boxes.float(),
                            masks_gt=b.masks.float() if use_gt else None,
                            use_gt_box=use_gt)
        finally:
            model.train(training)
        mask = obj_mask * (b.objs != 0)
        iou_sum, r05, r03 = jaccard(out.boxes_pred, b.boxes.float(), mask)
        return out.imgs_pred, iou_sum, r05, r03, mask.sum()

    return eval_step


def inception_score_from_probs(probs: np.ndarray,
                               splits: int = 5) -> Tuple[float, float]:
    """exp(mean KL(p(y|x) || p(y))) per split (inception_score.py:47-61).

    ``splits`` chunks of N // splits images, dropping the N % splits
    remainder, as the reference does; with fewer images than splits, one
    split of all of them."""
    n = probs.shape[0] // splits
    if n == 0:
        n = max(probs.shape[0], 1)
    scores = []
    for i in range(splits):
        part = probs[i * n:(i + 1) * n]
        if len(part) == 0:
            continue
        py = part.mean(axis=0, keepdims=True)
        kl = part * (np.log(part + 1e-12) - np.log(py + 1e-12))
        scores.append(float(np.exp(kl.sum(axis=1).mean())))
    return float(np.mean(scores)), float(np.std(scores))


def check_model(model: SceneModel, loader, use_gt: bool, num_samples: int,
                probs_fn: Optional[Callable] = None,
                generator: Optional[torch.Generator] = None,
                splits: int = 5, comm: Collectives = SINGLE):
    """-> (avg_iou, inception_mean, inception_std, recall05, recall03)
    over the first ``num_samples`` images of ``loader`` (whole batches).
    Each batch's mask noise is drawn on the CPU from ``generator``
    (``manual_seed(0)`` by default), so a sweep draws nothing from the
    train state's generator. Under data parallelism (``comm``) the loader
    gives this rank's slice of each batch; IoU, recall and box counts are
    summed across ranks before dividing and the class probabilities
    gathered, so every rank returns the global sweep's values (and takes
    the same best-promotion decision)."""
    eval_step = make_eval_step(use_gt)
    gen = generator if generator is not None else \
        torch.Generator().manual_seed(0)
    totals = None
    seen = 0
    all_probs = []
    for batch in loader:
        noise = torch.randn(model.cfg.mask_noise_dim, generator=gen)
        imgs_pred, iou_sum, r05, r03, nbox = eval_step(model, batch, noise)
        stats = torch.stack([iou_sum, r05, r03, nbox]).double()
        totals = stats if totals is None else totals + stats
        if probs_fn is not None:
            probs = torch.as_tensor(probs_fn(imgs_pred)).float()
            probs = gather(comm, probs.to(iou_sum.device))
            all_probs.append(probs.cpu().numpy())
        seen += batch.num_images * comm.world_size
        if seen >= num_samples:
            break
    if totals is None:
        totals = torch.zeros(4, dtype=torch.float64)
    else:
        comm.all_reduce_(totals)
    # One device-to-host transfer for the four sums.
    total_iou, total_r05, total_r03, total_boxes = totals.tolist()
    avg_iou = total_iou / max(total_boxes, 1.0)
    if all_probs:
        imean, istd = inception_score_from_probs(
            np.concatenate(all_probs), splits)
    else:
        imean, istd = 0.0, 0.0
    return (avg_iou, imean, istd,
            total_r05 / max(total_boxes, 1.0),
            total_r03 / max(total_boxes, 1.0))
