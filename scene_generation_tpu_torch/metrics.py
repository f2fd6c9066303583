"""Box metrics (port of the JAX package's ``metrics.py``; reference
``scene_generation/metrics.py:20-35``)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def intersection(bbox_pred: torch.Tensor, bbox_gt: torch.Tensor
                 ) -> torch.Tensor:
    """Elementwise box intersection area (metrics.py:20-24)."""
    max_xy = torch.minimum(bbox_pred[..., 2:], bbox_gt[..., 2:])
    min_xy = torch.maximum(bbox_pred[..., :2], bbox_gt[..., :2])
    inter = torch.clamp(max_xy - min_xy, min=0.0)
    return inter[..., 0] * inter[..., 1]


def jaccard(bbox_pred: torch.Tensor, bbox_gt: torch.Tensor,
            mask: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(sum IoU, #IoU>0.5, #IoU>0.3) over (optionally masked) boxes.

    Reference ``jaccard`` (metrics.py:27-35); ``mask`` excludes padding and,
    as in evaluation, the __image__ rows (sample_images.py:241-249).
    """
    inter = intersection(bbox_pred, bbox_gt)
    area_pred = ((bbox_pred[..., 2] - bbox_pred[..., 0])
                 * (bbox_pred[..., 3] - bbox_pred[..., 1]))
    area_gt = ((bbox_gt[..., 2] - bbox_gt[..., 0])
               * (bbox_gt[..., 3] - bbox_gt[..., 1]))
    union = area_pred + area_gt - inter
    iou = inter / torch.where(union == 0, torch.ones_like(union), union)
    if mask is not None:
        iou = iou * mask
        valid = mask
    else:
        valid = torch.ones_like(iou)
    return (iou.sum(), ((iou > 0.5) * valid).sum(),
            ((iou > 0.3) * valid).sum())
