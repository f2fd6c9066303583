"""Batch inference and evaluation (port of the JAX package's
``scripts/sample_images.py``; reference ``scripts/sample_images.py``).

    python -m scene_generation_tpu_torch.tools.sample_images \\
        --output_dir <run> --features_path <dir>/features_clustered_001.npy \\
        --coco_dir <coco> [--use_gt_boxes 1 --use_gt_masks 1] [--cpu]

The Figure-3 ablation modes (README.md:84-94): (c) ``--use_gt_boxes 1
--use_gt_masks 1``, the GT layout; (d) ``--use_gt_attr 1``; (e)
``--use_gt_textures 1``, appearance encoded from the GT crops (the crop
forward kernel on the card); (f) neither, the scene graph only. Reports
avg IoU and recall@0.5 / 0.3 in ``<save_dir>/results.json`` and writes
``img%06d_{pred,gt,layout}.png`` (``_graph.png`` or ``.dot`` with
``--save_graphs 1``). With ``--accuracy_model_path`` (a
``train_accuracy_net`` file) it adds ``object_accuracy``: the accuracy
net's class of every generated object crop, cropped at
``--accuracy_crop_size`` (32 with ``--accuracy_tiny 1``) by the crop
kernel.

Every sample is generated: the loader keeps the last, partial batch (the
JAX script drops it), and ``num_images`` counts what was saved.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from scene_generation_tpu_torch.api import InferenceModel
from scene_generation_tpu_torch.data.image_utils import deprocess, write_png
from scene_generation_tpu_torch.data.loader import DataLoader
from scene_generation_tpu_torch.data.synthetic import SyntheticDataset
from scene_generation_tpu_torch.metrics import jaccard
from scene_generation_tpu_torch.models.resnet import ResNet
from scene_generation_tpu_torch.ops.crop import crop_bbox_batch
from scene_generation_tpu_torch.tools import (checkpoint_coco_dataset,
                                              device_of)
from scene_generation_tpu_torch.vis import draw_layout, draw_scene_graph


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--output_dir", default="output")
    p.add_argument("--checkpoint_name", default="checkpoint")
    p.add_argument("--best", type=int, default=0)
    p.add_argument("--features_path", default=None,
                   help="features_clustered_*.npy from encode_features")
    p.add_argument("--use_gt_boxes", type=int, default=0)
    p.add_argument("--use_gt_masks", type=int, default=0)
    p.add_argument("--use_gt_attr", type=int, default=0)
    p.add_argument("--use_gt_textures", type=int, default=0)
    p.add_argument("--sample_attributes", type=int, default=0)
    p.add_argument("--test_part", type=int, default=1,
                   help="1 (reference parity, coco.py:188-189): skip the "
                        "first 1024 COCO val images; 0: use the whole val "
                        "set (required for small fixture datasets)")
    p.add_argument("--accuracy_model_path", default=None,
                   help="accuracy-net file from train_accuracy_net")
    p.add_argument("--accuracy_tiny", type=int, default=0,
                   help="the accuracy net was trained with --tiny")
    p.add_argument("--accuracy_crop_size", type=int, default=224)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--num_samples", type=int, default=64)
    p.add_argument("--save_dir", default="samples")
    p.add_argument("--save_imgs", type=int, default=1)
    p.add_argument("--save_layouts", type=int, default=1)
    p.add_argument("--save_graphs", type=int, default=0)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--coco_dir", default="datasets/coco")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the kernels' plain versions)")
    return p.parse_args(argv)


def build_loader(model: InferenceModel, a: argparse.Namespace) -> DataLoader:
    """The evaluation set, in order, the last partial batch kept: with
    ``--synthetic`` ``max(num_samples, batch_size)`` scenes of seed
    ``seed + 7`` (the JAX script's), else the COCO val split of the
    checkpoint's family, with full-resolution GT masks under
    ``--use_gt_masks`` (reference sample_images.py:67)."""
    cfg = model.cfg
    if a.synthetic:
        dset = SyntheticDataset(cfg, size=max(a.num_samples, a.batch_size),
                                seed=a.seed + 7)
    else:
        mask_size = (cfg.data.image_size[0]
                     if getattr(a, "use_gt_masks", 0) else None)
        dset = checkpoint_coco_dataset(
            model, a, "val", mask_size=mask_size,
            sample_attributes=bool(a.sample_attributes),
            test_part=bool(a.test_part))
    return DataLoader(dset, batch_size=a.batch_size,
                      max_objs=cfg.data.max_objs,
                      max_triples=cfg.data.max_triples, shuffle=False,
                      drop_last=False)


def load_accuracy_net(path: str, num_classes: int, tiny: bool,
                      device) -> ResNet:
    """The accuracy net of a ``train_accuracy_net`` file, in eval mode,
    built at the file's stage sizes: (1, 1, 1, 1) with
    ``tiny``, else ResNet101's (3, 4, 23, 3)."""
    saved = torch.load(path, map_location="cpu", weights_only=True)
    stages = tuple(saved["stage_sizes"])
    want = (1, 1, 1, 1) if tiny else (3, 4, 23, 3)
    if stages != want or saved["num_classes"] != num_classes:
        raise ValueError(
            f"{path} holds a ResNet {stages} over {saved['num_classes']} "
            f"classes; --accuracy_tiny {int(tiny)} with this checkpoint "
            f"needs {want} over {num_classes}")
    net = ResNet(stages, num_classes)
    net.load_state_dict(saved["state_dict"])
    return net.to(device).eval()


@torch.no_grad()
def accuracy_counts(net: ResNet, imgs: torch.Tensor, boxes: torch.Tensor,
                    objs: torch.Tensor, obj_mask: torch.Tensor,
                    crop_size: int):
    """(correct, classified): objects of a known class (not padding, not
    ``__image__``) whose crop the net classifies as their class."""
    n, o = objs.shape
    crops = crop_bbox_batch(imgs, boxes, crop_size)
    logits = net(crops.reshape(n * o, crop_size, crop_size, 3).float())
    labels = objs.reshape(n * o).long()
    w = obj_mask.reshape(n * o) * (labels != 0)
    correct = ((logits.argmax(-1) == labels) * w).sum()
    return correct, w.sum()


def main(argv=None) -> dict:
    a = parse_args(argv)
    model = InferenceModel.from_checkpoint(
        a.output_dir, a.checkpoint_name, best=bool(a.best),
        features_path=a.features_path, device=device_of(a))
    loader = build_loader(model, a)
    os.makedirs(a.save_dir, exist_ok=True)
    rng = np.random.RandomState(a.seed)

    net = None
    if a.accuracy_model_path:
        acc_crop = 32 if a.accuracy_tiny else a.accuracy_crop_size
        net = load_accuracy_net(a.accuracy_model_path,
                                model.cfg.model.num_objs,
                                bool(a.accuracy_tiny), model.device)

    totals = torch.zeros(6, dtype=torch.float64, device=model.device)
    saved = 0
    for batch in loader:
        if a.use_gt_textures:
            features = features_mask = None
        else:
            features, features_mask = model.sample_cluster_features(
                batch.objs, batch.obj_mask, rng)
        # Attributes are zeroed unless --use_gt_attr, whatever the
        # sampling mode (reference sample_images.py:216-217).
        out = model.forward_batch(
            batch, use_gt_boxes=bool(a.use_gt_boxes),
            use_gt_masks=bool(a.use_gt_masks),
            use_gt_attributes=bool(a.use_gt_attr),
            features=features, features_mask=features_mask)
        boxes, obj_mask, objs = (torch.as_tensor(a, device=model.device)
                                 for a in (batch.boxes, batch.obj_mask,
                                           batch.objs))
        mask = obj_mask * (objs != 0)
        stats = list(jaccard(out.boxes_pred, boxes, mask)) + [mask.sum()]
        if net is not None:
            # Crops of the GT boxes only under --use_gt_boxes (reference
            # sample_images.py:225-228).
            stats += accuracy_counts(
                net, out.imgs_pred, boxes if a.use_gt_boxes
                else out.boxes_pred, objs, obj_mask, acc_crop)
        totals[:len(stats)] += torch.stack([s.double() for s in stats])

        imgs = out.imgs_pred.cpu().numpy()
        boxes_pred = out.boxes_pred.cpu().numpy()
        masks_pred = out.masks_pred.cpu().numpy()
        for i in range(batch.num_images):
            if saved >= a.num_samples:
                break
            stem = os.path.join(a.save_dir, f"img{saved:06d}")
            if a.save_imgs:
                write_png(stem + "_pred.png", deprocess(imgs[i]))
                write_png(stem + "_gt.png", deprocess(batch.imgs[i]))
            if a.save_layouts:
                o_real = int(batch.obj_mask[i].sum())
                write_png(stem + "_layout.png", draw_layout(
                    model.vocab, batch.objs[i][:o_real],
                    boxes_pred[i][:o_real], masks_pred[i][:o_real]))
            if a.save_graphs:
                t_real = int(batch.triple_mask[i].sum())
                res = draw_scene_graph(model.vocab, batch.objs[i],
                                       batch.triples[i][:t_real],
                                       output_path=stem + "_graph.png")
                if not res.endswith(".png"):
                    with open(stem + "_graph.dot", "w") as f:
                        f.write(res)
            saved += 1
        if saved >= a.num_samples:
            break

    iou, r05, r03, n_boxes, correct, classified = totals.tolist()
    nb = max(n_boxes, 1.0)
    results = {"avg_iou": iou / nb, "recall@0.5": r05 / nb,
               "recall@0.3": r03 / nb, "num_images": saved}
    if net is not None:
        results["object_accuracy"] = correct / max(classified, 1.0)
    print(f"generated {saved} images")
    print(json.dumps(results))
    with open(os.path.join(a.save_dir, "results.json"), "w") as f:
        json.dump(results, f)
    return results


if __name__ == "__main__":
    main()
