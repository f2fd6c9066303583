"""Train the ResNet object classifier of the accuracy metric on ground-
truth object crops (port of the JAX package's
``scripts/train_accuracy_net.py``; reference
``scripts/train_accuracy_net.py:156-276``).

    python -m scene_generation_tpu_torch.tools.train_accuracy_net \\
        --coco_dir <coco> [--tiny] [--epochs 1] \
        [--save_path models/accuracy_net.pt]

Crops come from the crop forward kernel (on the card) at ``--crop_size``
(224; 32 with ``--tiny`` or ``--small_net``); labels are the contiguous
class ids; images and boxes need no gradient, so no crop backward runs.
The optimizer is the port's Adam (optax's order of operations). The net
is ResNet101 with torchvision weights where found (``SGT_RESNET_WEIGHTS``,
the fc layer left at its init), else ResNet (1, 1, 1, 1) with
``--tiny`` / ``--small_net``. It is saved with ``torch.save`` as
``{"state_dict", "stage_sizes", "num_classes", "crop_size"}``, the file
``sample_images --accuracy_model_path`` reads.
"""
from __future__ import annotations

import argparse
import os

import torch
import torch.nn.functional as F

from scene_generation_tpu_torch import resolve_device
from scene_generation_tpu_torch.config import Config, tiny_config
from scene_generation_tpu_torch.data.coco import coco_split
from scene_generation_tpu_torch.data.loader import DataLoader
from scene_generation_tpu_torch.data.synthetic import SyntheticDataset
from scene_generation_tpu_torch.models.resnet import (ResNet,
                                                      load_torch_resnet,
                                                      resnet101)
from scene_generation_tpu_torch.ops.crop import crop_bbox_batch
from scene_generation_tpu_torch.ops.images import wire_to_float
from scene_generation_tpu_torch.tools import device_of
from scene_generation_tpu_torch.trainer.optim import Adam


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--coco_dir", default="datasets/coco")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--synthetic_size", type=int, default=128)
    p.add_argument("--small_net", action="store_true",
                   help="ResNet (1, 1, 1, 1) at 32 px crops on the full data "
                        "config (sample_images --accuracy_tiny 1)")
    p.add_argument("--tiny", action="store_true",
                   help="small resnet + small crops on the tiny config (CI)")
    p.add_argument("--num_classes", type=int, default=None)
    p.add_argument("--crop_size", type=int, default=224)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--num_samples", type=int, default=None)
    p.add_argument("--save_path", default="models/accuracy_net.pt")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the kernels' plain versions)")
    return p.parse_args(argv)


def train_step(net: ResNet, opt: Adam, batch, crop: int, device):
    """One Adam step on the masked cross-entropy of the batch's GT crops;
    returns (loss, accuracy) tensors."""
    imgs = wire_to_float(torch.as_tensor(batch.imgs, device=device))
    boxes = torch.as_tensor(batch.boxes, device=device)
    objs = torch.as_tensor(batch.objs, device=device).long()
    n, o = objs.shape
    with torch.no_grad():
        crops = crop_bbox_batch(imgs, boxes, crop).reshape(n * o, crop,
                                                           crop, 3)
    labels = objs.reshape(n * o)
    w = (torch.as_tensor(batch.obj_mask, device=device).reshape(n * o)
         * (labels != 0))
    logits = net(crops)
    nll = -F.log_softmax(logits, -1).gather(1, labels[:, None])[:, 0]
    denom = w.sum().clamp_min(1.0)
    loss = (nll * w).sum() / denom
    acc = ((logits.argmax(-1) == labels) * w).sum() / denom
    grads = torch.autograd.grad(loss, opt.params)
    opt.update(grads)
    return loss.detach(), acc.detach()


def main(argv=None) -> ResNet:
    a = parse_args(argv)
    cfg = tiny_config() if a.tiny else Config()
    if a.synthetic:
        dset = SyntheticDataset(cfg, size=a.synthetic_size, seed=a.seed)
        num_classes = cfg.model.num_objs
    else:
        d = cfg.data
        dset = coco_split(a.coco_dir, "train", image_size=d.image_size,
                          mask_size=d.mask_size, max_samples=a.num_samples,
                          seed=a.seed)
        num_classes = dset.num_classes
    num_classes = a.num_classes or num_classes
    device = resolve_device(device_of(a))
    small = a.tiny or a.small_net
    crop = 32 if small else a.crop_size
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(a.seed)
        net = (ResNet((1, 1, 1, 1), num_classes) if small
               else resnet101(num_classes))
    if not small:
        net, loaded = load_torch_resnet(net, skip_fc=True)
        print(f"pretrained resnet101 weights loaded: {loaded}")
    net = net.to(device).train()
    opt = Adam(net.parameters(), a.learning_rate)
    loader = DataLoader(dset, batch_size=a.batch_size,
                        max_objs=cfg.data.max_objs,
                        max_triples=cfg.data.max_triples, seed=a.seed)
    step = 0
    loss = acc = torch.zeros(())
    for epoch in range(a.epochs):
        for batch in loader:
            loss, acc = train_step(net, opt, batch, crop, device)
            step += 1
            if step % 10 == 0 or step == 1:
                print(f"epoch {epoch} step {step}: loss {float(loss):.4f} "
                      f"acc {float(acc):.4f}")
    path = os.path.abspath(a.save_path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save({"state_dict": {k: v.cpu() for k, v in
                               net.state_dict().items()},
                "stage_sizes": list(net.stage_sizes),
                "num_classes": num_classes, "crop_size": crop}, path)
    print(f"saved accuracy net to {path} after {step} steps (final train "
          f"acc {float(acc):.4f})")
    return net


if __name__ == "__main__":
    main()
