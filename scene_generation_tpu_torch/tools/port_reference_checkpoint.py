"""Port the paper's own checkpoint (the reference trainer's ``.pt``) into
the port's train-state checkpoint (port of the JAX package's
``scripts/port_reference_checkpoint.py``).

    python -m scene_generation_tpu_torch.tools.port_reference_checkpoint \\
        --torch_checkpoint checkpoint_with_model.pt --output_dir runs/ported \\
        [--best] [--compute_dtype bfloat16] [--cpu]

Reads the reference's dict (``model_state`` / ``model_best_state``,
``d_obj_state``, ``d_img_state``, ``d_mask_state``, ``vocab``, ``args``,
``counters``), builds the config from its ``args`` with the
reference-parity bits forced (``convert_reference.config_from_reference_args``),
and writes ``<output_dir>/<checkpoint_name>/last/state.pt`` and
``meta.json`` in the train CLI's layout (``trainer/checkpoint.py``): the
converted generator; the converted discriminators where their states are
present, seed-initialised ones otherwise; fresh Adams (the reference's
``torch.optim.Adam`` moments are not carried over, as in the JAX tool); no
random-generator state (a resume seeds it from the config's seed); the
meta's counters ``t`` and ``epoch`` and ``ported_from``.

``serve.py --output_dir <output_dir>``, ``InferenceModel.from_checkpoint``,
``sample_images``, ``gui_server`` and ``train --restore_from_checkpoint 1``
(with flags that give the same architecture, ``--torch_deconv 1``) read it
as they read a checkpoint the port trained. The template state is built on
the card unless ``--cpu``.
"""
from __future__ import annotations

import argparse
import os

import torch

from scene_generation_tpu_torch.convert_reference import (
    config_from_reference_args, convert_reference_discriminators,
    convert_reference_state_dict)
from scene_generation_tpu_torch.tools import device_of
from scene_generation_tpu_torch.trainer.checkpoint import CheckpointManager
from scene_generation_tpu_torch.trainer.train_state import create_train_state


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--torch_checkpoint", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--checkpoint_name", default="checkpoint")
    p.add_argument("--best", action="store_true",
                   help="port model_best_state instead of model_state")
    p.add_argument("--compute_dtype", default="bfloat16",
                   choices=["float32", "bfloat16"],
                   help="serving dtype of the ported config (parameters "
                        "are stored f32 either way)")
    p.add_argument("--cpu", action="store_true")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Write the port's checkpoint; returns its meta."""
    a = parse_args(argv)
    ckpt = torch.load(a.torch_checkpoint, map_location="cpu",
                      weights_only=False)
    key = "model_best_state" if a.best else "model_state"
    if ckpt.get(key) is None:
        raise SystemExit(f"checkpoint has no '{key}'")
    cfg = config_from_reference_args(ckpt.get("args") or {}, ckpt["vocab"],
                                     a.compute_dtype)
    # The template: seed-initialised, so the discriminators a checkpoint
    # lacks are fresh ones; the Adams stay fresh.
    state = create_train_state(cfg, device_of(a), seed=cfg.train.seed,
                               load_vgg=False)
    state.model.load_state_dict(
        convert_reference_state_dict(ckpt[key], cfg.model), strict=True)
    for name, sd in convert_reference_discriminators(
            ckpt, cfg.discriminator).items():
        getattr(state, name).load_state_dict(sd, strict=True)
        print(f"ported {name}_state")
    tree = state.state_dict()
    tree["gen"] = None          # a resume seeds it from the config's seed
    mgr = CheckpointManager(a.output_dir, a.checkpoint_name, use_async=False)
    meta = mgr.new_meta(cfg, ckpt["vocab"])
    counters = ckpt.get("counters") or {}
    meta["counters"] = {"t": int(counters.get("t") or 0),
                        "epoch": int(counters.get("epoch") or 0)}
    meta["ported_from"] = os.path.abspath(a.torch_checkpoint)
    mgr.save(tree, best=False)
    mgr.save_meta(meta)
    mgr.close()
    n = sum(v.numel() for v in ckpt[key].values())
    print(f"ported '{key}' ({n} reference parameters) -> {mgr.root}")
    return meta


if __name__ == "__main__":
    main()
