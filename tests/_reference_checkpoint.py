"""A checkpoint in the reference trainer's format, written from a seed (the
paper's published checkpoint is not in the repository): the ``.pt`` dict
of the reference's train.py (``model_state``, ``model_best_state``,
``d_obj_state``, ``d_img_state``, ``d_mask_state``, ``vocab``, ``args``,
``counters``).

Each reference state dict is named by replaying the reference's module
tree (its ``nn.Sequential`` indices) for every parameter of the port's
module at the same config, and takes that parameter's shape: the JAX
package's strict ``convert_reference_state_dict`` accepting the result is
what proves the key set. Values are drawn with numpy: weights N(0,
1/fan_in), embeddings N(0, 1), biases N(0, 0.1^2), batch norm weights
1 + N(0, 0.2^2), running means N(0, 0.2^2) and variances in [0.5, 1.5),
and a ``num_batches_tracked`` counter beside each batch norm. Imports
torch and numpy only, beside the port's module builders.
"""
from __future__ import annotations

import math
import re
from typing import Dict

import numpy as np
import torch

from scene_generation_tpu_torch.config import Config
from scene_generation_tpu_torch.trainer.train_state import build_modules


def _mlp_index(j: int, leaf: str, batch_norm: bool) -> str:
    stride = 3 if batch_norm else 2
    return str(j * stride + (leaf == "bns"))


def _cnn_indices(arch: str, normalization: str) -> Dict[str, int]:
    """The reference ``build_cnn`` Sequential index of ``convs.j`` and
    ``bns.j``."""
    specs = [s for s in arch.split(",") if not s.startswith("I")]
    out, idx = {}, 0
    for j in range(len(specs)):
        if j:
            if normalization == "batch":
                out[f"bns.{j - 1}"] = idx
            idx += 2 if normalization in ("batch", "instance") else 1
        out[f"convs.{j}"] = idx
        idx += 1
    return out


def _generator_name(name: str, cfg: Config) -> str:
    mc = cfg.model
    bn = mc.mlp_normalization == "batch"
    module, leaf = name.rsplit(".", 1)
    leaf = {"scale": "weight"}.get(leaf, leaf)
    m = re.fullmatch(r"gconv_net\.layers\.(\d+)\.(.*)", module)
    if m:
        module = f"gconv_net.gconvs.{m[1]}.{m[2]}"
    if module.startswith("gconv_linear"):
        module = "gconv"
    m = re.fullmatch(r"(.*(?:net1|net2|box_net|repr_net))\.(layers|bns)\.(\d+)",
                     module)
    if m:
        module = f"{m[1]}.{_mlp_index(int(m[3]), m[2], bn)}"
    n_up = int(math.log2(mc.mask_size))
    m = re.fullmatch(r"mask_net\.(convs|bns)\.(\d+)", module)
    if m:
        module = f"mask_net.{4 * int(m[2]) + (1 if m[1] == 'convs' else 2)}"
    if module == "mask_net.out":
        module = f"mask_net.{4 * n_up}"
    m = re.fullmatch(r"image_encoder\.cnn\.(.*)", module)
    if m:
        idx = _cnn_indices(mc.appearance_arch, mc.appearance_normalization)
        module = f"image_encoder.cnn.0.{idx[m[1]]}"
    if module == "image_encoder.dense":
        module = "image_encoder.cnn.2"
    nd, nb = mc.n_downsample_global, mc.n_blocks_global
    up = 4 + 3 * nd + nb
    g = "layout_to_image.model"
    for pattern, fn in (
            (r"layout_to_image\.stem\.conv", lambda m: f"{g}.1"),
            (r"layout_to_image\.downs\.(\d+)",
             lambda m: f"{g}.{4 + 3 * int(m[1])}"),
            (r"layout_to_image\.blocks\.(\d+)\.conv([12])",
             lambda m: f"{g}.{4 + 3 * nd + int(m[1])}.conv_block."
                       f"{1 if m[2] == '1' else 5}"),
            (r"layout_to_image\.ups\.(\d+)",
             lambda m: f"{g}.{up + 3 * int(m[1])}"),
            (r"layout_to_image\.head", lambda m: f"{g}.{up + 3 * nd + 1}")):
        m = re.fullmatch(pattern, module)
        if m:
            module = fn(m)
    return f"{module}.{leaf}"


def _d_obj_name(name: str, cfg: Config) -> str:
    dc = cfg.discriminator
    module, leaf = name.rsplit(".", 1)
    leaf = {"scale": "weight"}.get(leaf, leaf)
    m = re.fullmatch(r"discriminator\.cnn\.(.*)", module)
    if m:
        idx = _cnn_indices(dc.d_obj_arch, dc.d_normalization)
        module = f"discriminator.cnn.0.{idx[m[1]]}"
    module = {"discriminator.dense": "discriminator.cnn.2",
              "discriminator.real": "discriminator.real_classifier",
              "discriminator.obj": "discriminator.obj_classifier"}.get(
                  module, module)
    return f"{module}.{leaf}"


def _multiscale_name(name: str, n_layers: int) -> str:
    m = re.fullmatch(r"scales\.scale_(\d+)\.(\w+)(?:\.(\d+))?\.(\w+)", name)
    scale, part, j, leaf = m.groups()
    stage = {"penultimate": n_layers, "head": n_layers + 1}.get(part)
    return f"scale{scale}_layer{int(j) if stage is None else stage}.0.{leaf}"


def _draw(rng: np.random.RandomState, ref_name: str, shape, bn: bool):
    leaf = ref_name.rsplit(".", 1)[1]
    if bn:
        value = {"weight": 1.0 + 0.2 * rng.randn(*shape),
                 "bias": 0.1 * rng.randn(*shape),
                 "running_mean": 0.2 * rng.randn(*shape),
                 "running_var": 0.5 + rng.rand(*shape)}[leaf]
    elif leaf == "weight" and len(shape) >= 2:
        fan_in = int(np.prod(shape[1:]))
        value = rng.randn(*shape) / np.sqrt(fan_in)
    elif leaf == "weight":            # an embedding table is (num, dim)
        value = rng.randn(*shape)
    else:
        value = 0.1 * rng.randn(*shape)
    return torch.from_numpy(np.asarray(value, np.float32))


def _reference_state(module: torch.nn.Module, rename,
                     rng: np.random.RandomState) -> Dict[str, torch.Tensor]:
    out = {}
    for name, t in module.state_dict().items():
        bn = name.rsplit(".", 1)[1] in ("scale", "running_mean",
                                        "running_var") or (
            ".bns." in name and name.endswith(".bias"))
        ref = rename(name)
        if ref.endswith(".weight") and "embeddings" in ref:
            out[ref] = _draw(rng, ref, tuple(t.shape), False)
            continue
        out[ref] = _draw(rng, ref, tuple(t.shape), bn)
        if bn and ref.endswith(".running_var"):
            out[ref[:-len("running_var")] + "num_batches_tracked"] = \
                torch.tensor(100)
    return out


def reference_state_dicts(cfg: Config, seed: int = 0) -> dict:
    """``{model_state, d_obj_state, d_img_state, d_mask_state}`` of a
    reference-format checkpoint at ``cfg`` (a reference-parity config:
    ``torch_deconv``, one-hot layout channels, the ReLU box head)."""
    rng = np.random.RandomState(seed)
    model, d_img, d_obj, d_mask, _ = build_modules(cfg)
    dc = cfg.discriminator
    return {
        "model_state": _reference_state(
            model, lambda n: _generator_name(n, cfg), rng),
        "d_obj_state": _reference_state(
            d_obj, lambda n: _d_obj_name(n, cfg), rng),
        "d_img_state": _reference_state(
            d_img, lambda n: _multiscale_name(n, dc.n_layers_d), rng),
        "d_mask_state": _reference_state(
            d_mask, lambda n: _multiscale_name(n, dc.n_layers_d_mask), rng),
    }


def reference_checkpoint(cfg: Config, args: dict, vocab: dict,
                         seed: int = 0, counters=None) -> dict:
    """The reference trainer's checkpoint dict: the state dicts of
    ``reference_state_dicts``, ``model_best_state`` a second draw."""
    ckpt = reference_state_dicts(cfg, seed)
    ckpt["model_best_state"] = reference_state_dicts(cfg, seed + 1)[
        "model_state"]
    ckpt.update(vocab=vocab, args=args, optim_state=None,
                counters=counters or {"t": 1200, "epoch": 3})
    return ckpt
