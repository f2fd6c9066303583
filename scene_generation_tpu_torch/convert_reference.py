"""The paper's own checkpoint in the port: the reference trainer's torch
state dicts onto the port's modules (a copy of the JAX package's
``convert_reference_*`` and of ``config_from_reference_args``).

The reference trainer saves a ``.pt`` dict with ``model_state`` and
``model_best_state`` (the generator ``Model``), ``d_obj_state``,
``d_img_state`` and ``d_mask_state`` (its three discriminators),
``vocab``, ``args`` and ``counters``. Both sides are PyTorch modules with
PyTorch's layouts (Linear (out, in), Conv2d OIHW, ConvTranspose2d
(in, out, kh, kw)), so the map is a table of names; the one change of
values is batch norm's ``scale = weight - 1`` (``MaskedBatchNorm`` stores
the offset from 1, as flax does). The names replay the reference's
``nn.Sequential`` indices:

  build_mlp        Linear at j*stride, BatchNorm1d at j*stride + 1
                   (stride 3 with batch norm, else 2)  -> layers.j, bns.j
  mask_net         Conv j at 4j + 1, BatchNorm2d at 4j + 2, the last
                   Conv at 4L                          -> convs.j, bns.j, out
  build_cnn        conv j after [norm?, act] of every later conv (an
                   instance norm takes an index, 'none' none)
                                                       -> convs.j, bns.j-1
  GlobalGenerator  model.1 (7x7 stem), model.4+3i (downs),
                   model.4+3nd+i.conv_block.{1,5} (resblocks),
                   model.up+3i (ConvTranspose2d), model.up+3nd+1 (head)
  discriminators   discriminator.cnn.{0,2}, real_classifier,
                   obj_classifier; scale{i}_layer{j}.0

Every converter is strict: each reference key is consumed (but batch
norm's ``num_batches_tracked``), a missing one raises by name, and the
result loads into the port's module with ``strict=True``. Ported weights
need the reference-parity config bits (``config_from_reference_args``
forces them): ``torch_deconv=True`` (ConvTranspose2d's own upsampling)
and ``layout_embed_dim=0`` (one-hot layout channels); the converter
refuses a config without them.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Mapping

import torch

from scene_generation_tpu_torch.config import (Config, DataConfig,
                                               DiscriminatorConfig,
                                               LossConfig, ModelConfig,
                                               TrainConfig)

StateDict = Dict[str, torch.Tensor]


class _Reference:
    """Strict key accounting over a reference state dict; values come out
    as float32 tensors on the CPU."""

    def __init__(self, state_dict: Mapping[str, Any]):
        self._sd = {k: torch.as_tensor(v).detach().cpu()
                    for k, v in state_dict.items()}
        self._used = set()

    def take(self, key: str) -> torch.Tensor:
        if key not in self._sd:
            raise KeyError(f"reference state_dict is missing '{key}'")
        self._used.add(key)
        return self._sd[key]

    def finish(self) -> None:
        left = sorted(k for k in self._sd if k not in self._used
                      and not k.endswith("num_batches_tracked"))
        if left:
            raise ValueError("unconverted reference keys (mapping "
                             "incomplete): " + ", ".join(left[:20])
                             + (" ..." if len(left) > 20 else ""))


def _param(ref: _Reference, src: str, dst: str, out: StateDict) -> None:
    """``src.weight`` / ``src.bias`` (a Linear or a conv) as they are."""
    for leaf in ("weight", "bias"):
        out[f"{dst}.{leaf}"] = ref.take(f"{src}.{leaf}").float()


def _bn(ref: _Reference, src: str, dst: str, out: StateDict) -> None:
    # The offset from 1 in the source's precision, then rounded to f32,
    # as the JAX converter computes it.
    out[f"{dst}.scale"] = (ref.take(f"{src}.weight") - 1.0).float()
    out[f"{dst}.bias"] = ref.take(f"{src}.bias").float()
    out[f"{dst}.running_mean"] = ref.take(f"{src}.running_mean").float()
    out[f"{dst}.running_var"] = ref.take(f"{src}.running_var").float()


def _mlp(ref: _Reference, src: str, dst: str, out: StateDict, n_dense: int,
         batch_norm: bool) -> None:
    stride = 3 if batch_norm else 2
    for j in range(n_dense):
        _param(ref, f"{src}.{j * stride}", f"{dst}.layers.{j}", out)
        if batch_norm:
            _bn(ref, f"{src}.{j * stride + 1}", f"{dst}.bns.{j}", out)


def _gconv(ref: _Reference, src: str, dst: str, out: StateDict,
           batch_norm: bool) -> None:
    for net in ("net1", "net2"):
        _mlp(ref, f"{src}.{net}", f"{dst}.{net}", out, 2, batch_norm)


def _cnn(ref: _Reference, src: str, dst: str, out: StateDict, arch: str,
         normalization: str) -> None:
    """A conv-only ``build_cnn``: the first conv has no norm or activation
    before it; every later one has [norm?, activation]."""
    specs = [s for s in arch.split(",") if not s.startswith("I")]
    if any(s[0] != "C" for s in specs):
        raise NotImplementedError(
            f"only conv-only archs are portable (got '{arch}')")
    idx = 0
    for j in range(len(specs)):
        if j > 0:
            if normalization == "batch":
                _bn(ref, f"{src}.{idx}", f"{dst}.bns.{j - 1}", out)
                idx += 1
            elif normalization == "instance":
                idx += 1        # InstanceNorm2d: an index, no parameters
            idx += 1            # the activation
        _param(ref, f"{src}.{idx}", f"{dst}.convs.{j}", out)
        idx += 1


def convert_reference_state_dict(state_dict: Mapping[str, Any],
                                 cfg: ModelConfig) -> StateDict:
    """A reference ``Model.state_dict()`` -> the port's ``SceneModel``
    state_dict (f32, on the CPU). ``cfg`` must describe the reference's
    architecture, with ``torch_deconv=True`` and ``layout_embed_dim=0``."""
    if not cfg.torch_deconv:
        raise ValueError(
            "reference weight ports require torch_deconv=True: the flax "
            "'SAME' transpose conv is a one-pixel-shifted, unflipped "
            "variant that does NOT match ConvTranspose2d")
    if cfg.layout_embed_dim:
        raise ValueError(
            "reference weight ports require layout_embed_dim=0 (one-hot "
            "layout class channels; the learned embedding has no reference "
            "counterpart)")
    ref = _Reference(state_dict)
    out: StateDict = {}
    for name in ("obj_embeddings", "pred_embeddings"):
        out[f"{name}.weight"] = ref.take(f"{name}.weight").float()
    bn = cfg.mlp_normalization == "batch"
    if cfg.gconv_num_layers == 0:
        _param(ref, "gconv", "gconv_linear", out)
    else:
        _gconv(ref, "gconv", "gconv", out, bn)
    for i in range(cfg.gconv_num_layers - 1):
        _gconv(ref, f"gconv_net.gconvs.{i}", f"gconv_net.layers.{i}", out, bn)
    _mlp(ref, "box_net", "box_net", out, 2, bn)
    _mlp(ref, "repr_net", "repr_net", out, 2, bn)

    # mask_net: L x [Interpolate, Conv, BatchNorm2d, ReLU] + a 1x1 Conv;
    # its batch norm is the reference's always.
    n_up = int(math.log2(cfg.mask_size))
    for j in range(n_up):
        _param(ref, f"mask_net.{4 * j + 1}", f"mask_net.convs.{j}", out)
        _bn(ref, f"mask_net.{4 * j + 2}", f"mask_net.bns.{j}", out)
    _param(ref, f"mask_net.{4 * n_up}", "mask_net.out", out)

    # AppearanceEncoder: Sequential(build_cnn, GlobalAvgPool, Linear).
    _cnn(ref, "image_encoder.cnn.0", "image_encoder.cnn", out,
         cfg.appearance_arch, cfg.appearance_normalization)
    _param(ref, "image_encoder.cnn.2", "image_encoder.dense", out)

    # GlobalGenerator: ReflectionPad, the 7x7 stem at 1, [Conv, norm, act]
    # per down, the resblocks, [ConvTranspose2d, norm, act] per up,
    # ReflectionPad and the 7x7 head.
    nd, nb = cfg.n_downsample_global, cfg.n_blocks_global
    src, dst = "layout_to_image.model", "layout_to_image"
    _param(ref, f"{src}.1", f"{dst}.stem.conv", out)
    for i in range(nd):
        _param(ref, f"{src}.{4 + 3 * i}", f"{dst}.downs.{i}", out)
    for i in range(nb):
        block = f"{src}.{4 + 3 * nd + i}.conv_block"
        _param(ref, f"{block}.1", f"{dst}.blocks.{i}.conv1", out)
        _param(ref, f"{block}.5", f"{dst}.blocks.{i}.conv2", out)
    up = 4 + 3 * nd + nb
    for i in range(nd):
        _param(ref, f"{src}.{up + 3 * i}", f"{dst}.ups.{i}", out)
    _param(ref, f"{src}.{up + 3 * nd + 1}", f"{dst}.head", out)
    ref.finish()
    return out


def convert_reference_d_obj(state_dict: Mapping[str, Any],
                            arch: str = "C4-64-2,C4-128-2,C4-256-2",
                            normalization: str = "none") -> StateDict:
    """A reference ``AcCropDiscriminator`` state_dict -> the port's D_obj:
    ``discriminator.cnn`` = Sequential(build_cnn, GlobalAvgPool,
    Linear(D, 1024)) and the ``real_classifier`` / ``obj_classifier``
    heads."""
    ref = _Reference(state_dict)
    out: StateDict = {}
    _cnn(ref, "discriminator.cnn.0", "discriminator.cnn", out, arch,
         normalization)
    for src, dst in (("cnn.2", "dense"), ("real_classifier", "real"),
                     ("obj_classifier", "obj")):
        _param(ref, f"discriminator.{src}", f"discriminator.{dst}", out)
    ref.finish()
    return out


def convert_reference_multiscale_d(state_dict: Mapping[str, Any],
                                   num_d: int, n_layers: int,
                                   mask: bool = False) -> StateDict:
    """A reference ``MultiscaleDiscriminator`` (``mask=False``, the image
    PatchGAN) or ``MultiscaleMaskDiscriminator`` (``mask=True``)
    state_dict -> the port's D_img or D_mask. Per scale i and stage j the
    reference's conv sits at ``scale{i}_layer{j}.0`` (its instance norm
    holds no parameters)."""
    names = ([f"downs.{j}" for j in range(n_layers)]
             + ["penultimate", "head"] if mask
             else [f"convs.{j}" for j in range(n_layers + 2)])
    ref = _Reference(state_dict)
    out: StateDict = {}
    for i in range(num_d):
        for j, name in enumerate(names):
            _param(ref, f"scale{i}_layer{j}.0", f"scales.scale_{i}.{name}",
                   out)
    ref.finish()
    return out


def convert_reference_discriminators(ckpt: Mapping[str, Any],
                                     dc: DiscriminatorConfig) -> dict:
    """``{"d_obj": ..., "d_img": ..., "d_mask": ...}``: each of the
    checkpoint's discriminator states that is present and not empty,
    converted."""
    out = {}
    if ckpt.get("d_obj_state"):
        out["d_obj"] = convert_reference_d_obj(
            ckpt["d_obj_state"], arch=dc.d_obj_arch,
            normalization=dc.d_normalization)
    if ckpt.get("d_img_state"):
        out["d_img"] = convert_reference_multiscale_d(
            ckpt["d_img_state"], num_d=dc.num_d, n_layers=dc.n_layers_d)
    if ckpt.get("d_mask_state"):
        out["d_mask"] = convert_reference_multiscale_d(
            ckpt["d_mask_state"], num_d=dc.num_d_mask,
            n_layers=dc.n_layers_d_mask, mask=True)
    return out


def config_from_reference_args(ref_args: Mapping[str, Any], vocab: Mapping,
                               compute_dtype: str) -> Config:
    """The reference's ``args`` (the checkpoint's ``args`` dict) as the
    port's ``Config``, with the reference-parity bits forced:
    ``torch_deconv`` (ConvTranspose2d), one-hot layout channels, the
    terminal-ReLU box head."""

    def get(key, default):
        return ref_args.get(key, default) if ref_args else default

    size = tuple(get("image_size", (128, 128)))
    model = ModelConfig(
        image_size=size,
        mask_size=get("mask_size", 32),
        num_objs=len(vocab["object_to_idx"]),
        num_preds=len(vocab["pred_idx_to_name"]),
        num_attributes=vocab.get("num_attributes", 35),
        use_attributes=bool(get("use_attributes", True)),
        embedding_dim=get("embedding_dim", 128),
        gconv_dim=get("gconv_dim", 128),
        gconv_hidden_dim=get("gconv_hidden_dim", 512),
        gconv_num_layers=get("gconv_num_layers", 5),
        mlp_normalization=get("mlp_normalization", "none"),
        appearance_normalization=get("appearance_normalization", "batch"),
        activation=get("activation", "leakyrelu-0.2"),
        n_downsample_global=get("n_downsample_global", 4),
        box_dim=get("box_dim", 128),
        mask_noise_dim=get("mask_noise_dim", 64),
        rep_size=get("rep_size", 32),
        output_nc=get("output_nc", 3),
        compute_dtype=compute_dtype,
        # Reference parity, required by the converted weights:
        torch_deconv=True, layout_embed_dim=0, box_net_final="relu")
    if model.num_attributes != DataConfig().num_attributes:
        print(f"WARNING: checkpoint num_attributes={model.num_attributes} "
              f"differs from the data pipeline's "
              f"{DataConfig().num_attributes} (10 size bins + 5x5 grid); "
              "eval batches must provide matching attribute widths")
    disc = DiscriminatorConfig(
        ndf=get("ndf", 64), num_d=get("num_D", 2),
        n_layers_d=get("n_layers_D", 3), norm_d=get("norm_D", "instance"),
        ndf_mask=get("ndf_mask", 64), num_d_mask=get("num_D_mask", 1),
        norm_d_mask=get("norm_D_mask", "instance"),
        n_layers_d_mask=get("n_layers_D_mask", 2),
        no_lsgan=bool(get("no_lsgan", False)),
        d_obj_arch=get("d_obj_arch", "C4-64-2,C4-128-2,C4-256-2"),
        d_normalization=get("d_normalization", "batch"),
        d_padding=get("d_padding", "valid"),
        d_activation=get("d_activation", "leakyrelu-0.2"),
        crop_size=get("crop_size", 32))
    return Config(
        data=DataConfig(image_size=size, mask_size=model.mask_size,
                        batch_size=int(get("batch_size", 12))),
        model=model, discriminator=disc, loss=LossConfig(),
        train=TrainConfig(output_dir="", checkpoint_name="checkpoint"))
