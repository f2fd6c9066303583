"""Weights into and out of the port.

``state_dict_from_jax`` maps the JAX package's ``SceneModel`` variables
(``{"params": ..., "batch_stats": ...}`` as nested dicts of numpy arrays,
the output of ``jax.device_get``) onto this package's ``SceneModel``
state_dict; its siblings do the same for the rest of the JAX train state
(``d_img_state_dict_from_jax``, ``d_obj_state_dict_from_jax``,
``d_mask_state_dict_from_jax``, ``vgg_state_dict_from_jax``,
``pool_from_jax``), so that both packages can step from one state, and
``inception_state_dict_from_jax`` maps the evaluation's InceptionV3,
``resnet_state_dict_from_jax`` the accuracy net, ``lpips_state_dict_from_jax``
the diversity metric's VGG16 and lin layers and ``shallow_kernels_from_jax``
the FID fallback's kernels. Every
map is linear in the leaves, so it carries an optimizer's moment trees
(which have the parameters' structure) across as well:

  Dense           kernel (in, out)        -> weight (out, in)
  Conv            kernel HWIO             -> weight OIHW
  ConvTranspose   'SAME' (flax layout)    kernel (kh, kw, in, out)
                                          -> flip_hw(kernel) as (in, out, kh, kw)
                  torch_deconv            kernel (kh, kw, out, in)
                                          -> (in, out, kh, kw)
  Embed           embedding               -> weight
  MaskedBatchNorm scale (offset from 1), bias, batch_stats mean / var
                                          -> scale, bias, running_mean / var

Scan-stacked trees (``gconv_net/layers/gconv``, ``resblocks/block``) are
split along their leading axis; unrolled ``resblock_i`` are taken as they
are. The map is strict: a key it does not consume, or one it needs and
does not find, raises.

``adam_state_from_jax`` carries an optax ``ScaleByAdamState`` (count, mu,
nu) onto the port's optimizer state the same way.

The port has one checkpoint format, the train CLI's
(``trainer/checkpoint.py``): ``<output_dir>/<checkpoint_name>/{last,best}/
state.pt`` and ``meta.json``. ``save_checkpoint`` writes a serving
checkpoint in it (the ``g`` tree alone and a meta with the config and
vocab) and ``load_checkpoint`` reads the generator of any checkpoint in it.
"""
from __future__ import annotations

import json
import math
import os
from typing import (Any, Callable, Dict, Mapping, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from scene_generation_tpu_torch import resolve_device
from scene_generation_tpu_torch.config import (Config, DiscriminatorConfig,
                                               ModelConfig)
from scene_generation_tpu_torch.models.model import SceneModel
from scene_generation_tpu_torch.trainer.checkpoint import CheckpointManager
from scene_generation_tpu_torch.trainer.pools import VectorPool


def _flatten(tree: Mapping[str, Any], prefix: str,
             out: Dict[str, np.ndarray]) -> None:
    for k, v in tree.items():
        key = f"{prefix}/{k}"
        if isinstance(v, Mapping):
            _flatten(v, key, out)
        else:
            out[key] = np.asarray(v)


class _Vars:
    """Strict key accounting over flattened ``collection/path/leaf`` keys."""

    def __init__(self, flat: Dict[str, np.ndarray]):
        self._flat = flat
        self._used = set()

    def take(self, key: str) -> np.ndarray:
        if key not in self._flat:
            raise KeyError(f"JAX variables are missing '{key}'")
        self._used.add(key)
        return self._flat[key]

    def has(self, prefix: str) -> bool:
        return any(k.startswith(prefix + "/") for k in self._flat)

    def layer(self, prefixes: Tuple[str, ...], i: int) -> "_Vars":
        """Slice ``i`` of every scan-stacked leaf under ``prefixes``."""
        sub = {}
        for k, v in self._flat.items():
            if any(k.startswith(p + "/") for p in prefixes):
                self._used.add(k)
                sub[k] = v[i]
        return _Vars(sub)

    def finish(self) -> None:
        left = sorted(k for k in self._flat if k not in self._used)
        if left:
            raise ValueError("JAX variables the port does not use: "
                             + ", ".join(left[:20])
                             + (" ..." if len(left) > 20 else ""))


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _dense(v: _Vars, j: str, p: str, sd: Dict) -> None:
    sd[f"{p}.weight"] = _t(v.take(f"params/{j}/kernel").T)
    sd[f"{p}.bias"] = _t(v.take(f"params/{j}/bias"))


def _conv(v: _Vars, j: str, p: str, sd: Dict) -> None:
    sd[f"{p}.weight"] = _t(v.take(f"params/{j}/kernel").transpose(3, 2, 0, 1))
    sd[f"{p}.bias"] = _t(v.take(f"params/{j}/bias"))


def _deconv(v: _Vars, j: str, p: str, sd: Dict, torch_deconv: bool) -> None:
    k = v.take(f"params/{j}/kernel")
    k = k.transpose(3, 2, 0, 1) if torch_deconv else \
        k[::-1, ::-1].transpose(2, 3, 0, 1)
    sd[f"{p}.weight"] = _t(k)
    sd[f"{p}.bias"] = _t(v.take(f"params/{j}/bias"))


def _bn(v: _Vars, j: str, p: str, sd: Dict) -> None:
    sd[f"{p}.scale"] = _t(v.take(f"params/{j}/scale"))
    sd[f"{p}.bias"] = _t(v.take(f"params/{j}/bias"))
    sd[f"{p}.running_mean"] = _t(v.take(f"batch_stats/{j}/mean"))
    sd[f"{p}.running_var"] = _t(v.take(f"batch_stats/{j}/var"))


def _mlp(v: _Vars, j: str, p: str, sd: Dict, n_dense: int, n_bn: int) -> None:
    for i in range(n_dense):
        _dense(v, f"{j}/Dense_{i}", f"{p}.layers.{i}", sd)
    for i in range(n_bn):
        _bn(v, f"{j}/MaskedBatchNorm_{i}", f"{p}.bns.{i}", sd)


def _gconv(v: _Vars, j: str, p: str, sd: Dict, bn: bool) -> None:
    for net in ("net1", "net2"):
        _mlp(v, f"{j}/{net}", f"{p}.{net}", sd, 2, 2 if bn else 0)


def _collect(variables: Mapping[str, Any]) -> _Vars:
    flat: Dict[str, np.ndarray] = {}
    for coll in ("params", "batch_stats"):
        _flatten(variables.get(coll, {}), coll, flat)
    unknown = sorted(set(variables) - {"params", "batch_stats"})
    if unknown:
        raise ValueError(f"unknown variable collections {unknown}")
    return _Vars(flat)


def _cnn(v: _Vars, j: str, p: str, sd: Dict, arch: str,
         normalization: str) -> None:
    """A conv-only ``CNN`` (``CNN_0`` in flax) onto ``models.layers.CNN``."""
    n_convs = len([s for s in arch.split(",") if not s.startswith("I")])
    for i in range(n_convs):
        _conv(v, f"{j}/Conv_{i}", f"{p}.convs.{i}", sd)
        if i and normalization == "batch":
            _bn(v, f"{j}/MaskedBatchNorm_{i - 1}", f"{p}.bns.{i - 1}", sd)


def state_dict_from_jax(variables: Mapping[str, Any],
                        cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """The JAX ``SceneModel`` variables -> this package's state_dict (f32).

    ``variables`` must hold every parameter of the model, the appearance
    encoder's included (as a train-mode ``init`` or a trained checkpoint
    does).
    """
    v = _collect(variables)
    sd: Dict[str, torch.Tensor] = {}
    bn = cfg.mlp_normalization == "batch"
    n_bn = 2 if bn else 0

    for name in ("obj_embeddings", "pred_embeddings") + (
            ("class_embed",) if cfg.layout_embed_dim else ()):
        sd[f"{name}.weight"] = _t(v.take(f"params/{name}/embedding"))
    if cfg.gconv_num_layers == 0:
        _dense(v, "gconv_linear", "gconv_linear", sd)
    else:
        _gconv(v, "gconv", "gconv", sd, bn)
    if cfg.gconv_num_layers > 1:
        stacked = ("params/gconv_net/layers/gconv",
                   "batch_stats/gconv_net/layers/gconv")
        for i in range(cfg.gconv_num_layers - 1):
            layer = v.layer(stacked, i)
            _gconv(layer, "gconv_net/layers/gconv", f"gconv_net.layers.{i}",
                   sd, bn)
            layer.finish()

    box_bn = (2 if cfg.box_net_final == "relu" else 1) if bn else 0
    _mlp(v, "box_net", "box_net", sd, 2, box_bn)
    _mlp(v, "repr_net", "repr_net", sd, 2, n_bn)

    n_up = int(math.log2(cfg.mask_size))
    for i in range(n_up):
        _conv(v, f"mask_net/Conv_{i}", f"mask_net.convs.{i}", sd)
        _bn(v, f"mask_net/MaskedBatchNorm_{i}", f"mask_net.bns.{i}", sd)
    _conv(v, f"mask_net/Conv_{n_up}", "mask_net.out", sd)

    _cnn(v, "image_encoder/CNN_0", "image_encoder.cnn", sd,
         cfg.appearance_arch, cfg.appearance_normalization)
    _dense(v, "image_encoder/Dense_0", "image_encoder.dense", sd)

    g, nd = "layout_to_image", cfg.n_downsample_global
    _conv(v, f"{g}/Conv_0", f"{g}.stem.conv", sd)
    for i in range(nd):
        _conv(v, f"{g}/Conv_{i + 1}", f"{g}.downs.{i}", sd)
    if v.has(f"params/{g}/resblocks"):
        for i in range(cfg.n_blocks_global):
            block = v.layer((f"params/{g}/resblocks/block",), i)
            _conv(block, f"{g}/resblocks/block/Conv_0",
                  f"{g}.blocks.{i}.conv1", sd)
            _conv(block, f"{g}/resblocks/block/Conv_1",
                  f"{g}.blocks.{i}.conv2", sd)
            block.finish()
    else:
        for i in range(cfg.n_blocks_global):
            _conv(v, f"{g}/resblock_{i}/Conv_0", f"{g}.blocks.{i}.conv1", sd)
            _conv(v, f"{g}/resblock_{i}/Conv_1", f"{g}.blocks.{i}.conv2", sd)
    for i in range(nd):
        _deconv(v, f"{g}/ConvTranspose_{i}", f"{g}.ups.{i}", sd,
                cfg.torch_deconv)
    _conv(v, f"{g}/Conv_{nd + 1}", f"{g}.head", sd)
    v.finish()
    return sd


def _multiscale(params: Mapping[str, Any], num_d: int, n_layers: int,
                names) -> Dict[str, torch.Tensor]:
    v = _collect({"params": params})
    sd: Dict[str, torch.Tensor] = {}
    for s in range(num_d):
        for j, name in enumerate(names(n_layers)):
            _conv(v, f"scale_{s}/Conv_{j}", f"scales.scale_{s}.{name}", sd)
    v.finish()
    return sd


def d_img_state_dict_from_jax(params: Mapping[str, Any],
                              dc: DiscriminatorConfig
                              ) -> Dict[str, torch.Tensor]:
    """JAX ``MultiscaleDiscriminator`` params -> the port's D_img."""
    return _multiscale(params, dc.num_d, dc.n_layers_d,
                       lambda n: [f"convs.{j}" for j in range(n + 2)])


def d_mask_state_dict_from_jax(params: Mapping[str, Any],
                               dc: DiscriminatorConfig
                               ) -> Dict[str, torch.Tensor]:
    """JAX ``MultiscaleMaskDiscriminator`` params -> the port's D_mask."""
    return _multiscale(params, dc.num_d_mask, dc.n_layers_d_mask,
                       lambda n: [f"downs.{j}" for j in range(n)]
                       + ["penultimate", "head"])


def d_obj_state_dict_from_jax(variables: Mapping[str, Any],
                              dc: DiscriminatorConfig
                              ) -> Dict[str, torch.Tensor]:
    """JAX ``AcCropDiscriminator`` variables (params + batch_stats) -> the
    port's D_obj."""
    v = _collect(variables)
    sd: Dict[str, torch.Tensor] = {}
    _cnn(v, "discriminator/CNN_0", "discriminator.cnn", sd, dc.d_obj_arch,
         dc.d_normalization)
    for j, name in enumerate(("dense", "real", "obj")):
        _dense(v, f"discriminator/Dense_{j}", f"discriminator.{name}", sd)
    v.finish()
    return sd


def vgg_state_dict_from_jax(params: Mapping[str, Any]
                            ) -> Dict[str, torch.Tensor]:
    """JAX ``Vgg19Features`` params -> the port's."""
    v = _collect({"params": params})
    sd: Dict[str, torch.Tensor] = {}
    for name in params:
        _conv(v, name, f"convs.{name}", sd)
    v.finish()
    return sd


def inception_state_dict_from_jax(variables: Mapping[str, Any]
                                  ) -> Dict[str, torch.Tensor]:
    """The JAX package's flax ``InceptionV3`` variables (params +
    batch_stats) -> the port's ``models.inception.InceptionV3`` (the
    torchvision names: ``<block>.<branch>.conv.weight``, ``.bn.weight`` /
    ``bias`` / ``running_mean`` / ``running_var``, ``fc``)."""
    v = _collect(variables)
    sd: Dict[str, torch.Tensor] = {}
    for key in sorted(k for k in v._flat if k.startswith("params/")):
        path = key.split("/")[1:]
        name, leaf = ".".join(path[:-1]), path[-1]
        if path[-2] == "conv":
            sd[f"{name}.weight"] = _t(v.take(key).transpose(3, 2, 0, 1))
        elif path[-2] == "bn":
            sd[f"{name}.{'weight' if leaf == 'scale' else 'bias'}"] = \
                _t(v.take(key))
            if leaf == "scale":
                base = "/".join(path[:-1])
                sd[f"{name}.running_mean"] = _t(
                    v.take(f"batch_stats/{base}/mean"))
                sd[f"{name}.running_var"] = _t(
                    v.take(f"batch_stats/{base}/var"))
                sd[f"{name}.num_batches_tracked"] = torch.tensor(0)
        elif leaf == "kernel":                                   # fc
            sd[f"{name}.weight"] = _t(v.take(key).T)
        else:
            sd[f"{name}.bias"] = _t(v.take(key))
    v.finish()
    return sd


def resnet_state_dict_from_jax(variables: Mapping[str, Any]
                               ) -> Dict[str, torch.Tensor]:
    """The JAX package's flax ``ResNet`` variables (the accuracy net:
    params + batch_stats) -> the port's ``models.resnet.ResNet``, whose
    names are torchvision's: ``layer{s}_{b}`` -> ``layer{s}.{b}``,
    ``downsample_conv`` / ``downsample_bn`` -> ``downsample.0`` / ``.1``,
    BN ``scale`` / ``mean`` / ``var`` -> ``weight`` / ``running_mean`` /
    ``running_var``."""
    v = _collect(variables)
    sd: Dict[str, torch.Tensor] = {}

    def name(path) -> str:
        out = []
        for part in path:
            if part.startswith("layer") and "_" in part:
                out += part.split("_")
            elif part in ("downsample_conv", "downsample_bn"):
                out += ["downsample", "0" if part.endswith("conv") else "1"]
            else:
                out.append(part)
        return ".".join(out)

    for key in sorted(k for k in v._flat if k.startswith("params/")):
        path = key.split("/")[1:]
        mod, leaf = name(path[:-1]), path[-1]
        if path[:-1] == ["fc"]:
            sd[f"fc.{'weight' if leaf == 'kernel' else 'bias'}"] = _t(
                v.take(key).T if leaf == "kernel" else v.take(key))
        elif leaf == "kernel":
            sd[f"{mod}.weight"] = _t(v.take(key).transpose(3, 2, 0, 1))
        elif leaf == "scale":
            base = "/".join(path[:-1])
            sd[f"{mod}.weight"] = _t(v.take(key))
            sd[f"{mod}.running_mean"] = _t(v.take(f"batch_stats/{base}/mean"))
            sd[f"{mod}.running_var"] = _t(v.take(f"batch_stats/{base}/var"))
            sd[f"{mod}.num_batches_tracked"] = torch.tensor(0)
        else:
            sd[f"{mod}.bias"] = _t(v.take(key))
    v.finish()
    return sd


def lpips_state_dict_from_jax(params: Mapping[str, Any],
                              lins: Sequence[np.ndarray]
                              ) -> Dict[str, torch.Tensor]:
    """The JAX package's ``Vgg16Features`` params (``conv0`` ... ``conv12``)
    and its five LPIPS lin weight vectors -> the port's
    ``metrics_lpips.LPIPS``."""
    v = _collect({"params": params})
    sd: Dict[str, torch.Tensor] = {}
    for name in params:
        _conv(v, name, f"vgg.{name}", sd)
    v.finish()
    if len(lins) != 5:
        raise ValueError(f"LPIPS has 5 lin layers, got {len(lins)}")
    for i, w in enumerate(lins):
        sd[f"lin{i}"] = _t(np.asarray(w).reshape(-1))
    return sd


def shallow_kernels_from_jax(kernels: Sequence[Any]) -> list:
    """The JAX package's shallow FID extractor's four HWIO conv kernels
    (``metrics_fid.create_shallow_features_fn``) -> OIHW tensors for the
    port's ``metrics_fid.create_shallow_features_fn(kernels=)``."""
    return [_t(np.asarray(k).transpose(3, 2, 0, 1)) for k in kernels]


def pool_from_jax(pool: Any, device=None) -> VectorPool:
    """The JAX ``VectorPoolState`` (vecs, counts) -> the port's pool."""
    vecs, counts = pool
    return VectorPool(torch.from_numpy(np.array(vecs, np.float32)).to(device),
                      torch.from_numpy(np.array(counts, np.int64)).to(device))


def adam_state_from_jax(adam_state: Any, tree_from_jax: Callable,
                        params: Sequence[Tuple[str, torch.Tensor]]) -> dict:
    """An optax ``ScaleByAdamState`` (``count``, ``mu``, ``nu``; the first
    entry of an ``optax.adam`` chain state) -> the port's optimizer state
    for the parameters ``params`` (``named_parameters()`` of the module).

    ``tree_from_jax`` maps a tree of the JAX parameters' structure onto the
    module's state_dict keys (``state_dict_from_jax`` and its siblings;
    for the generator and D_obj it needs the ``batch_stats`` too, which the
    caller supplies). Moments keep their stored dtype."""
    count = int(np.asarray(adam_state.count))
    sd = {}
    for name in ("mu", "nu"):
        tree = tree_from_jax(getattr(adam_state, name))
        dtype = _torch_dtype(_first_leaf(getattr(adam_state, name)).dtype)
        sd[name] = [tree[k].to(dtype) for k, _ in params]
    return {"count": count, "mu": sd["mu"], "nu": sd["nu"]}


def _first_leaf(tree: Any):
    while isinstance(tree, Mapping):
        tree = next(iter(tree.values()))
    return np.asarray(tree)


def _torch_dtype(dtype) -> torch.dtype:
    name = np.dtype(dtype).name
    return {"float32": torch.float32, "float16": torch.float16,
            "bfloat16": torch.bfloat16}[name]


def save_checkpoint(output_dir: str, model: SceneModel, cfg: Config,
                    vocab: Dict, checkpoint_name: str = "checkpoint",
                    best: bool = False) -> None:
    """Write a serving checkpoint of ``model`` in the train CLI's layout:
    ``<output_dir>/<checkpoint_name>/last/state.pt`` (``best/`` with
    ``best``) holding ``{"g": state_dict}`` (f32, on the CPU), and
    ``meta.json`` with ``cfg`` and ``vocab``."""
    ckpt = CheckpointManager(output_dir, checkpoint_name, use_async=False)
    sd = {k: t.detach().float().cpu() for k, t in model.state_dict().items()}
    ckpt.save({"g": sd}, best=best)
    ckpt.save_meta(ckpt.new_meta(cfg, vocab))


def load_checkpoint(output_dir: str, device: Optional[str] = None,
                    checkpoint_name: str = "checkpoint", best: bool = False
                    ) -> Tuple[Config, Dict, SceneModel]:
    """The config, the vocab and the generator of a checkpoint in the
    train CLI's layout (a training run's or ``save_checkpoint``'s): the
    model on ``device`` (CUDA unless ``device="cpu"``) in the config's
    compute dtype, in eval mode."""
    dev = resolve_device(device)
    ckpt = CheckpointManager(output_dir, checkpoint_name, use_async=False)
    meta = ckpt.load_meta()
    if meta is None:
        raise FileNotFoundError(f"no checkpoint meta under {ckpt.root}")
    path = ckpt.state_path(best)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no checkpoint state at {path}")
    cfg = Config.from_json(json.dumps(meta["config"]))
    model = SceneModel(cfg.model)
    # mmap: only the generator's tensors of a whole train state are read.
    state = torch.load(path, map_location="cpu", weights_only=True,
                       mmap=True)
    model.load_state_dict(state["g"], strict=True)
    model = model.to(device=dev, dtype=cfg.model.torch_compute_dtype).eval()
    return cfg, meta["vocab"], model
