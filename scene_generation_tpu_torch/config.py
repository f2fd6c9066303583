"""Typed configuration tree (a copy of the JAX package's ``config.py``).

The same dataclasses, defaults and JSON form, so a checkpoint's
``config.json`` is read by either package. Two kinds of field are left out
because nothing in this package reads them: the JAX backend switches
(``test_compositor_backend``, ``test_stem_backend``: on a CUDA tensor the
port always runs its kernels, on a CPU tensor their plain versions) and the
XLA compile knobs (``scan_blocks``, ``remat_generator``). ``from_json``
ignores keys it does not know, so JAX configs load unchanged.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional, Tuple

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "float64": torch.float64}


@dataclass(frozen=True)
class DataConfig:
    """Dataset options (reference args.py:18-47)."""
    image_size: Tuple[int, int] = (128, 128)
    mask_size: int = 32
    batch_size: int = 12
    num_train_samples: Optional[int] = None
    num_val_samples: int = 1024
    shuffle_val: bool = True
    coco_dir: str = "datasets/coco"
    train_image_dir: str = "datasets/coco/images/train2017"
    val_image_dir: str = "datasets/coco/images/val2017"
    train_instances_json: str = "datasets/coco/annotations/instances_train2017.json"
    train_stuff_json: str = "datasets/coco/annotations/stuff_train2017.json"
    val_instances_json: str = "datasets/coco/annotations/instances_val2017.json"
    val_stuff_json: str = "datasets/coco/annotations/stuff_val2017.json"
    panoptic_train_json: str = "datasets/coco/annotations/panoptic_train2017.json"
    panoptic_val_json: str = "datasets/coco/annotations/panoptic_val2017.json"
    panoptic_segmentation_train: str = "datasets/coco/panoptic/annotations/panoptic_train2017"
    panoptic_segmentation_val: str = "datasets/coco/panoptic/annotations/panoptic_val2017"
    instance_whitelist: Optional[Tuple[str, ...]] = None
    stuff_whitelist: Optional[Tuple[str, ...]] = None
    include_other: bool = False
    min_object_size: float = 0.02
    min_objects_per_image: int = 3
    max_objects_per_image: int = 8
    stuff_only: bool = True
    is_panoptic: bool = False
    # Padded static-shape contract: one slot is reserved for the dummy
    # __image__ object; triples = one geometric relation per real object +
    # one __in_image__ edge per real object.
    max_objs: int = 9            # max_objects_per_image + 1 (__image__)
    max_triples: int = 16        # 8 relations + 8 __in_image__ edges
    # Attribute encoding: 10 size bins + 5x5 location grid.
    size_attribute_len: int = 10
    grid_size: int = 25

    @property
    def num_attributes(self) -> int:
        return self.size_attribute_len + self.grid_size


@dataclass(frozen=True)
class ModelConfig:
    """Generator stack hyperparameters (reference args.py:49-68)."""
    image_size: Tuple[int, int] = (128, 128)
    mask_size: int = 32
    embedding_dim: int = 128
    gconv_dim: int = 128
    gconv_hidden_dim: int = 512
    gconv_pooling: str = "avg"
    gconv_num_layers: int = 5
    mlp_normalization: str = "none"
    appearance_normalization: str = "batch"
    activation: str = "leakyrelu-0.2"
    n_downsample_global: int = 4
    n_blocks_global: int = 9
    ngf: int = 64
    norm_g: str = "instance"
    box_dim: int = 128
    use_attributes: bool = True
    appearance_arch: str = "C4-64-2,C4-128-2,C4-256-2"
    box_noise_dim: int = 64
    mask_noise_dim: int = 64
    pool_size: int = 100
    rep_size: int = 32
    rep_hidden_size: int = 64
    object_size: int = 64        # appearance-encoder crop size
    output_nc: int = 3
    # Vocab sizes (filled from dataset vocab at build time).
    num_objs: int = 172
    num_preds: int = 7
    num_attributes: int = 35
    # Computation dtype for convs/matmuls (see ``torch_compute_dtype``).
    compute_dtype: str = "float32"
    # True: generator upsampling is torch's ConvTranspose2d(k3, s2, p1,
    # op1). False (default): the flax 'SAME' transpose conv the JAX
    # package's checkpoints were trained with (models/generators.py).
    torch_deconv: bool = False
    # 0: layout class channels are a num_objs one-hot (204 channels in all
    # at COCO scale). >0: a learned class embedding of this width.
    layout_embed_dim: int = 0
    # Route the generator stem through the layout's rank-O factorization
    # (ops/layout.py masks_to_layout_weights + the stem kernel) instead of
    # convolving the materialized (N, H, W, 204) layout. Same function up
    # to float reassociation; False is the dense stem, whose test-mode
    # layout comes from the compositor kernel.
    factored_stem: bool = True
    # Terminal nonlinearity of the box head: "relu" = reference parity,
    # "none" = plain linear output.
    box_net_final: str = "relu"

    @property
    def torch_compute_dtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]

    @property
    def g_mask_dim(self) -> int:
        return self.gconv_dim + self.mask_noise_dim

    @property
    def layout_nc(self) -> int:
        return (self.layout_embed_dim or self.num_objs) + self.rep_size


@dataclass(frozen=True)
class DiscriminatorConfig:
    """Discriminator hyperparameters (reference args.py:81-100)."""
    ndf: int = 64
    num_d: int = 2
    norm_d: str = "instance"
    n_layers_d: int = 3
    no_lsgan: bool = False
    ndf_mask: int = 64
    num_d_mask: int = 1
    norm_d_mask: str = "instance"
    n_layers_d_mask: int = 2
    gan_loss_type: str = "gan"
    d_normalization: str = "batch"
    d_padding: str = "valid"
    d_activation: str = "leakyrelu-0.2"
    d_obj_arch: str = "C4-64-2,C4-128-2,C4-256-2"
    crop_size: int = 32
    # Compute dtype of the three discriminators and the VGG features
    # (parameters stay f32; losses reduce in f32).
    compute_dtype: str = "bfloat16"

    @property
    def torch_compute_dtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]


@dataclass(frozen=True)
class LossConfig:
    """Loss weights (reference args.py:70-79)."""
    l1_pixel_loss_weight: float = 0.0
    bbox_pred_loss_weight: float = 10.0
    vgg_features_weight: float = 10.0
    d_img_weight: float = 1.0
    d_img_features_weight: float = 10.0
    d_mask_weight: float = 1.0
    d_mask_features_weight: float = 10.0
    d_obj_weight: float = 0.1
    ac_loss_weight: float = 0.1
    box_loss_gated: bool = True


@dataclass(frozen=True)
class TrainConfig:
    """Optimization + orchestration (reference args.py:12-16,102-109)."""
    num_iterations: int = 1_000_000
    learning_rate: float = 1e-4
    mask_learning_rate: float = 1e-5
    beta1: float = 0.5
    beta2: float = 0.999
    print_every: int = 100
    checkpoint_every: int = 10_000
    output_dir: str = "output"
    checkpoint_name: str = "checkpoint"
    restore_from_checkpoint: bool = False
    seed: int = 0
    adam_mu_dtype: str = ""
    adam_nu_dtype: str = ""
    grads_dtype: str = ""


@dataclass(frozen=True)
class Config:
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    discriminator: DiscriminatorConfig = field(default_factory=DiscriminatorConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    train: TrainConfig = field(default_factory=TrainConfig)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(s: str) -> "Config":
        d = json.loads(s)

        def _tup(x):
            return tuple(x) if isinstance(x, list) else x

        def _build(cls, sub):
            fields = {f.name for f in dataclasses.fields(cls)}
            return cls(**{k: _tup(v) for k, v in sub.items() if k in fields})

        return Config(
            data=_build(DataConfig, d.get("data", {})),
            model=_build(ModelConfig, d.get("model", {})),
            discriminator=_build(DiscriminatorConfig, d.get("discriminator", {})),
            loss=_build(LossConfig, d.get("loss", {})),
            train=_build(TrainConfig, d.get("train", {})),
        )


def tiny_config() -> Config:
    """Smallest viable config (the JAX package's ``tiny_config``)."""
    return Config(
        data=DataConfig(image_size=(32, 32), mask_size=8, batch_size=4,
                        max_objs=4, max_triples=6, min_objects_per_image=2,
                        max_objects_per_image=3),
        model=ModelConfig(image_size=(32, 32), mask_size=8, embedding_dim=16,
                          gconv_dim=16, gconv_hidden_dim=32, gconv_num_layers=1,
                          n_downsample_global=1, n_blocks_global=1, ngf=4,
                          box_dim=16, mask_noise_dim=8, rep_size=4,
                          rep_hidden_size=8, object_size=16, num_objs=7,
                          num_preds=7, pool_size=3,
                          appearance_arch="C4-8-2,C4-16-2"),
        discriminator=DiscriminatorConfig(ndf=4, ndf_mask=4, num_d=1,
                                          n_layers_d=1, n_layers_d_mask=1,
                                          d_obj_arch="C4-8-2", crop_size=8),
        loss=LossConfig(vgg_features_weight=0.0),
        train=TrainConfig(num_iterations=4, print_every=2, checkpoint_every=4),
    )


def test_config() -> Config:
    """A tiny config for fast CPU tests: 64x64 images, small nets (the JAX
    package's ``test_config``)."""
    return Config(
        data=DataConfig(image_size=(64, 64), mask_size=16, batch_size=2,
                        max_objs=5, max_triples=8),
        model=ModelConfig(image_size=(64, 64), mask_size=16, embedding_dim=32,
                          gconv_dim=32, gconv_hidden_dim=64, gconv_num_layers=2,
                          n_downsample_global=2, n_blocks_global=2, ngf=8,
                          box_dim=32, mask_noise_dim=16, rep_size=8,
                          rep_hidden_size=16, object_size=32, num_objs=12,
                          num_preds=7, pool_size=4,
                          appearance_arch="C4-8-2,C4-16-2,C4-32-2"),
        discriminator=DiscriminatorConfig(ndf=8, ndf_mask=8,
                                          d_obj_arch="C4-8-2,C4-16-2",
                                          crop_size=16),
        train=TrainConfig(num_iterations=10, print_every=5, checkpoint_every=10),
    )
