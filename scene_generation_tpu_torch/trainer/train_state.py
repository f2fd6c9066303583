"""The train state (counterpart of the JAX package's ``Modules`` +
``TrainState``): the generator, the three discriminators, the VGG
features, four Adams, the appearance pool, the step counter and the
random generator of the step's draws, all on one device.

Parameters are f32 and each Adam updates f32 masters, as optax does over
flax's f32 parameters. The compute dtype applies at the matmuls and convs:
the discriminators and VGG cast at each layer to
``DiscriminatorConfig.compute_dtype`` (bf16 by default; explicit casts,
``layers.conv_in``), and the generator computes in
``ModelConfig.compute_dtype`` (f32 by default) under ``torch.autocast``
when that is not f32 (``trainer/step.py``). Serving is unchanged: it
stores its weights in the compute dtype (``model.to(dtype)``).

Optimizers (the reference's): G, D_img and D_obj at ``learning_rate``,
D_mask at ``mask_learning_rate``, betas (beta1, beta2), moments stored in
``adam_mu_dtype`` / ``adam_nu_dtype`` (``trainer/optim.py``).

``state_dict()`` / ``load_state_dict()`` cover everything a step reads
and writes: the four module trees with their batch-norm buffers, the four
optimizers, the pool, ``step`` and the random generator's state (the
step draws its ``use_gt`` coin, mask noise and pool base from it), so a
restored state steps on exactly as the saved one would have (``gen`` None,
as an exported JAX state has it, seeds the generator from the config's
seed). The generator state is the device's: a state saved on the card
resumes on the card. The VGG
features are not in it: they are fixed, rebuilt by ``create_train_state``.
"""
from __future__ import annotations

from typing import Optional

import torch

from scene_generation_tpu_torch import resolve_device
from scene_generation_tpu_torch.config import Config
from scene_generation_tpu_torch.models import SceneModel, init_weights
from scene_generation_tpu_torch.models.discriminators import (
    AcCropDiscriminator, MultiscaleDiscriminator, MultiscaleMaskDiscriminator)
from scene_generation_tpu_torch.models.vgg import (Vgg19Features,
                                                   load_torch_vgg19)
from scene_generation_tpu_torch.parallel.data_parallel import (SINGLE,
                                                               Collectives)
from scene_generation_tpu_torch.trainer.optim import adam
from scene_generation_tpu_torch.trainer.pools import VectorPool, create_pool


class TrainState:
    """Modules, optimizers and state of the adversarial training."""

    def __init__(self, cfg: Config, model: SceneModel,
                 d_img: MultiscaleDiscriminator, d_obj: AcCropDiscriminator,
                 d_mask: MultiscaleMaskDiscriminator,
                 vgg: Optional[Vgg19Features], device: torch.device,
                 seed: int = 0, comm: Collectives = SINGLE):
        t = cfg.train
        self.cfg = cfg
        self.device = device
        # The process group of a data-parallel run (``parallel/``); a
        # single process is the group of one.
        self.comm = comm
        self.model = model.to(device).train()
        self.d_img = d_img.to(device).train()
        self.d_obj = d_obj.to(device).train()
        self.d_mask = d_mask.to(device).train()
        self.vgg = None if vgg is None else vgg.to(device).requires_grad_(
            False)
        self.opt_g = adam(self.model.parameters(), t.learning_rate, t)
        self.opt_d_img = adam(self.d_img.parameters(), t.learning_rate, t)
        self.opt_d_obj = adam(self.d_obj.parameters(), t.learning_rate, t)
        self.opt_d_mask = adam(self.d_mask.parameters(),
                               t.mask_learning_rate, t)
        mc = cfg.model
        self.pool = create_pool(mc.num_objs, mc.pool_size, mc.rep_size,
                                device)
        self.step = 0
        self.gen = torch.Generator(device=device).manual_seed(seed)

    def trees(self):
        """(name, module, optimizer) of each trained parameter tree."""
        return (("g", self.model, self.opt_g),
                ("d_img", self.d_img, self.opt_d_img),
                ("d_obj", self.d_obj, self.opt_d_obj),
                ("d_mask", self.d_mask, self.opt_d_mask))

    def state_dict(self) -> dict:
        """The whole state as a tree of the live tensors (not copies):
        ``{g, d_img, d_obj, d_mask}`` module state dicts, ``opt_<tree>``
        optimizer states, ``pool``, ``step`` and ``gen``."""
        sd = {}
        for name, module, opt in self.trees():
            sd[name] = module.state_dict()
            sd[f"opt_{name}"] = opt.state_dict()
        sd["pool"] = {"vecs": self.pool.vecs, "counts": self.pool.counts}
        sd["step"] = self.step
        sd["gen"] = self.gen.get_state()
        return sd

    def load_state_dict(self, sd: dict) -> None:
        for name, module, opt in self.trees():
            module.load_state_dict(sd[name], strict=True)
            opt.load_state_dict(sd[f"opt_{name}"])
        self.pool = VectorPool(sd["pool"]["vecs"].to(self.device),
                               sd["pool"]["counts"].to(self.device))
        self.step = int(sd["step"])
        if sd["gen"] is None:     # an exported JAX state: no torch stream
            self.gen.manual_seed(self.cfg.train.seed)
        else:
            self.gen.set_state(sd["gen"])


def build_modules(cfg: Config):
    """(model, d_img, d_obj, d_mask, vgg) at ``cfg``, on the CPU, f32,
    before initialisation; ``vgg`` is None without a VGG loss term."""
    mc, dc = cfg.model, cfg.discriminator
    ddtype = dc.torch_compute_dtype
    model = SceneModel(mc)
    d_img = MultiscaleDiscriminator(
        mc.layout_nc + mc.output_nc, ndf=dc.ndf, n_layers=dc.n_layers_d,
        norm=dc.norm_d, use_sigmoid=dc.no_lsgan, num_d=dc.num_d,
        dtype=ddtype)
    d_obj = AcCropDiscriminator(
        mc.num_objs, object_size=dc.crop_size, arch=dc.d_obj_arch,
        normalization=dc.d_normalization, activation=dc.d_activation,
        padding=dc.d_padding, dtype=ddtype)
    d_mask = MultiscaleMaskDiscriminator(
        mc.num_objs, ndf=dc.ndf_mask, n_layers=dc.n_layers_d_mask,
        norm=dc.norm_d_mask, use_sigmoid=dc.no_lsgan, num_d=dc.num_d_mask,
        dtype=ddtype)
    vgg = (Vgg19Features(dtype=ddtype)
           if cfg.loss.vgg_features_weight > 0 else None)
    return model, d_img, d_obj, d_mask, vgg


def create_train_state(cfg: Config, device: Optional[str] = None,
                       seed: int = 0, load_vgg: bool = True,
                       comm: Collectives = SINGLE) -> TrainState:
    """Seed-initialised modules on ``device`` (CUDA unless ``"cpu"``), one
    replica of a data-parallel run under ``comm``.

    With ``load_vgg`` the VGG features load torchvision weights when a file
    is found (``models/vgg.py``), and stay random with a warning when none
    is; without it they stay random."""
    dev = resolve_device(device)
    modules = build_modules(cfg)
    for i, m in enumerate(modules):
        if m is not None:
            init_weights(m, seed + i)
    vgg = modules[-1]
    if vgg is not None and load_vgg and not load_torch_vgg19(vgg):
        print("[scene_generation_tpu_torch] WARNING: no torchvision VGG19 "
              "checkpoint found; perceptual loss uses random projection "
              "features (set SGT_VGG19_WEIGHTS).")
    return TrainState(cfg, *modules, device=dev, seed=seed, comm=comm)
