"""The adversarial train step (port of the JAX package's
``trainer/step.py``), in its order:

  1. G forward (train mode) and loss: box MSE gated by ``use_gt``, VGG
     perceptual, D_obj GAN + AC on the fake image with the GT boxes (train
     mode, so D_obj's batch statistics move), D_mask GAN + feature
     matching, D_img GAN + feature matching -> Adam on G.
  2. Appearance pool query -> the wrong-texture layout.
  3. D_mask update.
  4. D_obj update: the fake pass, then the real pass (the order of its
     batch-statistics updates).
  5. D_img update: fake 0.25 + wrong texture 0.25 + real 0.5.

``.detach()`` stands where the JAX step has ``stop_gradient``. Each update
differentiates its loss with respect to its own parameters only
(``optim.step``), so the discriminators' probes inside the G loss leave
their gradients alone, as the JAX step's ``value_and_grad`` over
``g_params`` does.

The step's random draws (the ``use_gt`` coin that zeroes attributes, the
shared mask noise and the pool's read base) come from the state's
generator, or from ``draws`` where a caller injects them. Each phase runs
inside a ``torch.profiler.record_function`` range named
``train_step/<phase>``, so a profile splits the step by phase (a no-op
without a profiler).
"""
from __future__ import annotations

import contextlib
from typing import Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from scene_generation_tpu_torch import losses as L
from scene_generation_tpu_torch.config import ModelConfig
from scene_generation_tpu_torch.data.batching import Batch
from scene_generation_tpu_torch.ops.images import wire_to_float
from scene_generation_tpu_torch.ops.layout import masks_to_layout
from scene_generation_tpu_torch.trainer import optim
from scene_generation_tpu_torch.parallel import data_parallel
from scene_generation_tpu_torch.trainer.pools import (draw_base,
                                                      pool_query_gathered)
from scene_generation_tpu_torch.trainer.train_state import TrainState

TrainMetrics = Dict[str, torch.Tensor]


class Draws(NamedTuple):
    use_gt: torch.Tensor        # () float, 1.0 or 0.0
    mask_noise: torch.Tensor    # (mask_noise_dim,)
    pool_base: torch.Tensor     # (num_objs,) int


def draw(state: TrainState) -> Draws:
    """The step's draws from the state's generator, on its device."""
    mc = state.cfg.model
    dev = state.device
    use_gt = (torch.rand((), generator=state.gen, device=dev) < 0.5).float()
    noise = torch.randn((mc.mask_noise_dim,), generator=state.gen,
                        device=dev)
    return Draws(use_gt, noise, draw_base(state.pool, state.gen))


def batch_to(batch: Batch, device: torch.device) -> Batch:
    return Batch(*(torch.as_tensor(a, device=device) for a in batch))


def generator_dtype(mc: ModelConfig, device: torch.device):
    """The generator's compute dtype: f32 runs as it is, another dtype
    under ``torch.autocast`` (parameters stay f32)."""
    dtype = mc.torch_compute_dtype
    if dtype == torch.float32:
        return contextlib.nullcontext()
    return torch.autocast(device.type, dtype=dtype)


def _params(opt: torch.optim.Optimizer):
    return opt.param_groups[0]["params"]


def train_step(state: TrainState, batch: Batch,
               draws: Optional[Draws] = None) -> TrainMetrics:
    """One G update and the three D updates, in place on ``state``.

    Returns the JAX step's metrics (detached tensors on the device). Under
    data parallelism (``state.comm``) ``batch`` is this rank's slice of
    the global batch, the step is the global batch's, and each loss metric
    is this rank's share of the global loss (the shares sum to it)."""
    b = batch_to(batch, state.device)
    with data_parallel.step_shard(state.comm, b.obj_mask):
        return _train_step(state, b, draws)


def _train_step(state: TrainState, b: Batch,
                draws: Optional[Draws]) -> TrainMetrics:
    cfg = state.cfg
    mc, lw, dc = cfg.model, cfg.loss, cfg.discriminator
    gan_g_loss, gan_d_loss = L.get_gan_losses(dc.gan_loss_type)
    use_lsgan = not dc.no_lsgan
    h, w = mc.image_size
    dev = state.device
    d = draw(state) if draws is None else Draws(
        *(torch.as_tensor(t, device=dev) for t in draws))
    use_gt = d.use_gt.float()
    # The gradients' storage dtype at the backward-to-optimizer boundary
    # (the moment math promotes it back, as optax does).
    gd = optim.storage_dtype(cfg.train.grads_dtype)

    imgs = wire_to_float(b.imgs)
    objs, boxes, masks, obj_mask = b.objs, b.boxes, b.masks, b.obj_mask
    n, o = objs.shape
    flat_w = obj_mask.reshape(n * o)
    one_hot_flat = F.one_hot(objs.reshape(n * o).long(), mc.num_objs).float()
    masks_flat = masks.reshape(n * o, mc.mask_size, mc.mask_size, 1)
    metrics: TrainMetrics = {}

    # 1. Generator update: forward, losses (VGG and the three D probes),
    # backward and Adam.
    with record_function("train_step/g_forward"):
        with generator_dtype(mc, dev):
            out = state.model(objs, b.triples, b.attributes * use_gt,
                              obj_mask, b.triple_mask, d.mask_noise.float(),
                              imgs=imgs, boxes_gt=boxes, masks_gt=masks)
    with record_function("train_step/g_losses"):
        terms = {}
        if lw.l1_pixel_loss_weight > 0:
            terms["L1_pixel_loss"] = (L.l1_loss(out.imgs_pred, imgs)
                                      * use_gt * lw.l1_pixel_loss_weight)
        box_gate = use_gt if lw.box_loss_gated else 1.0
        terms["bbox_pred"] = (L.mse_loss(out.boxes_pred, boxes, w=obj_mask)
                              * box_gate * lw.bbox_pred_loss_weight)
        if state.vgg is not None:
            fx = state.vgg(out.imgs_pred)
            with torch.no_grad():
                fy = state.vgg(imgs)
            terms["g_vgg"] = (L.vgg_perceptual_loss(fx, fy)
                              * lw.vgg_features_weight)

        scores_fake, logits_fake, _ = state.d_obj(out.imgs_pred, boxes,
                                                  obj_mask)
        terms["ac_loss"] = (L.masked_cross_entropy(logits_fake, objs,
                                                   w=obj_mask)
                            * lw.ac_loss_weight)
        terms["g_gan_obj_loss"] = (gan_g_loss(scores_fake, w=obj_mask)
                                   * lw.d_obj_weight)

        masks_pred_flat = out.masks_pred.reshape(n * o, mc.mask_size,
                                                 mc.mask_size, 1)
        scores_fake_m = state.d_mask(masks_pred_flat, one_hot_flat)
        terms["g_gan_mask_obj_loss"] = (
            L.multiscale_gan_loss(scores_fake_m, True, use_lsgan, w=flat_w)
            * lw.d_mask_weight)
        if lw.d_mask_features_weight > 0:
            scores_real_m = state.d_mask(masks_flat, one_hot_flat)
            terms["g_mask_features_loss"] = (
                L.feature_matching_loss(scores_fake_m, scores_real_m,
                                        w=flat_w)
                * lw.d_mask_features_weight)

        # D_img: the real probe (feature targets) on the layout as it is,
        # the fake on the detached layout.
        pred_real = state.d_img(torch.cat([out.layout, imgs], -1))
        pred_fake = state.d_img(torch.cat([out.layout.detach(),
                                           out.imgs_pred], -1))
        terms["g_gan_img_loss"] = (L.multiscale_gan_loss(pred_fake, True,
                                                         use_lsgan)
                                   * lw.d_img_weight)
        if lw.d_img_features_weight > 0:
            terms["g_gan_features_loss_img"] = (
                L.feature_matching_loss(pred_fake, pred_real)
                * lw.d_img_features_weight)
        total = torch.zeros((), device=dev)
        for v in terms.values():
            total = total + v
    with record_function("train_step/g_backward"):
        optim.step(state.opt_g, total, _params(state.opt_g), gd)
    metrics.update(terms)
    metrics["total_loss"] = total

    # Everything from the G forward is a constant now.
    imgs_pred_d = out.imgs_pred.detach()
    masks_pred_d = out.masks_pred.detach()
    layout_d = out.layout.detach()

    # 2. Appearance pool -> wrong-texture layout.
    with record_function("train_step/pool"):
        query_args = (state.pool, d.pool_base, objs.reshape(n * o),
                      out.obj_repr.detach().reshape(n * o, mc.rep_size),
                      flat_w)
        wrong_rep, state.pool = pool_query_gathered(state.comm,
                                                    *query_args)
        wrong_vecs = torch.cat([out.cls_vecs.detach(),
                                wrong_rep.reshape(n, o, mc.rep_size)], -1)
        layout_wrong = masks_to_layout(wrong_vecs, boxes, masks, obj_mask,
                                       h, w)

    # 3. D_mask update.
    with record_function("train_step/d_mask_update"):
        sf = state.d_mask(masks_pred_d.reshape(n * o, mc.mask_size,
                                               mc.mask_size, 1),
                          one_hot_flat)
        sr = state.d_mask(masks_flat, one_hot_flat)
        fake = L.multiscale_gan_loss(sf, False, use_lsgan, w=flat_w) * 0.5
        real = L.multiscale_gan_loss(sr, True, use_lsgan, w=flat_w) * 0.5
        optim.step(state.opt_d_mask, fake + real,
                   _params(state.opt_d_mask), gd)
        metrics.update(fake_loss=fake, real_loss=real)

    # 4. D_obj update: the fake pass (GT boxes) before the real pass.
    with record_function("train_step/d_obj_update"):
        sf, lf, _ = state.d_obj(imgs_pred_d, boxes, obj_mask)
        sr, lr, _ = state.d_obj(imgs, boxes, obj_mask)
        gan = gan_d_loss(sr, sf, w=obj_mask) * 0.5
        ac_real = L.masked_cross_entropy(lr, objs, w=obj_mask)
        ac_fake = L.masked_cross_entropy(lf, objs, w=obj_mask)
        optim.step(state.opt_d_obj, gan + ac_real + ac_fake,
                   _params(state.opt_d_obj), gd)
        metrics.update(d_obj_gan_loss=gan, d_ac_loss_real=ac_real,
                       d_ac_loss_fake=ac_fake)

    # 5. D_img update.
    with record_function("train_step/d_img_update"):
        alpha = 0.25
        d_terms = {
            "fake_image_loss": L.multiscale_gan_loss(
                state.d_img(torch.cat([layout_d, imgs_pred_d], -1)), False,
                use_lsgan) * alpha,
            "wrong_texture_loss": L.multiscale_gan_loss(
                state.d_img(torch.cat([layout_wrong, imgs], -1)), False,
                use_lsgan) * alpha,
            "d_img_gan_real_loss": L.multiscale_gan_loss(
                state.d_img(torch.cat([layout_d, imgs], -1)), True,
                use_lsgan) * 0.5,
        }
        optim.step(state.opt_d_img, sum(d_terms.values()),
                   _params(state.opt_d_img), gd)
        metrics.update(d_terms)

    state.step += 1
    metrics = {k: v.detach() for k, v in metrics.items()}
    metrics["use_gt"] = use_gt
    # Underscored entries are images for periodic grids, not scalars.
    cls_nc = mc.layout_embed_dim or mc.num_objs
    metrics["_imgs_pred"] = imgs_pred_d
    metrics["_layout_one_hot"] = layout_d[..., :cls_nc]
    metrics["_layout_pred_one_hot"] = out.layout_pred.detach()[..., :cls_nc]
    return metrics
