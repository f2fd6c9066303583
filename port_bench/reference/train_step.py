"""Plain reference of one adversarial train step (the paper's
``trainer.py``): the generator's update against VGG19 perceptual features
and the three discriminators' probes, the appearance pool's wrong
textures, then the updates of D_mask, D_obj and D_img, each by Adam in
optax's order of operations.

Parameters are plain f32 leaves keyed as the program's modules name them,
in four trees (``g``, ``d_img``, ``d_obj``, ``d_mask``) and a fixed
``vgg``; batch-norm running statistics are not read in train mode. Losses
are the paper's: GAN (BCE) and auxiliary classification for D_obj, LSGAN
with feature matching for D_img and D_mask, box MSE gated by ``use_gt``,
VGG L1 over relu1_1..relu5_1 weighted 1/32..1.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from port_bench.reference import scene_model as sm
from port_bench.reference.precision import F32, Precision

Params = Dict[str, torch.Tensor]
BUFFERS = (".running_mean", ".running_var")


def is_param(name: str) -> bool:
    return not name.endswith(BUFFERS)


# --- losses ------------------------------------------------------------------

def masked_mean(x: torch.Tensor, w: Optional[torch.Tensor]) -> torch.Tensor:
    """sum(x w) / max(sum(w) * elements a row, 1), ``w`` over the leading
    axes."""
    x = x.float()
    if w is None:
        return x.mean()
    total = w.sum() * (x.numel() // w.numel())
    w = w.reshape(w.shape + (1,) * (x.ndim - w.ndim)).float()
    return (x * w).sum() / torch.clamp(total, min=1.0)


def bce(scores, target: float, w=None):
    loss = (torch.clamp(scores, min=0.0) - scores * target
            + torch.log1p(torch.exp(-scores.abs())))
    return masked_mean(loss, w)


def lsgan(pred: List[List[torch.Tensor]], real: bool, w=None):
    target = 1.0 if real else 0.0
    return sum(masked_mean((scale[-1] - target) ** 2, w) for scale in pred)


def feature_match(fake, real, w=None):
    num_d = len(fake)
    feat_w = 4.0 / len(fake[0])
    loss = 0.0
    for i in range(num_d):
        for j in range(len(fake[i]) - 1):
            loss = loss + (feat_w / num_d) * masked_mean(
                (fake[i][j] - real[i][j].detach()).abs(), w)
    return loss


def cross_entropy(logits, labels, w=None):
    logp = F.log_softmax(logits.float(), -1)
    return masked_mean(-logp.gather(-1, labels.long()[..., None])[..., 0], w)


VGG_WEIGHTS = (1.0 / 32, 1.0 / 16, 1.0 / 8, 1.0 / 4, 1.0)
VGG_STAGES = (("conv1_1",), ("conv1_2", "pool", "conv2_1"),
              ("conv2_2", "pool", "conv3_1"),
              ("conv3_2", "conv3_3", "conv3_4", "pool", "conv4_1"),
              ("conv4_2", "conv4_3", "conv4_4", "pool", "conv5_1"))


# --- networks ----------------------------------------------------------------

def vgg(P: Params, x: torch.Tensor, prec: Precision = F32):
    """(N, H, W, 3) -> relu1_1 .. relu5_1 (3x3 same convolutions, 2x2 max
    pools)."""
    h = x.permute(0, 3, 1, 2)
    taps = []
    for stage in VGG_STAGES:
        for layer in stage:
            if layer == "pool":
                h = F.max_pool2d(h, 2, 2)
            else:
                h = F.relu(sm.conv(P, f"convs.{layer}", h, prec, padding=1))
        taps.append(h)
    return taps


def patch_gan(P: Params, pre: str, x: torch.Tensor, n_layers: int,
              prec: Precision) -> List[torch.Tensor]:
    """4x4 convolutions, padding 2: ``n_layers`` of stride 2, one of
    stride 1, then the stride-1 score map; instance norm after all but the
    first and the last, LeakyReLU 0.2 after all but the last."""
    feats, h = [], x
    last = n_layers + 1
    for j in range(last + 1):
        stride = 2 if j < n_layers else 1
        h = sm.conv(P, f"{pre}.convs.{j}", h, prec, stride, 2)
        if j < last:
            if j > 0:
                h = sm.instance_norm(h)
            h = sm.leaky(h)
        feats.append(h)
    return feats


def avg_pool(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x, 3, stride=2, padding=1, count_include_pad=False)


def d_img(P: Params, dc: dict, x: torch.Tensor, prec: Precision = F32):
    """(N, H, W, C) -> one feature list a scale, full resolution first."""
    h = x.permute(0, 3, 1, 2)
    out = []
    for i in range(dc["num_d"]):
        out.append(patch_gan(P, f"scales.scale_{dc['num_d'] - 1 - i}", h,
                             dc["n_layers_d"], prec))
        h = avg_pool(h)
    return out


def d_mask(P: Params, dc: dict, masks: torch.Tensor, cond: torch.Tensor,
           prec: Precision = F32):
    """(B, M, M, 1) masks and (B, classes) one-hot classes -> one feature
    list a scale: 3x3 stride-2 convolutions, the class broadcast and
    concatenated before the penultimate convolution."""
    h = masks.permute(0, 3, 1, 2)
    out = []
    for i in range(dc["num_d_mask"]):
        pre = f"scales.scale_{dc['num_d_mask'] - 1 - i}"
        feats, g = [], h
        for j in range(dc["n_layers_d_mask"]):
            g = sm.conv(P, f"{pre}.downs.{j}", g, prec, 2, 1)
            if j > 0:
                g = sm.instance_norm(g)
            g = sm.leaky(g)
            feats.append(g)
        b, _, hh, ww = g.shape
        c = cond[:, :, None, None].expand(b, cond.shape[-1], hh, ww)
        g = sm.leaky(sm.instance_norm(sm.conv(
            P, f"{pre}.penultimate", torch.cat([g, c], 1), prec, 1, 1)))
        feats.append(g)
        feats.append(sm.conv(P, f"{pre}.head", g, prec, 1, 1))
        out.append(feats)
        h = avg_pool(h)
    return out


def d_obj(P: Params, mc: dict, dc: dict, imgs: torch.Tensor,
          boxes: torch.Tensor, obj_mask: torch.Tensor,
          prec: Precision = F32) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each object's crop of ``imgs`` at its box through the AC
    discriminator (valid 4x4 stride-2 convolutions, batch norm over the
    valid slots and LeakyReLU 0.2 before all but the first, average pool,
    a linear layer, then the real/fake score and the class logits)."""
    n, o = boxes.shape[:2]
    s = dc["crop_size"]
    crops = sm.crop_boxes(imgs, boxes, s).reshape(n * o, s, s, 3)
    w = obj_mask.reshape(n * o)
    h = crops.permute(0, 3, 1, 2)
    for j, spec in enumerate(dc["d_obj_arch"].split(",")):
        if j > 0:
            h = sm.leaky(sm.batch_norm(P, f"discriminator.cnn.bns.{j - 1}", h,
                                       True, w))
        stride = int(spec[1:].split("-")[2])
        h = sm.conv(P, f"discriminator.cnn.convs.{j}", h, prec, stride)
    vecs = sm.linear(P, "discriminator.dense", h.mean((2, 3)), prec)
    scores = sm.linear(P, "discriminator.real", vecs, prec)
    logits = sm.linear(P, "discriminator.obj", vecs, prec)
    return scores.reshape(n, o), logits.reshape(n, o, -1)


# --- the pool ----------------------------------------------------------------

def pool_query(vecs: torch.Tensor, counts: torch.Tensor, base: torch.Tensor,
               objs: torch.Tensor, reprs: torch.Tensor,
               valid: torch.Tensor):
    """The paper's appearance pool on a flat batch: each valid object reads
    a stored vector of its class (its own while the class is empty), at
    slot (base + its rank among the batch's objects of its class) mod the
    class's count, and writes its vector at the next free slot, or over
    the slot it read once the class is full. Returns (wrong vectors,
    vecs, counts)."""
    classes, size, _ = vecs.shape
    vecs, counts = vecs.clone(), counts.clone()
    wrong = reprs.clone()
    seen = torch.zeros(classes, dtype=torch.long)
    objs_l, valid_l = objs.tolist(), valid.tolist()
    base_l, counts_l = base.tolist(), counts.tolist()
    writes = []
    for b, (c, ok) in enumerate(zip(objs_l, valid_l)):
        if not ok:
            continue
        rank = int(seen[c])
        seen[c] += 1
        count = counts_l[c]
        read = min((base_l[c] + rank) % max(count, 1), size - 1)
        if count > 0:
            wrong[b] = vecs[c, read]
        slot = count + rank if count + rank < size else read
        writes.append((c, slot, b))
    for c, slot, b in writes:
        vecs[c, slot] = reprs[b]
    counts = torch.clamp(counts + seen.to(counts.device), max=size)
    return wrong, vecs, counts


# --- Adam --------------------------------------------------------------------

class Adam:
    """optax's Adam over named f32 leaves."""

    def __init__(self, params: Params, lr: float, b1: float, b2: float,
                 eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.count = 0

    @torch.no_grad()
    def update(self, params: Params, grads: Params) -> None:
        self.count += 1
        bc1 = 1 - self.b1 ** self.count
        bc2 = 1 - self.b2 ** self.count
        for k, p in params.items():
            g = grads[k]
            self.mu[k] = (1 - self.b1) * g + self.b1 * self.mu[k]
            self.nu[k] = (1 - self.b2) * g * g + self.b2 * self.nu[k]
            u = (self.mu[k] / bc1) / (torch.sqrt(self.nu[k] / bc2) + self.eps)
            p.add_(-self.lr * u)


def grads_of(loss: torch.Tensor, params: Params) -> Params:
    names = list(params)
    gs = torch.autograd.grad(loss, [params[k] for k in names],
                             allow_unused=True)
    return {k: torch.zeros_like(params[k]) if g is None else g
            for k, g in zip(names, gs)}


# --- the step ----------------------------------------------------------------

class State:
    """The four trees (each leaf a parameter that requires grad), their
    Adams, the fixed VGG and the appearance pool."""

    def __init__(self, cfg: dict, trees: Dict[str, Params], device):
        t, mc = cfg["train"], cfg["model"]
        self.cfg = cfg
        self.all = {name: {k: v.detach().clone() for k, v in tree.items()}
                    for name, tree in trees.items()}
        self.params = {name: {k: v.requires_grad_(True)
                              for k, v in tree.items() if is_param(k)}
                       for name, tree in self.all.items() if name != "vgg"}
        lrs = {"g": t["learning_rate"], "d_img": t["learning_rate"],
               "d_obj": t["learning_rate"], "d_mask": t["mask_learning_rate"]}
        self.opt = {name: Adam(self.params[name], lrs[name], t["beta1"],
                               t["beta2"]) for name in self.params}
        self.pool_vecs = torch.zeros(mc["num_objs"], mc["pool_size"],
                                     mc["rep_size"], device=device)
        self.pool_counts = torch.zeros(mc["num_objs"], dtype=torch.long,
                                       device=device)


def step(st: State, b: dict, use_gt: float, mask_noise: torch.Tensor,
         pool_base: torch.Tensor, prec: Precision = F32,
         prec_d: Precision = F32) -> Dict[str, float]:
    """One step on batch ``b`` (tensors: imgs uint8, objs, boxes, masks,
    triples, attributes, obj_mask, triple_mask); updates ``st`` and
    returns the loss terms. ``prec`` is the generator's products',
    ``prec_d`` the discriminators' and VGG's."""
    cfg = st.cfg
    mc, dc, lw = cfg["model"], cfg["discriminator"], cfg["loss"]
    G, DI, DO, DM, V = (st.all.get(k) for k in ("g", "d_img", "d_obj",
                                                 "d_mask", "vgg"))
    imgs = b["imgs"].float() * (2.0 / 255.0) - 1.0
    objs, boxes, masks, obj_mask = b["objs"], b["boxes"], b["masks"], \
        b["obj_mask"]
    n, o = objs.shape
    m = mc["mask_size"]
    h, w = mc["image_size"]
    flat_w = obj_mask.reshape(n * o)
    one_hot = F.one_hot(objs.reshape(n * o).long(), mc["num_objs"]).float()
    masks_flat = masks.reshape(n * o, m, m, 1)
    inp = dict(b, attributes=b["attributes"] * use_gt, mask_noise=mask_noise)

    out = sm.train_forward(G, mc, inp, imgs, prec)
    terms = {}
    if lw["l1_pixel_loss_weight"] > 0:
        terms["L1_pixel_loss"] = (masked_mean((out["imgs"] - imgs).abs(),
                                              None)
                                  * use_gt * lw["l1_pixel_loss_weight"])
    gate = use_gt if lw["box_loss_gated"] else 1.0
    terms["bbox_pred"] = (masked_mean((out["boxes"] - boxes) ** 2, obj_mask)
                          * gate * lw["bbox_pred_loss_weight"])
    if lw["vgg_features_weight"] > 0:
        fx = vgg(V, out["imgs"], prec_d)
        with torch.no_grad():
            fy = vgg(V, imgs, prec_d)
        terms["g_vgg"] = sum(wt * (a - c).abs().mean() for wt, a, c
                             in zip(VGG_WEIGHTS, fx, fy)) * lw[
            "vgg_features_weight"]
    sf, lf = d_obj(DO, mc, dc, out["imgs"], boxes, obj_mask, prec_d)
    terms["ac_loss"] = cross_entropy(lf, objs, obj_mask) * lw["ac_loss_weight"]
    terms["g_gan_obj_loss"] = bce(sf, 1.0, obj_mask) * lw["d_obj_weight"]
    fake_m = d_mask(DM, dc, out["masks"].reshape(n * o, m, m, 1), one_hot,
                    prec_d)
    terms["g_gan_mask_obj_loss"] = lsgan(fake_m, True, flat_w) * lw[
        "d_mask_weight"]
    if lw["d_mask_features_weight"] > 0:
        real_m = d_mask(DM, dc, masks_flat, one_hot, prec_d)
        terms["g_mask_features_loss"] = feature_match(
            fake_m, real_m, flat_w) * lw["d_mask_features_weight"]
    layout = out["layout"]
    pred_real = d_img(DI, dc, torch.cat([layout, imgs], -1), prec_d)
    pred_fake = d_img(DI, dc, torch.cat([layout.detach(), out["imgs"]], -1),
                      prec_d)
    terms["g_gan_img_loss"] = lsgan(pred_fake, True) * lw["d_img_weight"]
    if lw["d_img_features_weight"] > 0:
        terms["g_gan_features_loss_img"] = feature_match(
            pred_fake, pred_real) * lw["d_img_features_weight"]
    total = sum(terms.values())
    st.opt["g"].update(st.params["g"], grads_of(total, st.params["g"]))
    terms["total_loss"] = total

    imgs_pred = out["imgs"].detach()
    masks_pred = out["masks"].detach()
    layout = layout.detach()
    wrong, st.pool_vecs, st.pool_counts = pool_query(
        st.pool_vecs, st.pool_counts, pool_base, objs.reshape(n * o).cpu(),
        out["obj_repr"].detach().reshape(n * o, -1), flat_w.cpu() > 0)
    wrong_vecs = torch.cat([out["cls"].detach(), wrong.reshape(n, o, -1)], -1)
    layout_wrong = torch.einsum("nohw,nod->nhwd", out["gt_weights"].detach(),
                                wrong_vecs)

    sf = d_mask(DM, dc, masks_pred.reshape(n * o, m, m, 1), one_hot, prec_d)
    sr = d_mask(DM, dc, masks_flat, one_hot, prec_d)
    fake = lsgan(sf, False, flat_w) * 0.5
    real = lsgan(sr, True, flat_w) * 0.5
    st.opt["d_mask"].update(st.params["d_mask"],
                            grads_of(fake + real, st.params["d_mask"]))
    terms.update(fake_loss=fake, real_loss=real)

    sf, lf = d_obj(DO, mc, dc, imgs_pred, boxes, obj_mask, prec_d)
    sr, lr = d_obj(DO, mc, dc, imgs, boxes, obj_mask, prec_d)
    gan = (bce(sr, 1.0, obj_mask) + bce(sf, 0.0, obj_mask)) * 0.5
    ac_real = cross_entropy(lr, objs, obj_mask)
    ac_fake = cross_entropy(lf, objs, obj_mask)
    st.opt["d_obj"].update(st.params["d_obj"],
                           grads_of(gan + ac_real + ac_fake,
                                    st.params["d_obj"]))
    terms.update(d_obj_gan_loss=gan, d_ac_loss_real=ac_real,
                 d_ac_loss_fake=ac_fake)

    d_terms = {
        "fake_image_loss": lsgan(d_img(DI, dc, torch.cat(
            [layout, imgs_pred], -1), prec_d), False) * 0.25,
        "wrong_texture_loss": lsgan(d_img(DI, dc, torch.cat(
            [layout_wrong, imgs], -1), prec_d), False) * 0.25,
        "d_img_gan_real_loss": lsgan(d_img(DI, dc, torch.cat(
            [layout, imgs], -1), prec_d), True) * 0.5,
    }
    st.opt["d_img"].update(st.params["d_img"],
                           grads_of(sum(d_terms.values()),
                                    st.params["d_img"]))
    terms.update(d_terms)
    return {k: float(v.detach()) for k, v in terms.items()}
