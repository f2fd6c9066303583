"""Plain reference of the scene-graph-to-image generator (the paper's
``Model``): scene-graph convolution, box and mask heads, appearance
vectors, the layout, and the pix2pixHD global generator, in test mode
(serving) and in train mode.

Every function takes the state dict ``P`` (f32 tensors keyed as the
program's modules are), the configuration's ``model`` section ``mc`` as a
plain dict, and a ``Precision`` for the products. The layout is
materialized (N, H, W, D) and the generator's 7x7 stem is one dense
convolution over it, as the paper's code computes it: nothing of the
program's factored stem, its taps or its kernels.

Layout, test mode (the paper's occlusion): each object's mask is resampled
into its box; objects are ordered by mass (the sum of the object's layout
vector times the sum of its resampled mask), ascending, ties by slot; each
claims the pixels not yet claimed where its resampled mask is above 0.5 and
writes its mask value times its vector there (``claims``).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from port_bench.reference.precision import F32, Precision

Params = Dict[str, torch.Tensor]


def linear(P: Params, name: str, x: torch.Tensor,
           prec: Precision = F32) -> torch.Tensor:
    return prec.out(F.linear(prec.q(x), prec.q(P[name + ".weight"]),
                             P[name + ".bias"]))


def conv(P: Params, name: str, x: torch.Tensor, prec: Precision = F32,
         stride: int = 1, padding: int = 0) -> torch.Tensor:
    return prec.out(F.conv2d(prec.q(x), prec.q(P[name + ".weight"]),
                             P[name + ".bias"], stride, padding))


def leaky(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


def mlp(P: Params, name: str, x: torch.Tensor, layers: int,
        final_relu: bool = True, prec: Precision = F32) -> torch.Tensor:
    """Linear layers with a ReLU after each (after the last too with
    ``final_relu``); no normalization (``mlp_normalization`` none)."""
    for i in range(layers):
        x = linear(P, f"{name}.layers.{i}", x, prec)
        if i < layers - 1 or final_relu:
            x = F.relu(x)
    return x


def batch_norm(P: Params, name: str, x: torch.Tensor, train: bool,
               weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The paper's BatchNorm on channels at dim 1 (eps 1e-5). Train mode
    normalizes by the biased statistics of the rows whose weight is
    nonzero (padded object slots left out), eval mode by the running
    statistics. The stored ``scale`` is the offset of the scale from 1."""
    shape = (1, -1) + (1,) * (x.ndim - 2)
    if train:
        dims = [0] + list(range(2, x.ndim))
        per_row = x[0].numel() / x.shape[1]
        if weights is None:
            w = torch.ones(x.shape[0], device=x.device)
        else:
            w = weights.float()
        wb = w.reshape((-1,) + (1,) * (x.ndim - 1))
        count = torch.clamp(w.sum() * per_row, min=1.0)
        mean = (x * wb).sum(dims) / count
        var = torch.clamp((x * x * wb).sum(dims) / count - mean * mean,
                          min=0.0)
    else:
        mean, var = P[name + ".running_mean"], P[name + ".running_var"]
    y = (x - mean.view(shape)) / torch.sqrt(var.view(shape) + 1e-5)
    return y * (P[name + ".scale"] + 1.0).view(shape) + P[name + ".bias"].view(
        shape)


def instance_norm(x: torch.Tensor) -> torch.Tensor:
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = ((x - mean) ** 2).mean(dim=(2, 3), keepdim=True)
    return (x - mean) / torch.sqrt(var + 1e-5)


# --- scene graph -------------------------------------------------------------

def graph_layer(P: Params, name: str, obj: torch.Tensor, pred: torch.Tensor,
                edges: torch.Tensor, triple_mask: torch.Tensor, hidden: int,
                dout: int, prec: Precision) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    """One graph convolution: each triple's [s, p, o] through net1, the new
    subject and object vectors averaged back onto their objects over the
    valid triples, then net2."""
    n, o = obj.shape[:2]
    t = pred.shape[1]
    d = obj.shape[-1]
    s_vec = torch.gather(obj, 1, edges[..., 0:1].expand(n, t, d))
    o_vec = torch.gather(obj, 1, edges[..., 1:2].expand(n, t, d))
    new_t = mlp(P, f"{name}.net1", torch.cat([s_vec, pred, o_vec], -1)
                .reshape(n * t, -1), 2, True, prec).reshape(n, t, -1)
    new_s = new_t[..., :hidden]
    new_p = new_t[..., hidden:hidden + dout]
    new_o = new_t[..., hidden + dout:]
    tm = triple_mask[..., None]
    pooled = torch.zeros(n, o, hidden, device=obj.device)
    pooled = pooled.scatter_add(1, edges[..., 0:1].expand(n, t, hidden),
                                new_s * tm)
    pooled = pooled.scatter_add(1, edges[..., 1:2].expand(n, t, hidden),
                                new_o * tm)
    counts = torch.zeros(n, o, device=obj.device)
    counts = counts.scatter_add(1, edges[..., 0], triple_mask)
    counts = counts.scatter_add(1, edges[..., 1], triple_mask)
    pooled = pooled / torch.clamp(counts, min=1.0)[..., None]
    new_obj = mlp(P, f"{name}.net2", pooled.reshape(n * o, hidden), 2, True,
                  prec).reshape(n, o, dout)
    return new_obj, new_p


def scene_vectors(P: Params, mc: dict, objs: torch.Tensor,
                  triples: torch.Tensor, attributes: torch.Tensor,
                  triple_mask: torch.Tensor,
                  prec: Precision = F32) -> torch.Tensor:
    """Object embeddings with their attributes through the graph
    convolutions -> (N, O, gconv_dim)."""
    if mc["mlp_normalization"] != "none" or mc["gconv_pooling"] != "avg":
        raise NotImplementedError("the reference has no normalized MLPs or "
                                  "sum pooling")
    triples = triples.long()
    edges = torch.stack([triples[..., 0], triples[..., 2]], -1)
    obj = P["obj_embeddings.weight"][objs.long()]
    pred = P["pred_embeddings.weight"][triples[..., 1]]
    if mc["use_attributes"]:
        obj = torch.cat([obj, attributes], -1)
    h, d = mc["gconv_hidden_dim"], mc["gconv_dim"]
    obj, pred = graph_layer(P, "gconv", obj, pred, edges, triple_mask, h, d,
                            prec)
    for i in range(mc["gconv_num_layers"] - 1):
        obj, pred = graph_layer(P, f"gconv_net.layers.{i}", obj, pred, edges,
                                triple_mask, h, d, prec)
    return obj


def mask_logits(P: Params, mc: dict, vecs: torch.Tensor, train: bool,
                weights: Optional[torch.Tensor] = None,
                prec: Precision = F32) -> torch.Tensor:
    """(B, dim) -> (B, M, M) logits: from 1x1, [nearest 2x upsampling, 3x3
    convolution, batch norm, ReLU] to the mask size, then a 1x1
    convolution."""
    h = vecs[:, :, None, None]
    for i in range(int(math.log2(mc["mask_size"]))):
        h = h.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
        h = conv(P, f"mask_net.convs.{i}", h, prec, padding=1)
        h = F.relu(batch_norm(P, f"mask_net.bns.{i}", h, train, weights))
    return conv(P, "mask_net.out", h, prec)[:, 0]


def heads(P: Params, mc: dict, inp: dict, train: bool,
          prec: Precision = F32):
    """Graph vectors, predicted boxes (N, O, 4), mask logits (N, O, M, M)
    and the mask head's input vectors."""
    n, o = inp["objs"].shape
    obj_vecs = scene_vectors(P, mc, inp["objs"], inp["triples"],
                             inp["attributes"], inp["triple_mask"], prec)
    noise = inp["mask_noise"].float().expand(n, o, mc["mask_noise_dim"])
    mask_vecs = torch.cat([obj_vecs, noise], -1)
    flat_w = inp["obj_mask"].reshape(n * o)
    boxes = mlp(P, "box_net", obj_vecs.reshape(n * o, -1), 2,
                mc["box_net_final"] == "relu", prec).reshape(n, o, 4)
    logits = mask_logits(P, mc, mask_vecs.reshape(n * o, -1), train, flat_w,
                         prec)
    m = mc["mask_size"]
    return obj_vecs, boxes, logits.reshape(n, o, m, m), mask_vecs


# --- layout ------------------------------------------------------------------

def hat(coords: torch.Tensor, size: int) -> torch.Tensor:
    """(..., P) sample positions in pixels -> (..., P, size) bilinear
    weights, zero outside."""
    m = torch.arange(size, dtype=coords.dtype, device=coords.device)
    return torch.clamp(1.0 - torch.abs(coords[..., None] - m), min=0.0)


def mask_samplers(boxes: torch.Tensor, h: int, w: int, m: int):
    """Each output pixel's position inside an object's M x M mask (the
    paper's layout grid), in the boxes' dtype: ry (..., H, M),
    rx (..., W, M)."""
    x0, y0, x1, y1 = boxes.unbind(-1)
    bw, bh = x1 - x0, y1 - y0
    bw = torch.where(torch.abs(bw) < 1e-6, 1e-6, bw)
    bh = torch.where(torch.abs(bh) < 1e-6, 1e-6, bh)
    xs = torch.linspace(0.0, 1.0, w, dtype=boxes.dtype, device=boxes.device)
    ys = torch.linspace(0.0, 1.0, h, dtype=boxes.dtype, device=boxes.device)
    px = (xs - x0[..., None]) / bw[..., None] * (m - 1)
    py = (ys - y0[..., None]) / bh[..., None] * (m - 1)
    return hat(py, m), hat(px, m)


def resample_masks(boxes: torch.Tensor, masks: torch.Tensor, h: int,
                   w: int) -> torch.Tensor:
    """(N, O, M, M) masks placed in their boxes -> (N, O, H, W), in the
    boxes' dtype."""
    ry, rx = mask_samplers(boxes, h, w, masks.shape[-1])
    return ry @ masks.to(ry.dtype) @ rx.transpose(-1, -2)


def crop_samplers(boxes: torch.Tensor, hh: int, ww: int, h: int, w: int):
    """The paper's ROI crop grid (corner-aligned): ry (..., HH, H),
    rx (..., WW, W)."""
    x0, y0, x1, y1 = boxes.unbind(-1)
    tx = torch.linspace(0.0, 1.0, ww, device=boxes.device)
    ty = torch.linspace(0.0, 1.0, hh, device=boxes.device)
    px = (x0[..., None] + (x1 - x0)[..., None] * tx) * (w - 1)
    py = (y0[..., None] + (y1 - y0)[..., None] * ty) * (h - 1)
    return hat(py, h), hat(px, w)


def crop_boxes(imgs: torch.Tensor, boxes: torch.Tensor,
               size: int) -> torch.Tensor:
    """(N, H, W, C) images, (N, O, 4) boxes -> (N, O, S, S, C) bilinear
    crops, zero outside the image."""
    _, h, w, _ = imgs.shape
    ry, rx = crop_samplers(boxes, size, size, h, w)
    return torch.einsum("nopy,nyxc,noqx->nopqc", ry, imgs, rx)


def claims(boxes: torch.Tensor, masks: torch.Tensor, vecs: torch.Tensor,
           obj_mask: torch.Tensor, h: int, w: int, dtype: torch.dtype):
    """The resampled masks (N, O, H, W) and the pixels each object claims
    (booleans), the rule's arithmetic carried out in ``dtype``. Objects
    claim in ascending mass (the sum of the layout vector times the sum of
    the resampled mask), ties by slot, each the pixels not yet claimed
    where its resampled mask is above 0.5."""
    valid = obj_mask.to(dtype)[:, :, None, None]
    sampled = resample_masks(boxes.to(dtype), masks, h, w) * valid
    mass = vecs.to(dtype).sum(-1) * sampled.sum((-1, -2))
    mass = torch.where(obj_mask.bool(), mass, torch.finfo(dtype).max)
    binm = (sampled > 0.5).to(dtype) * valid
    idx = torch.arange(mass.shape[1], device=mass.device)
    lt = mass[:, :, None] < mass[:, None, :]
    tie = (mass[:, :, None] == mass[:, None, :]) & (idx[:, None] < idx[None])
    precede = (lt | tie).to(dtype)
    n, o = mass.shape
    taken = torch.bmm(precede.transpose(1, 2),
                      binm.reshape(n, o, h * w)).reshape(n, o, h, w)
    return sampled, (binm > 0) & (taken == 0)


def layout(boxes: torch.Tensor, masks: torch.Tensor, vecs: torch.Tensor,
           obj_mask: torch.Tensor, h: int, w: int,
           grid: torch.dtype = torch.float32) -> torch.Tensor:
    """The test-mode (N, H, W, D) layout: each object's resampled mask
    times its vector where it claims, the grid, the masses and the claims
    computed in ``grid``, the contraction in f32."""
    sampled, claimed = claims(boxes, masks, vecs, obj_mask, h, w, grid)
    return torch.einsum("nohw,nod->nhwd", sampled.float() * claimed, vecs)


# --- generator ---------------------------------------------------------------

def reflect(x: torch.Tensor, pad: int) -> torch.Tensor:
    return F.pad(x, (pad, pad, pad, pad), mode="reflect")


def generator(P: Params, mc: dict, lay: torch.Tensor,
              prec: Precision = F32) -> torch.Tensor:
    """pix2pixHD global generator: (N, H, W, D) layout -> (N, H, W, 3)."""
    g = "layout_to_image"
    h = conv(P, f"{g}.stem.conv", reflect(lay.permute(0, 3, 1, 2), 3), prec)
    h = F.relu(instance_norm(h))
    for i in range(mc["n_downsample_global"]):
        h = F.relu(instance_norm(conv(P, f"{g}.downs.{i}", h, prec, 2, 1)))
    for i in range(mc["n_blocks_global"]):
        r = F.relu(instance_norm(conv(P, f"{g}.blocks.{i}.conv1",
                                      reflect(h, 1), prec)))
        h = h + instance_norm(conv(P, f"{g}.blocks.{i}.conv2", reflect(r, 1),
                                   prec))
    for i in range(mc["n_downsample_global"]):
        wt, b = prec.q(P[f"{g}.ups.{i}.weight"]), P[f"{g}.ups.{i}.bias"]
        hh, ww = h.shape[2], h.shape[3]
        if mc["torch_deconv"]:
            h = F.conv_transpose2d(prec.q(h), wt, b, stride=2, padding=1,
                                   output_padding=1)
        else:
            h = F.conv_transpose2d(prec.q(h), wt, b,
                                   stride=2)[:, :, :2 * hh, :2 * ww]
        h = F.relu(instance_norm(prec.out(h)))
    h = conv(P, f"{g}.head", reflect(h, 3), prec)
    return torch.tanh(h).permute(0, 2, 3, 1)


# --- test mode (serving) -----------------------------------------------------

def layout_vectors(mc: dict, objs: torch.Tensor,
                   obj_repr: torch.Tensor) -> torch.Tensor:
    if mc["layout_embed_dim"]:
        raise NotImplementedError("the reference has one-hot layout classes")
    return torch.cat([F.one_hot(objs.long(), mc["num_objs"]).float(),
                      obj_repr], -1)


def appearances(P: Params, mc: dict, inp: dict, mask_vecs: torch.Tensor,
                prec: Precision = F32) -> torch.Tensor:
    """The layout vectors: class one-hot and appearance, the given vector
    where ``features_mask`` is 1, repr_net's elsewhere."""
    n, o = inp["objs"].shape
    rep = mlp(P, "repr_net", mask_vecs.reshape(n * o, -1), 2, True,
              prec).reshape(n, o, -1)
    fm = inp["features_mask"][..., None]
    return layout_vectors(mc, inp["objs"], fm * inp["features"]
                          + (1 - fm) * rep)


def serve(P: Params, mc: dict, inp: dict, prec: Precision = F32) -> dict:
    """The test-mode forward on predicted boxes and masks: ``boxes``,
    ``masks``, ``vecs`` (the layout vectors) and ``imgs``."""
    h, w = mc["image_size"]
    _, boxes, logits, mask_vecs = heads(P, mc, inp, False, prec)
    masks = torch.sigmoid(logits)
    vecs = appearances(P, mc, inp, mask_vecs, prec)
    imgs = generator(P, mc, layout(boxes, masks, vecs, inp["obj_mask"], h, w),
                     prec)
    return dict(boxes=boxes, masks=masks, vecs=vecs, imgs=imgs)


def images_on(P: Params, mc: dict, vecs: torch.Tensor, boxes: torch.Tensor,
              masks: torch.Tensor, obj_mask: torch.Tensor,
              grid: torch.dtype):
    """The f32 generator's images on the layout of the given boxes and
    masks (its grid and claims in ``grid``), and per image whether it
    claims nothing: its layout is then constant, and the generator's
    instance norms amplify rounding alone.

    The comparison follows the program from its own boxes and masks, on
    the grid of its served dtype: a bf16 grid places a mask edge up to a
    quarter pixel from the f32 grid's, which moves claims at hundreds of
    pixels an image, and the seeded generator turns a dozen moved pixels
    into a 30% different image. Its images are thus held to the generator
    and the stem on the program's layout; the boxes and masks are held to
    the reference's own heads."""
    h, w = mc["image_size"]
    lay = layout(boxes, masks, vecs, obj_mask, h, w, grid)
    empty = (lay.flatten(1).abs().amax(1) == 0).tolist()
    return generator(P, mc, lay), empty


# --- train mode --------------------------------------------------------------

def appearance(P: Params, mc: dict, crops: torch.Tensor,
               weights: torch.Tensor, prec: Precision = F32) -> torch.Tensor:
    """(B, S, S, 3) crops -> (B, rep_size): the appearance encoder (valid
    4x4 stride-2 convolutions, batch norm and LeakyReLU 0.2 before every
    convolution but the first, global average pool, a linear layer), then
    repr_net."""
    h = crops.permute(0, 3, 1, 2)
    specs = mc["appearance_arch"].split(",")
    for j, spec in enumerate(specs):
        if j > 0:
            h = leaky(batch_norm(P, f"image_encoder.cnn.bns.{j - 1}", h, True,
                                 weights))
        stride = int(spec[1:].split("-")[2])
        h = conv(P, f"image_encoder.cnn.convs.{j}", h, prec, stride)
    enc = linear(P, "image_encoder.dense", h.mean((2, 3)), prec)
    return mlp(P, "repr_net", enc, 2, True, prec)


def train_forward(P: Params, mc: dict, inp: dict, imgs: torch.Tensor,
                  prec: Precision = F32) -> dict:
    """The train-mode forward: batch statistics over the valid slots, each
    object's appearance encoded from its crop of the real image at its
    ground-truth box, the image from the ground-truth layout (masks
    summed, no occlusion). ``imgs`` (N, H, W, 3) in [-1, 1]."""
    n, o = inp["objs"].shape
    h, w = mc["image_size"]
    flat_w = inp["obj_mask"].reshape(n * o)
    _, boxes, logits, _ = heads(P, mc, inp, True, prec)
    masks = torch.sigmoid(logits)
    s = mc["object_size"]
    crops = crop_boxes(imgs, inp["boxes"], s).reshape(n * o, s, s, 3)
    obj_repr = appearance(P, mc, crops, flat_w, prec).reshape(n, o, -1)
    vecs = layout_vectors(mc, inp["objs"], obj_repr)
    valid = inp["obj_mask"][:, :, None, None]
    gt = resample_masks(inp["boxes"], inp["masks"], h, w) * valid
    layout = torch.einsum("nohw,nod->nhwd", gt, vecs)
    imgs_pred = generator(P, mc, layout, prec)
    pred = resample_masks(inp["boxes"], masks, h, w) * valid
    layout_pred = torch.einsum("nohw,nod->nhwd", pred, vecs)
    return dict(imgs=imgs_pred, boxes=boxes, masks=masks, layout=layout,
                layout_pred=layout_pred, obj_repr=obj_repr,
                cls=vecs[..., :mc["num_objs"]], gt_weights=gt)
