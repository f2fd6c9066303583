"""The work the benchmark's cells ask of the card, as fixed functions of
the configuration's shapes: operation counts of the model's parts, the
stem's and the crops' bounds, and the least time of a serving batch and of
a train step at the published peaks (``peaks.py``).

A multiply-add is two operations. Each part is counted as the algorithm
needs it, whatever implements it: the factored stem over the O object
slots (not the dense layout's channels), a transposed convolution by its
input pixels, each product once (the f32 stem's three TF32 products are
the implementation's, not the work's).

Precision of each part, as the program runs it with PyTorch's default
flags: convolutions of an f32 model on cuDNN in TF32, f32 matrix products
on cuBLAS in full f32, bf16 everything at the bf16 rate; the f32 stem
kernel at the TF32 rate.

Training: a pass is counted 1 for the forward, 1 more for a backward that
forms the inputs' gradients alone (a frozen module, or a discriminator
probed inside the generator's loss), 2 more for a backward that also forms
its weights' gradients. ``crop_work`` is ``chip_smoke.py``'s.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from port_bench.peaks import PEAK_FLOPS, bound

Part = Tuple[str, float, str]       # (name, operations, precision)


def conv_ops(cin: int, cout: int, k: int, hout: int, wout: int) -> float:
    return 2.0 * cin * cout * k * k * hout * wout


def _out(size: int, k: int, stride: int, pad: int) -> int:
    return (size + 2 * pad - k) // stride + 1


def graph_ops(mc: dict, slots: int, triples: int) -> float:
    """Operations of the graph convolutions for one image."""
    h, d, e = mc["gconv_hidden_dim"], mc["gconv_dim"], mc["embedding_dim"]
    a = mc["num_attributes"] if mc["use_attributes"] else 0
    total = 0.0
    for layer in range(mc["gconv_num_layers"]):
        din = 3 * e + 2 * a if layer == 0 else 3 * d
        total += 2.0 * triples * (din * h + h * (2 * h + d))
        total += 2.0 * slots * (h * h + h * d)
    return total


def head_ops(mc: dict, slots: int) -> Dict[str, float]:
    """Box head, mask head and repr_net operations for one image."""
    dim = mc["gconv_dim"] + mc["mask_noise_dim"]
    mask = 0.0
    size = 1
    for _ in range(int(math.log2(mc["mask_size"]))):
        size *= 2
        mask += conv_ops(dim, dim, 3, size, size)
    mask += conv_ops(dim, 1, 1, size, size)
    return dict(
        box=2.0 * slots * (mc["box_dim"] * mc["gconv_hidden_dim"]
                           + mc["gconv_hidden_dim"] * 4),
        mask=slots * mask,
        repr=2.0 * slots * (dim * mc["rep_hidden_size"]
                            + mc["rep_hidden_size"] * mc["rep_size"]))


def layout_dim(mc: dict) -> int:
    return (mc["layout_embed_dim"] or mc["num_objs"]) + mc["rep_size"]


def layout_ops(mc: dict, slots: int) -> float:
    """One image's layout: each mask resampled into its box (two
    products) and the weight field contracted with the vectors."""
    h, w = mc["image_size"]
    m = mc["mask_size"]
    return 2.0 * slots * (h * m * m + h * m * w) + 2.0 * slots * h * w * (
        layout_dim(mc))


def stem_ops(mc: dict, slots: int) -> float:
    """The factored 7x7 stem of one image: the contraction over the O
    slots' weight field, 2 H W 49 O C."""
    h, w = mc["image_size"]
    return 2.0 * h * w * 49 * slots * mc["ngf"]


def taps_ops(mc: dict, slots: int) -> float:
    """The stem's per-image taps, g = vecs x kernel."""
    return 2.0 * slots * layout_dim(mc) * mc["ngf"] * 49


def stem_bytes(mc: dict, n: int, slots: int, itemsize: int) -> float:
    """The stem kernel's inputs read once and output written once."""
    h, w = mc["image_size"]
    c = mc["ngf"]
    return itemsize * n * ((h + 6) * (w + 6) * slots + 49 * slots * c
                           + h * w * c)


def stem_bound_s(mc: dict, n: int, slots: int, dtype: str) -> float:
    """Least seconds of one stem launch at batch ``n``: bf16 at the bf16
    rate, f32 counted once at the TF32 rate."""
    prec = "bf16" if dtype == "bfloat16" else "tf32"
    size = 2 if dtype == "bfloat16" else 4
    return bound(n * stem_ops(mc, slots), stem_bytes(mc, n, slots, size),
                 prec)[0]


def generator_ops(mc: dict) -> Dict[str, float]:
    """The global generator's convolutions for one image, the stem
    excluded: downsampling, residual blocks, upsampling, the 7x7 head."""
    h, w = mc["image_size"]
    ngf, nd = mc["ngf"], mc["n_downsample_global"]
    down = 0.0
    hh, ww = h, w
    for i in range(nd):
        hh, ww = _out(hh, 3, 2, 1), _out(ww, 3, 2, 1)
        down += conv_ops(ngf * 2 ** i, ngf * 2 ** (i + 1), 3, hh, ww)
    width = ngf * 2 ** nd
    blocks = 2 * mc["n_blocks_global"] * conv_ops(width, width, 3, hh, ww)
    up = 0.0
    for i in range(nd):
        cin = ngf * 2 ** (nd - i)
        up += conv_ops(cin, cin // 2, 3, hh, ww)     # by input pixels
        hh, ww = 2 * hh, 2 * ww
    head = conv_ops(ngf, mc["output_nc"], 7, h, w)
    return dict(down=down, blocks=blocks, up=up, head=head)


def _conv_prec(dtype: str) -> str:
    return "bf16" if dtype == "bfloat16" else "tf32"


def _matmul_prec(dtype: str) -> str:
    return "bf16" if dtype == "bfloat16" else "f32"


def serve_parts(mc: dict, slots: int, triples: int, dtype: str) -> List[Part]:
    """One test-mode image, its appearance given (no crops)."""
    cp, mp = _conv_prec(dtype), _matmul_prec(dtype)
    heads = head_ops(mc, slots)
    gen = generator_ops(mc)
    return [("graph", graph_ops(mc, slots, triples), mp),
            ("box_head", heads["box"], mp), ("repr_net", heads["repr"], mp),
            ("mask_head", heads["mask"], cp),
            ("layout", layout_ops(mc, slots), mp),
            ("stem_taps", taps_ops(mc, slots), mp),
            ("stem", stem_ops(mc, slots), cp),
            *((f"generator_{k}", v, cp) for k, v in gen.items())]


def least_seconds(parts: List[Part], count: float = 1.0) -> float:
    return count * sum(ops / PEAK_FLOPS[prec] for _, ops, prec in parts)


def total_ops(parts: List[Part], count: float = 1.0) -> float:
    return count * sum(ops for _, ops, _ in parts)


# --- training ----------------------------------------------------------------

def cnn_ops(arch: str, cin: int, size: int) -> Tuple[float, int, int]:
    """Operations, output channels and size of a valid-padding conv stack
    'CK-X-S,...' on a square input."""
    ops = 0.0
    for spec in arch.split(","):
        k, cout, stride = (int(v) for v in spec[1:].split("-"))
        size = _out(size, k, stride, 0)
        ops += conv_ops(cin, cout, k, size, size)
        cin = cout
    return ops, cin, size


def appearance_ops(mc: dict) -> float:
    """One crop through the appearance encoder and repr_net."""
    ops, cout, _ = cnn_ops(mc["appearance_arch"], 3, mc["object_size"])
    dim = mc["gconv_dim"] + mc["mask_noise_dim"]
    return ops + 2.0 * (cout * dim + dim * mc["rep_hidden_size"]
                        + mc["rep_hidden_size"] * mc["rep_size"])


def d_obj_ops(mc: dict, dc: dict) -> float:
    """One crop through D_obj."""
    ops, cout, _ = cnn_ops(dc["d_obj_arch"], 3, dc["crop_size"])
    return ops + 2.0 * (cout * 1024 + 1024 + 1024 * mc["num_objs"])


def d_mask_ops(mc: dict, dc: dict) -> float:
    """One mask through D_mask's scales."""
    total, size = 0.0, mc["mask_size"]
    for _ in range(dc["num_d_mask"]):
        s, cin, ops = size, 1, 0.0
        chans = [dc["ndf_mask"]]
        for _ in range(1, dc["n_layers_d_mask"]):
            chans.append(min(chans[-1] * 2, 512))
        for cout in chans:
            s = _out(s, 3, 2, 1)
            ops += conv_ops(cin, cout, 3, s, s)
            cin = cout
        nf = min(cin * 2, 512)
        ops += conv_ops(cin + mc["num_objs"], nf, 3, s, s)
        ops += conv_ops(nf, 1, 3, s, s)
        total += ops
        size = _out(size, 3, 2, 1)
    return total


def d_img_ops(mc: dict, dc: dict) -> float:
    """One image (layout and RGB) through D_img's scales."""
    h = mc["image_size"][0]
    cin0 = layout_dim(mc) + mc["output_nc"]
    total, size = 0.0, h
    for _ in range(dc["num_d"]):
        chans = [dc["ndf"]]
        for _ in range(1, dc["n_layers_d"]):
            chans.append(min(chans[-1] * 2, 512))
        chans.append(min(chans[-1] * 2, 512))
        strides = [2] * dc["n_layers_d"] + [1]
        s, cin = size, cin0
        for cout, st in zip(chans + [1], strides + [1]):
            s = _out(s, 4, st, 2)
            total += conv_ops(cin, cout, 4, s, s)
            cin = cout
        size = _out(size, 3, 2, 1)
    return total


VGG_CONVS = ((3, 64, 0), (64, 64, 0), (64, 128, 1), (128, 128, 1),
             (128, 256, 2), (256, 256, 2), (256, 256, 2), (256, 256, 2),
             (256, 512, 3), (512, 512, 3), (512, 512, 3), (512, 512, 3),
             (512, 512, 4))


def vgg_ops(mc: dict) -> float:
    """One image through VGG19 up to relu5_1 (3x3 convolutions; the level
    is the number of 2x2 pools before)."""
    h, w = mc["image_size"]
    return sum(conv_ops(ci, co, 3, h >> lv, w >> lv)
               for ci, co, lv in VGG_CONVS)


def train_parts(cfg: dict, batch: int, slots: int,
                triples: int) -> List[Part]:
    """One adversarial step at ``batch`` images: the generator in its
    compute dtype, D and VGG in theirs (see the module's counting rule)."""
    mc, dc = cfg["model"], cfg["discriminator"]
    g_dtype, d_dtype = mc["compute_dtype"], dc["compute_dtype"]
    cp, mp = _conv_prec(g_dtype), _matmul_prec(g_dtype)
    dp = _conv_prec(d_dtype)
    heads = head_ops(mc, slots)
    gen = sum(generator_ops(mc).values()) + stem_ops(mc, slots)
    g_conv = gen + heads["mask"] + slots * appearance_ops(mc)
    g_mm = (graph_ops(mc, slots, triples) + heads["box"] + heads["repr"]
            + taps_ops(mc, slots) + 2 * layout_ops(mc, slots))
    n = float(batch)
    objs = n * slots
    return [
        ("g_forward_backward", 3 * n * g_conv, cp),
        ("g_products", 3 * n * g_mm, mp),
        ("wrong_texture_layout", n * layout_ops(mc, slots), mp),
        ("vgg", 3 * n * vgg_ops(mc), dp),
        ("d_obj", (2 + 6) * objs * d_obj_ops(mc, dc), dp),
        ("d_mask", (3 + 6) * objs * d_mask_ops(mc, dc), dp),
        ("d_img", (4 + 9) * n * d_img_ops(mc, dc), dp),
    ]


# --- crops -------------------------------------------------------------------

def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def crop_work(imgs, ry, rx, u, out, needs=None) -> Tuple[float, float]:
    """(operations, bytes) that the crop forward (``needs`` None) or
    backward needs on these inputs, ``out`` its outputs: operations from
    the nonzeros of ry and rx, bytes with each input read once and each
    output written once. Per (n, o) and channel, with t1 = ry img and
    t2 = img rx^T restricted to the rows and columns that hold a nonzero:
    forward and d_img 2 (nnz(ry) cols(rx) + rows(ry) nnz(rx)); the box
    gradients add t1 and t2 on every image row and column, 2 (nnz(ry) W +
    nnz(rx) H), then d_ry the dense 2 HH H rows(rx) and d_rx the dense
    2 WW W rows(ry)."""
    c = imgs.shape[-1]
    hh, h = ry.shape[-2:]
    ww, w = rx.shape[-2:]
    nz_y, nz_x = ry != 0, rx != 0
    nnz_y = nz_y.sum((-1, -2)).double()
    nnz_x = nz_x.sum((-1, -2)).double()
    rows_y = nz_y.any(-1).sum(-1).double()
    rows_x = nz_x.any(-1).sum(-1).double()
    cols_x = nz_x.any(-2).sum(-1).double()
    banded = nnz_y * cols_x + rows_y * nnz_x
    if needs is None:
        return float(2 * c * banded.sum()), nbytes(imgs, ry, rx, *out)
    ops = banded if needs[0] else 0.0
    if needs[1] or needs[2]:
        ops = ops + nnz_y * w + nnz_x * h + hh * h * rows_x + ww * w * rows_y
    read = (ry, rx, u) + ((imgs,) if needs[1] or needs[2] else ())
    return float(2 * c * ops.sum()), nbytes(*read, *out)


def crop_step_bound_s(cfg: dict, boxes: torch.Tensor, imgs_dtype=torch.float32
                      ) -> float:
    """Least seconds of one train step's crop launches on a batch's
    ground-truth ``boxes`` (N, O, 4): the appearance crops of the real
    images, D_obj's crops of the fake image (forward and its d_img
    backward) and, in D_obj's update, of the fake and the real images."""
    from port_bench.reference.scene_model import crop_samplers
    mc, dc = cfg["model"], cfg["discriminator"]
    n, o = boxes.shape[:2]
    h, w = mc["image_size"]
    imgs = torch.empty((n, h, w, 3), dtype=imgs_dtype, device=boxes.device)
    total = 0.0
    for size, fwd, bwd in ((mc["object_size"], 1, 0),
                           (dc["crop_size"], 3, 1)):
        ry, rx = crop_samplers(boxes.float(), size, size, h, w)
        ry, rx = ry.to(imgs_dtype), rx.to(imgs_dtype)
        out = torch.empty((n, o, size, size, 3), dtype=imgs_dtype,
                          device=boxes.device)
        ops, nb = crop_work(imgs, ry, rx, None, (out,))
        total += fwd * bound(ops, nb, "f32")[0]
        if bwd:
            ops, nb = crop_work(imgs, ry, rx, out, (imgs,),
                                needs=(True, False, False))
            total += bwd * bound(ops, nb, "f32")[0]
    return total
