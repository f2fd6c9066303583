"""Weights from the seed, made on the card.

``seeded_state`` fills a state dict (names and shapes as the program's
modules have them) from one normal draw of a ``torch.Generator`` on the
device, scaled leaf by leaf: He scaling for convolutions and linear
layers (the generator's blocks are normalized, so this keeps every
activation in range), embeddings at 1/sqrt(width), biases and the stored
offsets of batch-norm scales at 0.02, running means 0 and variances 1.
The same dict goes to the program and to the reference.

``condition_heads`` then does what training would have done for the two
heads whose outputs the layout reads, from a probe of the reference's own
heads: the mask head's batch norms get the statistics of their inputs and
its last convolution is scaled to unit logit spread (``chip_smoke.py::
spread_mask_head`` does the scaling alone: seeded statistics leave every
logit within about 1e-4 of 0, and bf16 then rounds every mask to 0.5, so
nothing is claimed and every image is constant), and the box head's last
layer is set so that predicted boxes spread around the image's middle
(without it half the boxes are empty or inverted).
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, Tuple

import numpy as np
import torch

Shapes = Iterable[Tuple[str, torch.Size]]


def sub_seed(seed: int, *purpose: int) -> int:
    """A 63-bit seed for one use of the run's seed (any whole number)."""
    words = np.random.SeedSequence([int(seed) % 2 ** 128, *purpose]) \
        .generate_state(2, np.uint32)
    return int(words[0]) << 31 ^ int(words[1])


def _std(name: str, shape: torch.Size) -> float:
    if name.endswith(".running_mean") or name.endswith(".running_var"):
        return 0.0
    if name.endswith(".bias") or name.endswith(".scale"):
        return 0.02
    if "embeddings" in name or "class_embed" in name:
        return shape[1] ** -0.5
    if len(shape) == 2:
        return math.sqrt(2.0 / shape[1])
    if len(shape) == 4:
        if ".ups." in name:       # transposed: (in, out, kh, kw), stride 2
            return math.sqrt(2.0 / (shape[0] * shape[2] * shape[3] / 4))
        return math.sqrt(2.0 / (shape[1] * shape[2] * shape[3]))
    raise ValueError(f"no initial scale for {name} {tuple(shape)}")


def seeded_state(shapes: Shapes, seed: int, device) -> Dict[str, torch.Tensor]:
    """f32 tensors on ``device`` for every (name, shape), from one draw."""
    shapes = list(shapes)
    total = sum(int(np.prod(s)) for _, s in shapes)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape in shapes:
        size = int(np.prod(shape))
        std = _std(name, shape)
        if name.endswith(".running_var"):
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = flat[at:at + size].view(shape) * std
        at += size
    return out


def condition_heads(P: Dict[str, torch.Tensor], mc: dict, probe: dict,
                    centre=(0.25, 0.25, 0.75, 0.75),
                    spread: float = 0.12) -> None:
    """Condition the mask and box heads in place, from the reference's
    heads on ``probe`` (a batch of inputs as
    ``reference.scene_model.heads`` takes them): each batch norm of the
    mask head gets the running statistics of its input on the probe's
    valid objects, as a trained model's would be (seeded statistics leave
    the logits a small difference of large terms, which bf16 cannot hold);
    the last 1x1 convolution is scaled to unit logit spread; each output
    of the box head gets mean ``centre`` and spread ``spread`` over the
    probe's objects."""
    from port_bench.reference import no_tf32
    from port_bench.reference.scene_model import (batch_norm, conv, heads,
                                                  linear)
    with torch.no_grad(), no_tf32():
        obj_vecs, _, _, mask_vecs = heads(P, mc, probe, False)
        valid = (probe["obj_mask"] > 0).reshape(-1)
        h = mask_vecs.reshape(valid.shape[0], -1)[valid][:, :, None, None]
        for i in range(int(math.log2(mc["mask_size"]))):
            h = h.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
            h = conv(P, f"mask_net.convs.{i}", h, padding=1)
            name = f"mask_net.bns.{i}"
            P[name + ".running_mean"].copy_(h.mean((0, 2, 3)))
            P[name + ".running_var"].copy_(h.var((0, 2, 3)))
            h = torch.relu(batch_norm(P, name, h, False))
        logits = conv(P, "mask_net.out", h)
        scale = 1.0 / float(logits.double().std())
        P["mask_net.out.weight"] *= scale
        P["mask_net.out.bias"] *= scale
        last = "box_net.layers.1"
        hidden = torch.relu(linear(P, "box_net.layers.0",
                                   obj_vecs[probe["obj_mask"] > 0]))
        pre = hidden @ P[last + ".weight"].T
        gain = spread / pre.double().std(0).float()
        P[last + ".weight"] *= gain[:, None]
        P[last + ".bias"].copy_(torch.tensor(centre, device=gain.device)
                                - pre.mean(0) * gain)
