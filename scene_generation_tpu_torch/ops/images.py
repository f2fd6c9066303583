"""Device-side image dtype contract (port of the JAX package's
``ops/images.py``).

Batches carry images as uint8 HWC (the wire format); every consumer maps
them to float32 in [-1, 1] on the device with ``wire_to_float``.
"""
from __future__ import annotations

import torch


def wire_to_float(imgs: torch.Tensor) -> torch.Tensor:
    """uint8 wire-format image -> float32 in [-1, 1]; float passes through.

    ``x * (2/255) - 1`` equals the host mapping ``(x/255 - 0.5) / 0.5``.
    """
    if imgs.dtype == torch.uint8:
        return imgs.to(torch.float32) * (2.0 / 255.0) - 1.0
    return imgs
