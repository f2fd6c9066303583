"""Published peaks of one NVIDIA H100 SXM and the least time of a piece of
work, frozen for the benchmark (copied from ``chip_smoke.py``'s
``PEAK_FLOPS``, ``PEAK_BYTES`` and ``bound``).

NVIDIA's data sheet, dense rates without sparsity, at the full 700 W:
bf16 on the tensor cores, TF32 on the tensor cores, f32 outside them, and
HBM bandwidth. A card set below 700 W reads lower against them; the run
reports the card's name beside every number.
"""
from __future__ import annotations

from typing import Tuple

PEAK_FLOPS = {"bf16": 989e12, "tf32": 495e12, "f32": 67e12}
PEAK_BYTES = 3.35e12


def bound(flops: float, nbytes: float, precision: str) -> Tuple[float, str]:
    """(seconds, 'operations' | 'bytes'): the least time the card could
    take for ``flops`` operations at ``precision``'s peak and ``nbytes``
    moved once through HBM."""
    t_ops = flops / PEAK_FLOPS[precision]
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")
