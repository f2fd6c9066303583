"""The precision a reference computes its products in.

``f32`` is the reference itself (the caller turns TF32 off). ``bf16`` and
``fp8`` are the controls: every operand of a product (convolution, linear
layer) is rounded to that format before the product, which then sums in
f32, and the product's result is rounded to bf16, as a bf16 or an fp8
tensor-core product with a bf16 output would give it. fp8 is e4m3 with one
scale a tensor (its largest magnitude to 448, e4m3's largest value).
Gradients pass the roundings unchanged, in f32.
"""
from __future__ import annotations

import torch

FP8_MAX = 448.0


class Precision:
    def __init__(self, name: str = "f32"):
        if name not in ("f32", "bf16", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def q(self, x: torch.Tensor) -> torch.Tensor:
        """An operand of a product, rounded to this precision."""
        if self.name == "f32":
            return x
        if self.name == "bf16":
            return _rounded(x, x.detach().to(torch.bfloat16).float())
        scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
        return _rounded(x, (x.detach() / scale).to(torch.float8_e4m3fn)
                        .float() * scale)

    def out(self, y: torch.Tensor) -> torch.Tensor:
        """A product's result, rounded as the product stores it."""
        if self.name == "f32":
            return y
        return _rounded(y, y.detach().to(torch.bfloat16).float())


def _rounded(x: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """``r``'s value with ``x``'s gradient: gradients pass a rounding
    unchanged (an unscaled fp8 gradient would underflow to 0)."""
    return x + (r - x).detach()


F32 = Precision("f32")
