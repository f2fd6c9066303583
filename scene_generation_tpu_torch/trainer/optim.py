"""Adam with the JAX package's semantics (``trainer/optim.py`` there).

optax's ``adam`` and ``torch.optim.Adam`` compute the same update,
``-lr * m_hat / (sqrt(v_hat) + eps)`` with both moments bias-corrected by
``1 - beta^t``, so the default (f32 moments, f32 gradients) is
``torch.optim.Adam(betas=(beta1, beta2), eps=1e-8)``. The JAX package's
storage options (``adam_mu_dtype``, ``adam_nu_dtype``, ``grads_dtype``)
are not ported yet and raise.

optax updates every parameter every step; ``torch.optim.Adam`` skips a
parameter whose ``.grad`` is None. ``set_grads`` therefore gives every
parameter a gradient, zero where the loss does not reach it.
"""
from __future__ import annotations

from typing import Iterable, Optional, Sequence

import torch

from scene_generation_tpu_torch.config import TrainConfig


def check_storage_dtypes(t: TrainConfig) -> None:
    for name in ("adam_mu_dtype", "adam_nu_dtype", "grads_dtype"):
        if getattr(t, name):
            raise NotImplementedError(
                f"{name}={getattr(t, name)!r}: storage dtypes of the Adam "
                "moments and gradients are not ported yet (f32 only)")


def adam(params: Iterable[torch.nn.Parameter], lr: float,
         t: TrainConfig) -> torch.optim.Adam:
    check_storage_dtypes(t)
    return torch.optim.Adam(list(params), lr=lr, betas=(t.beta1, t.beta2),
                            eps=1e-8)


def set_grads(params: Sequence[torch.nn.Parameter],
              grads: Sequence[Optional[torch.Tensor]]) -> None:
    for p, g in zip(params, grads):
        p.grad = torch.zeros_like(p) if g is None else g


def step(opt: torch.optim.Adam, loss: torch.Tensor,
         params: Sequence[torch.nn.Parameter]) -> None:
    """One update of ``params`` by the gradient of ``loss`` with respect to
    them alone (other leaves of the graph get no ``.grad``)."""
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    set_grads(params, grads)
    opt.step()
