"""Adam with storage dtypes for its moments (port of the JAX package's
``trainer/optim.py``: ``optax.adam`` and ``adam_storage``).

One hand-written optimizer serves every case. It follows optax's order
of operations rather than ``torch.optim.Adam``'s:

  mu    = (1 - b1) g   + b1 mu       in the dtype promoted from (g, mu)
  nu    = (1 - b2) g^2 + b2 nu       likewise
  count = count + 1
  u     = (mu / (1 - b1^count)) / (sqrt(nu / (1 - b2^count)) + eps)
  p     = p + (-lr) u
  mu, nu are then cast to their storage dtypes (f32 unless configured)

(``torch.optim.Adam`` divides by ``sqrt(nu) / sqrt(1 - b2^count) + eps``
instead.) A Python constant takes the dtype of the tensor it multiplies,
as JAX's weakly typed scalars do: ``b2 = 0.999`` is 1.0 in bf16, which is
why a bf16 ``nu`` freezes (``tests/test_torch_optim.py``).

Each parameter's state is ``count``, ``mu`` and ``nu``, the fields of
optax's ``ScaleByAdamState``, so a JAX optimizer state maps onto it one to
one (``convert.adam_state_from_jax``). optax updates every parameter every
step; ``step`` below therefore hands ``update`` a gradient for every
parameter, zero where the loss does not reach it.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from scene_generation_tpu_torch.config import TrainConfig
from scene_generation_tpu_torch.parallel import data_parallel

_STORAGE = {"": None, "float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}


def storage_dtype(name: str) -> Optional[torch.dtype]:
    """A storage-dtype flag (``""`` = f32, the reference's) as a torch
    dtype, or None for f32."""
    if name not in _STORAGE:
        raise ValueError(f"unknown storage dtype {name!r}; one of "
                         f"{sorted(_STORAGE)}")
    return _STORAGE[name]


def check_storage_dtypes(t: TrainConfig) -> Dict[str, Optional[torch.dtype]]:
    """The three storage dtypes of ``t`` by flag name; raises on a name
    that is not a dtype."""
    return {name: storage_dtype(getattr(t, name))
            for name in ("adam_mu_dtype", "adam_nu_dtype", "grads_dtype")}


def _weak(x: float, dtype: torch.dtype) -> float:
    """``x`` rounded to ``dtype``: a JAX Python scalar's value next to a
    tensor of that dtype."""
    return float(torch.tensor(x, dtype=dtype))


def _ema(moments: List[torch.Tensor], terms: List[torch.Tensor],
         decay: float) -> List[torch.Tensor]:
    """``terms + decay * moments`` in the promoted dtype (new tensors)."""
    out = torch._foreach_mul(moments, _weak(decay, moments[0].dtype))
    dtype = torch.promote_types(out[0].dtype, terms[0].dtype)
    out = [o.to(dtype) for o in out]
    torch._foreach_add_(out, [t.to(dtype) for t in terms])
    return out


class Adam(torch.optim.Optimizer):
    """optax's Adam over one group of parameters, with ``mu_dtype`` and
    ``nu_dtype`` storage (None: the dtype the update computes in)."""

    def __init__(self, params, lr: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 mu_dtype: Optional[torch.dtype] = None,
                 nu_dtype: Optional[torch.dtype] = None):
        super().__init__(list(params), dict(lr=lr, b1=b1, b2=b2, eps=eps))
        self.mu_dtype = mu_dtype
        self.nu_dtype = nu_dtype
        for p in self.params:
            self.state[p] = dict(
                count=0,
                mu=torch.zeros_like(p, dtype=mu_dtype or p.dtype),
                nu=torch.zeros_like(p, dtype=nu_dtype or p.dtype))

    @property
    def params(self) -> List[torch.Tensor]:
        return self.param_groups[0]["params"]

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor]) -> None:
        """One update of every parameter by ``grads`` (in parameter order,
        any floating dtype: a bf16 gradient promotes with the moments)."""
        group = self.param_groups[0]
        b1, b2, eps, lr = group["b1"], group["b2"], group["eps"], group["lr"]
        params = self.params
        grads = list(grads)
        states = [self.state[p] for p in params]
        gdt = grads[0].dtype
        mu = _ema([s["mu"] for s in states],
                  torch._foreach_mul(grads, _weak(1 - b1, gdt)), b1)
        sq = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(sq, _weak(1 - b2, gdt))
        nu = _ema([s["nu"] for s in states], sq, b2)
        del sq
        count = states[0]["count"] + 1
        # optax: 1 - decay**count, a float power in f32 (an integer power
        # rounds differently, and 1 - b2^t magnifies that), then in the
        # moment's dtype.
        t = torch.tensor(float(count))
        bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32), t)
        bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32), t)
        u = torch._foreach_div(mu, float(bc1.to(mu[0].dtype)))
        den = torch._foreach_div(nu, float(bc2.to(nu[0].dtype)))
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, _weak(eps, den[0].dtype))
        torch._foreach_div_(u, den)
        del den
        torch._foreach_mul_(u, _weak(-lr, u[0].dtype))
        if u[0].dtype == params[0].dtype:
            torch._foreach_add_(params, u)
        else:
            for p, d in zip(params, u):
                p.copy_(p + d)
        for s, m, n in zip(states, mu, nu):
            s["count"] = count
            s["mu"] = m if self.mu_dtype is None else m.to(self.mu_dtype)
            s["nu"] = n if self.nu_dtype is None else n.to(self.nu_dtype)

    def state_dict(self) -> dict:
        """``{"count", "mu": [...], "nu": [...], "lr"}``, the lists in
        parameter order (the live tensors; ``CheckpointManager`` copies
        them)."""
        states = [self.state[p] for p in self.params]
        return {"count": states[0]["count"] if states else 0,
                "mu": [s["mu"] for s in states],
                "nu": [s["nu"] for s in states],
                "lr": self.param_groups[0]["lr"]}

    def load_state_dict(self, sd: dict) -> None:
        """Take ``sd``'s moments as they are (dtype included) onto the
        parameters' device."""
        params = self.params
        if len(sd["mu"]) != len(params) or len(sd["nu"]) != len(params):
            raise ValueError(f"optimizer state for {len(sd['mu'])} "
                             f"parameters, this optimizer has {len(params)}")
        for p, m, n in zip(params, sd["mu"], sd["nu"]):
            if m.shape != p.shape or n.shape != p.shape:
                raise ValueError(f"moment shape {tuple(m.shape)} for a "
                                 f"parameter of {tuple(p.shape)}")
            self.state[p] = dict(count=int(sd["count"]),
                                 mu=m.to(p.device), nu=n.to(p.device))


def adam(params, lr: float, t: TrainConfig) -> Adam:
    """The reference's Adam (betas (beta1, beta2), eps 1e-8) with the
    configured moment storage dtypes."""
    dt = check_storage_dtypes(t)
    return Adam(params, lr, b1=t.beta1, b2=t.beta2, eps=1e-8,
                mu_dtype=dt["adam_mu_dtype"], nu_dtype=dt["adam_nu_dtype"])


def step(opt: Adam, loss: torch.Tensor, params: Sequence[torch.Tensor],
         grads_dtype: Optional[torch.dtype] = None) -> None:
    """One update of ``params`` by the gradient of ``loss`` with respect to
    them alone (other leaves of the graph get no ``.grad``): zero where
    the loss does not reach a parameter, summed over the ranks under data
    parallelism (the loss is this rank's share), cast to ``grads_dtype``
    (the JAX step's cast at the backward-to-optimizer boundary) when
    given."""
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(params, grads)]
    grads = data_parallel.reduce_grads(data_parallel.current().comm, grads)
    if grads_dtype is not None:
        grads = [g.to(grads_dtype) for g in grads]
    opt.update(grads)
