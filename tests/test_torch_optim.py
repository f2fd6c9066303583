"""The port's Adam (``trainer/optim.py``) against the JAX package's
``adam_storage`` (``optax.adam`` plus a ``nu_dtype``), on the CPU.

The same parameters and five steps of the same gradients (numpy, from a
seed) go through both, for f32 moments, bf16 mu, bf16 nu and f16 nu:
every parameter and stored moment within one unit in the last place of
its dtype (XLA on the CPU contracts ``a*b + c`` into one fused
multiply-add, PyTorch rounds the product first: one ulp apart at most),
the stored dtypes equal and the step counts equal. Then the ports of
``tests/test_optim.py``'s proofs that a bf16 ``nu`` freezes and an f16
``nu`` underflows, and ``grads_dtype`` in one train step.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from scene_generation_tpu.trainer.optim import adam_storage
from scene_generation_tpu_torch.config import TrainConfig, tiny_config
from scene_generation_tpu_torch.data import synthetic_batch
from scene_generation_tpu_torch.trainer import optim
from scene_generation_tpu_torch.trainer.optim import Adam
from scene_generation_tpu_torch.trainer.step import train_step
from scene_generation_tpu_torch.trainer.train_state import create_train_state

from _torch_port import one_torch_thread  # noqa: F401

SHAPES = {"b": (8,), "w": (16, 8)}
CASES = {"f32": ("", ""), "bf16_mu": ("bfloat16", ""),
         "bf16_nu": ("", "bfloat16"), "f16_nu": ("", "float16")}
_INT = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
        torch.float16: torch.int16}

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def max_ulp(a: torch.Tensor, b: torch.Tensor) -> int:
    """The largest distance between ``a`` and ``b`` in units in the last
    place of their (common) dtype."""
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    mask = (1 << (8 * a.element_size() - 1)) - 1

    def ordered(x):
        i = x.contiguous().view(_INT[x.dtype]).long()
        return torch.where(i < 0, -(i & mask), i)

    return int((ordered(a) - ordered(b)).abs().max())


def _torch(x, dtype) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x).astype(np.float32)).to(dtype)


def _run_both(mu_name, nu_name, grads, params, lr=1e-3, b1=0.5, b2=0.999):
    jdt = {"": None, "bfloat16": jnp.bfloat16, "float16": jnp.float16}
    tx = adam_storage(lr, b1=b1, b2=b2, mu_dtype=jdt[mu_name],
                      nu_dtype=jdt[nu_name])
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = tx.init(jp)
    for g in grads:
        upd, js = tx.update({k: jnp.asarray(v) for k, v in g.items()}, js,
                            jp)
        jp = optax.apply_updates(jp, upd)
    tp = [torch.nn.Parameter(torch.from_numpy(params[k].copy()))
          for k in SHAPES]
    opt = Adam(tp, lr, b1=b1, b2=b2, mu_dtype=optim.storage_dtype(mu_name),
               nu_dtype=optim.storage_dtype(nu_name))
    for g in grads:
        opt.update([torch.from_numpy(g[k]) for k in SHAPES])
    return jp, js[0], tp, opt


@pytest.mark.parametrize("case", list(CASES))
def test_five_steps_match_jax_adam_storage(case):
    mu_name, nu_name = CASES[case]
    rng = np.random.RandomState(0)
    params = {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    # Gradient scales from 1e-3 to 1, so the moments span many binades.
    grads = [{k: (rng.randn(*s) * 10 ** rng.uniform(-3, 0, s[-1]))
              .astype(np.float32) for k, s in SHAPES.items()}
             for _ in range(5)]
    jp, jstate, tp, opt = _run_both(mu_name, nu_name, grads, params)
    sd = opt.state_dict()
    assert sd["count"] == int(jstate.count) == 5
    for i, k in enumerate(SHAPES):
        assert max_ulp(tp[i].detach(), _torch(jp[k], torch.float32)) <= 1, k
        for name in ("mu", "nu"):
            want = getattr(jstate, name)[k]
            dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                     "float16": torch.float16}[np.dtype(want.dtype).name]
            got = sd[name][i]
            assert got.dtype == dtype, (name, k, got.dtype, dtype)
            assert max_ulp(got, _torch(want, dtype)) <= 1, (name, k)
        assert float(sd["mu"][i].float().abs().max()) > 0


def _nu_after(opt: Adam) -> float:
    return float(opt.state_dict()["nu"][0][0])


def test_bf16_nu_stalls_below_steady_state_and_cannot_decay():
    """Constant g = 1 for 3000 steps: an f32 nu nears 1 - 0.999^3000, a
    bf16 nu stalls well short (b2 = 0.999 is 1.0 in bf16, so the moment
    only grows by the rounded (1 - b2) g^2). Then 2000 zero-gradient
    steps: the f32 nu decays by 0.999^2000, the bf16 one stays frozen."""
    p_bf = [torch.nn.Parameter(torch.zeros(8))]
    p_32 = [torch.nn.Parameter(torch.zeros(8))]
    bf = Adam(p_bf, 1e-3, b1=0.5, b2=0.999, nu_dtype=torch.bfloat16)
    f32 = Adam(p_32, 1e-3, b1=0.5, b2=0.999)
    hot, zero = [torch.ones(8)], [torch.zeros(8)]
    for _ in range(3000):
        bf.update(hot)
        f32.update(hot)
    nu_bf_hot, nu_f32_hot = _nu_after(bf), _nu_after(f32)
    assert nu_f32_hot > 0.93
    assert nu_bf_hot < 0.80
    for _ in range(2000):
        bf.update(zero)
        f32.update(zero)
    assert _nu_after(f32) < 0.20 * nu_f32_hot
    assert _nu_after(bf) == nu_bf_hot


def test_f16_nu_accumulates_but_underflows_small_gradients():
    opt = Adam([torch.nn.Parameter(torch.zeros(4))], 1e-3, b1=0.5, b2=0.999,
               nu_dtype=torch.float16)
    for _ in range(2000):
        opt.update([torch.full((4,), 0.1)])
    assert abs(_nu_after(opt) - 0.01 * (1 - 0.999 ** 2000)) < 0.15 * 0.01

    # |g| = 1e-4: (1 - b2) g^2 = 1e-11 is far below f16's smallest
    # subnormal (~6e-8), so nu never leaves zero.
    opt = Adam([torch.nn.Parameter(torch.zeros(4))], 1e-3, b1=0.5, b2=0.999,
               nu_dtype=torch.float16)
    for _ in range(500):
        opt.update([torch.full((4,), 1e-4)])
    assert float(opt.state_dict()["nu"][0].abs().max()) == 0.0


def test_grads_dtype_in_one_train_step(monkeypatch):
    """``grads_dtype=bfloat16``: every optimizer of the step receives bf16
    gradients, the moments promote them back (mu and nu stay f32, as
    optax's promotion gives) and every tree moves."""
    cfg = tiny_config()
    cfg = cfg.replace(train=dataclasses.replace(cfg.train,
                                                grads_dtype="bfloat16"))
    state = create_train_state(cfg, "cpu", seed=0, load_vgg=False)
    seen = []
    real = Adam.update

    def spy(self, grads):
        seen.append({g.dtype for g in grads})
        return real(self, grads)

    monkeypatch.setattr(Adam, "update", spy)
    before = {n: [p.detach().clone() for p in m.parameters()]
              for n, m, _ in state.trees()}
    metrics = train_step(state, synthetic_batch(cfg, seed=0))
    assert seen == [{torch.bfloat16}] * 4
    assert np.isfinite(float(metrics["total_loss"]))
    for name, module, opt in state.trees():
        sd = opt.state_dict()
        assert sd["count"] == 1
        assert {m.dtype for m in sd["mu"] + sd["nu"]} == {torch.float32}
        moved = [not torch.equal(a, p) for a, p in
                 zip(before[name], module.parameters())]
        assert sum(moved) / len(moved) > 0.5, name


def test_storage_dtype_names():
    assert optim.check_storage_dtypes(TrainConfig(
        adam_mu_dtype="bfloat16", adam_nu_dtype="float16")) == {
        "adam_mu_dtype": torch.bfloat16, "adam_nu_dtype": torch.float16,
        "grads_dtype": None}
    with pytest.raises(ValueError, match="float64"):
        optim.storage_dtype("float64")
