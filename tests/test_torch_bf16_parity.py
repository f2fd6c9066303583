"""The port's bf16 paths against the JAX package's, on the CPU.

Every train run computes the discriminators and VGG in bf16
(``DiscriminatorConfig.compute_dtype``); the ``quality`` and
``throughput`` presets also run the generator in bf16; serving runs in
bf16. The two frameworks round bf16 at different places: JAX keeps f32
parameters and sets each layer's dtype, the port runs a training
generator under ``torch.autocast`` and casts a serving model's
parameters. So the port's bf16 cannot equal JAX's bf16, and the
yardstick is JAX's own bf16 error: with ``jax_f32`` the f32 reference,

    |port_bf16 - jax_f32| <= 3 * |jax_bf16 - jax_f32| + eps

for every loss term of one train step and for every output compared.
``eps`` is one bf16 ulp at the reference's magnitude, 2^-7 of it (plus
1e-6 for terms near 0): a value computed from bf16 activations is not
resolved finer than that, and on one seed JAX's own error can fall far
below it by chance (case (b) below: ``fake_image_loss``, JAX 3e-5 of the
value, the port 4e-3; case (a): ``bbox_pred``, which no bf16 layer
reaches, JAX exactly 0, the port f32 rounding).

Cases, at the JAX package's ``tiny_config`` (train) and ``test_config``
(serving), from one state drawn with numpy and the JAX step's random
draws injected into the port (``tests/test_torch_train_step.py``'s
harness):
  (a) one train step with D and VGG in bf16 (every train run);
  (b) one train step with D, VGG and G in bf16 (the presets' path); the
      generated images too, by mean |difference|;
  (c) a bf16 serving forward of the predicted path: boxes, masks and
      ``obj_repr`` (max |difference|) and the images (mean |difference|).
"""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from scene_generation_tpu.config import test_config as jax_small_config
from scene_generation_tpu.data import synthetic_batch
from scene_generation_tpu.trainer.step import make_train_step
from scene_generation_tpu_torch.convert import (pool_from_jax,
                                                vgg_state_dict_from_jax)
from scene_generation_tpu_torch.trainer.step import Draws, train_step
from scene_generation_tpu_torch.trainer.train_state import (TrainState,
                                                            build_modules)

from _torch_port import (jax_test_forward, jax_variables, port_config,
                         port_model, with_model)
from test_torch_model import _inputs, _run_port
from test_torch_train_step import _cfg, _jax_state, _port_trees

ULP = 2.0 ** -7


def _within(port_err, jax_err, ref_scale):
    return port_err <= 3 * jax_err + ULP * ref_scale + 1e-6


def _dtypes(cfg, d, g):
    return cfg.replace(
        discriminator=dataclasses.replace(cfg.discriminator,
                                          compute_dtype=d),
        model=dataclasses.replace(cfg.model, compute_dtype=g))


def _step(cfg, port: bool):
    """One JAX train step (and, with ``port``, one port step from the same
    state and draws): the scalar metrics and the generated images."""
    batch = synthetic_batch(cfg, seed=0)
    mods, state = _jax_state(cfg, batch)
    s0 = jax.device_get(state)
    _, metrics = make_train_step(mods, donate=False)(state, batch)
    metrics = jax.device_get(metrics)
    jax_out = ({k: float(v) for k, v in metrics.items()
                if not k.startswith("_")},
               np.asarray(metrics["_imgs_pred"], np.float32))
    if not port:
        return jax_out, None
    pcfg = port_config(cfg)
    _, r_noise, r_gt, r_pool = jax.random.split(state.rng, 4)
    mc = cfg.model
    draws = Draws(
        torch.tensor(float(jax.random.bernoulli(r_gt))),
        torch.from_numpy(np.array(jax.random.normal(
            r_noise, (mc.mask_noise_dim,)))),
        torch.from_numpy(np.array(jax.random.randint(
            r_pool, (mc.num_objs,), 0, jnp.maximum(state.pool.counts, 1)))))
    model, d_img, d_obj, d_mask, vgg = build_modules(pcfg)
    trees = _port_trees(pcfg, s0.g_params, s0.d_img_params, s0.d_obj_params,
                        s0.d_mask_params, s0.d_obj_stats, s0.g_stats)
    for name, module in (("g", model), ("d_img", d_img), ("d_obj", d_obj),
                         ("d_mask", d_mask)):
        module.load_state_dict(trees[name])
    vgg.load_state_dict(vgg_state_dict_from_jax(s0.vgg_params))
    st = TrainState(pcfg, model, d_img, d_obj, d_mask, vgg,
                    torch.device("cpu"))
    st.pool = pool_from_jax(s0.pool)
    got = train_step(st, batch, draws)
    return jax_out, ({k: float(v) for k, v in got.items()
                      if not k.startswith("_")},
                     got["_imgs_pred"].float().numpy())


@pytest.fixture(scope="module")
def reference():
    """The JAX step with every module in f32."""
    return _step(_dtypes(_cfg(), "float32", "float32"), port=False)[0]


@pytest.mark.parametrize("g_dtype", ["float32", "bfloat16"],
                         ids=["d_vgg_bf16", "d_vgg_g_bf16"])
def test_bf16_train_step_within_jax_bf16_error(reference, g_dtype):
    (ref, ref_imgs) = reference
    cfg = _dtypes(_cfg(), "bfloat16", g_dtype)
    assert port_config(cfg).discriminator.compute_dtype == "bfloat16"
    (jax_m, jax_imgs), (port_m, port_imgs) = _step(cfg, port=True)
    assert set(port_m) == set(jax_m) == set(ref) and len(ref) == 18
    # bf16 moved the losses: the comparison is not of two f32 runs.
    assert max(abs(jax_m[k] - ref[k]) for k in ref) > 1e-3
    for k in sorted(ref):
        port_err, jax_err = abs(port_m[k] - ref[k]), abs(jax_m[k] - ref[k])
        assert _within(port_err, jax_err, abs(ref[k])), (
            f"{k}: port bf16 {port_m[k]} is {port_err} from the f32 "
            f"{ref[k]}, JAX bf16 {jax_m[k]} {jax_err}")
    port_err = float(np.abs(port_imgs - ref_imgs).mean())
    jax_err = float(np.abs(jax_imgs - ref_imgs).mean())
    assert _within(port_err, jax_err, float(np.abs(ref_imgs).mean())), (
        f"generated images: port {port_err}, JAX {jax_err}")


def test_bf16_serving_forward_within_jax_bf16_error():
    cfg = with_model(jax_small_config(), test_compositor_backend="xla")
    variables = jax_variables(cfg)
    inputs = _inputs(cfg)
    ref = jax_test_forward(cfg, variables, inputs, use_gt=False)
    bf16 = with_model(cfg, compute_dtype="bfloat16")
    jax_b = jax_test_forward(bf16, variables, inputs, use_gt=False)
    model = port_model(bf16, variables, torch.bfloat16)
    assert next(model.parameters()).dtype == torch.bfloat16
    port_b = _run_port(model, inputs, use_gt=False)
    for field, reduce in (("boxes_pred", np.max), ("masks_pred", np.max),
                          ("obj_repr", np.max), ("imgs_pred", np.mean)):
        want = np.asarray(getattr(ref, field), np.float32)
        j = np.asarray(getattr(jax_b, field), np.float32)
        p = getattr(port_b, field).float().numpy()
        assert p.shape == want.shape, field
        port_err = float(reduce(np.abs(p - want)))
        jax_err = float(reduce(np.abs(j - want)))
        assert jax_err > 0, field                  # bf16 moved it
        assert _within(port_err, jax_err, float(reduce(np.abs(want)))), (
            f"{field}: port {port_err}, JAX {jax_err}")
