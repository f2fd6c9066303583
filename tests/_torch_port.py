"""Shared helpers of the port's parity tests (tests/test_torch_*.py): build
the JAX package's SceneModel and the port's at one config, with the same
weights, and hand both the same numpy inputs."""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scene_generation_tpu.config import Config as JaxConfig
from scene_generation_tpu.data import synthetic_batch
from scene_generation_tpu.models import SceneModel as JaxSceneModel
from scene_generation_tpu_torch.config import Config
from scene_generation_tpu_torch.convert import state_dict_from_jax
from scene_generation_tpu_torch.models import SceneModel


def port_config(cfg: JaxConfig) -> Config:
    return Config.from_json(cfg.to_json())


def with_model(cfg: JaxConfig, **kw) -> JaxConfig:
    return cfg.replace(model=dataclasses.replace(cfg.model, **kw))


def jax_variables(cfg: JaxConfig, seed: int = 0) -> dict:
    """All SceneModel variables (a train-mode init creates the appearance
    encoder's too), drawn with numpy at the shapes ``jax.eval_shape`` gives,
    so no init is compiled. Kernels are N(0, 1/fan_in), embeddings N(0, 1),
    biases and BN scale offsets N(0, 0.1^2); BN running statistics are
    random too, so that a mapping error in them cannot pass by accident."""
    batch = synthetic_batch(cfg, seed=0, batch_size=2)
    model = JaxSceneModel(cfg.model)
    noise = jnp.zeros((cfg.model.mask_noise_dim,))
    shapes = jax.eval_shape(
        model.init, jax.random.PRNGKey(seed), jnp.asarray(batch.objs),
        jnp.asarray(batch.triples), jnp.asarray(batch.attributes),
        jnp.asarray(batch.obj_mask), jnp.asarray(batch.triple_mask), noise,
        imgs=jnp.asarray(batch.imgs), boxes_gt=jnp.asarray(batch.boxes),
        masks_gt=jnp.asarray(batch.masks))
    return random_variables(shapes, seed + 1)


def random_variables(shapes, seed: int) -> dict:
    """Numpy values for a tree of ``jax.eval_shape`` leaves: kernels
    N(0, 1/fan_in), embeddings N(0, 1), biases and BN scale offsets
    N(0, 0.1^2); BN running statistics are random too, so that a mapping
    error in them cannot pass by accident."""
    rng = np.random.RandomState(seed)

    def draw(key, shape):
        if key == "kernel":
            # (in, out) Dense, (kh, kw, in, out) conv, either with a
            # leading scan axis.
            fan_in = int(np.prod(shape[-4:-1])) if len(shape) >= 4 \
                else shape[-2]
            return rng.randn(*shape) / np.sqrt(fan_in)
        if key == "embedding":
            return rng.randn(*shape)
        if key == "mean":
            return 0.2 * rng.randn(*shape)
        if key == "var":
            return 0.5 + rng.rand(*shape)
        return 0.1 * rng.randn(*shape)                     # bias, scale

    def fill(tree):
        return {k: fill(v) if isinstance(v, dict)
                else draw(k, v.shape).astype(np.float32)
                for k, v in sorted(tree.items())}

    # "params" first, then the other collections (the order of the draws).
    return {k: fill(shapes[k])
            for k in sorted(shapes, key=lambda k: (k != "params", k))}


def jax_test_forward(cfg: JaxConfig, variables: dict, inputs: dict,
                     use_gt: bool = True):
    """The JAX SceneModel's test-mode forward on numpy ``inputs``, jitted
    (one compile is much cheaper than eager op-by-op dispatch)."""
    kw = {k: jnp.asarray(v) for k, v in inputs.items()}
    args = [kw.pop(k) for k in ("objs", "triples", "attributes", "obj_mask",
                                "triple_mask", "mask_noise")]
    if not use_gt:
        kw.pop("masks_gt")
    apply = jax.jit(functools.partial(
        JaxSceneModel(cfg.model).apply, test_mode=True, use_gt_box=use_gt,
        train=False))
    return apply(variables, *args, **kw)


def port_model(cfg: JaxConfig, variables: dict,
               dtype: torch.dtype = torch.float32) -> SceneModel:
    pcfg = port_config(cfg)
    model = SceneModel(pcfg.model)
    model.load_state_dict(state_dict_from_jax(variables, pcfg.model))
    return model.to(dtype).eval()


def away_from_half(rng: np.random.RandomState, shape) -> np.ndarray:
    """Masks of 0.1 / 0.9 cells: the test-mode ``> 0.5`` claim is a step,
    so parity inputs keep their resampled values away from it."""
    return np.where(rng.rand(*shape) > 0.4, 0.9, 0.1).astype(np.float32)


@pytest.fixture(scope="module")
def one_torch_thread():
    """One intra-op thread for a module of many small CPU ops (the tiny
    train CLI, checkpoints, the loader): as fast alone, and it does not
    oversubscribe the cores that other test processes share."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)
