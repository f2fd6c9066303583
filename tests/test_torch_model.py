"""The port's test-mode SceneModel against the JAX package's, at
``test_config`` on the CPU, with the JAX weights carried across by
``convert.state_dict_from_jax``.

The factored and the dense stem path, each with the flax 'SAME' and the
torch transpose-conv upsampling, are compared in f32 on every output. The
test-mode claim ``> 0.5`` is a step, so the f32 comparisons composite GT
masks of 0.1 / 0.9 (kept away from it, checked below); the predicted masks
are compared on their own, and the whole predicted path again in f64.

Tolerances: f32, 1e-5 on boxes, masks and layouts (a few layers of f32
products) and 2e-4 on images (as tests/test_factored_stem.py: a deep
generator of convs and instance norms); f64, 1e-6 (the outputs are f32).
"""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from scene_generation_tpu.config import test_config as jax_small_config
from scene_generation_tpu.config import tiny_config as jax_tiny_config
from scene_generation_tpu.data import synthetic_batch
from scene_generation_tpu.models import SceneModel as JaxSceneModel
from scene_generation_tpu.models.layers import MaskedBatchNorm as JaxBN
from scene_generation_tpu_torch.convert import state_dict_from_jax
from scene_generation_tpu_torch.models.layers import MaskedBatchNorm
from scene_generation_tpu_torch.ops.layout import _sample_masks

from _torch_port import (away_from_half, jax_test_forward, jax_variables,
                         port_config, port_model, with_model)

FIELDS_F32 = {"imgs_pred": 2e-4, "boxes_pred": 1e-5, "masks_pred": 1e-5,
              "layout_pred": 1e-5, "obj_repr": 1e-5, "cls_vecs": 0.0}


@pytest.fixture(scope="module", params=[False, True],
                ids=["same_deconv", "torch_deconv"])
def weights(request):
    cfg = with_model(jax_small_config(), torch_deconv=request.param)
    return cfg, jax_variables(cfg)


def _inputs(cfg, seed=1):
    batch = synthetic_batch(cfg, seed=seed, batch_size=2)
    rng = np.random.RandomState(seed)
    n, o = batch.objs.shape
    mc = cfg.model
    return dict(
        objs=batch.objs, triples=batch.triples, attributes=batch.attributes,
        obj_mask=batch.obj_mask, triple_mask=batch.triple_mask,
        mask_noise=rng.randn(mc.mask_noise_dim).astype(np.float32),
        boxes_gt=batch.boxes,
        masks_gt=away_from_half(rng, (n, o, mc.mask_size, mc.mask_size)),
        features=rng.randn(n, o, mc.rep_size).astype(np.float32),
        features_mask=(rng.rand(n, o) > 0.5).astype(np.float32))


def _run_port(model, inputs, use_gt=True, return_layout=False):
    kw = {k: torch.from_numpy(np.asarray(v)) for k, v in inputs.items()}
    if not use_gt:
        kw.pop("masks_gt")
    with torch.no_grad():
        return model(**kw, use_gt_box=use_gt, return_layout=return_layout)


def _test_forward_matches_jax(cfg, variables, margin=1e-5):
    """The port's test-mode forward against the JAX package's on the same
    weights and inputs, every output within ``FIELDS_F32``."""
    inputs = _inputs(cfg)
    # The composited masks stay ``margin`` away from the claim step (f32
    # rounding of the two libraries differs by ~1e-7).
    sampled = _sample_masks(torch.from_numpy(inputs["boxes_gt"]),
                            torch.from_numpy(inputs["masks_gt"]),
                            *cfg.model.image_size)
    valid = torch.from_numpy(inputs["obj_mask"]).bool()
    assert float((sampled[valid] - 0.5).abs().min()) > margin
    want = jax_test_forward(cfg, variables, inputs)
    got = _run_port(port_model(cfg, variables), inputs, return_layout=True)
    for field, tol in FIELDS_F32.items():
        a, b = getattr(got, field).numpy(), np.asarray(getattr(want, field))
        assert a.shape == b.shape, field
        np.testing.assert_allclose(a, b, atol=tol, rtol=0, err_msg=field)
    assert float(np.asarray(want.imgs_pred).std()) > 1e-3   # not degenerate


@pytest.mark.parametrize("factored", [True, False],
                         ids=["factored", "dense"])
def test_scene_model_matches_jax(weights, factored):
    cfg, variables = weights
    _test_forward_matches_jax(with_model(cfg, factored_stem=factored,
                                         test_compositor_backend="xla"),
                              variables)


def test_scene_model_matches_jax_at_256_px():
    """The paper's second resolution, 256x256, at ``tiny_config``'s
    widths (a few seconds on the CPU). Each mask is sampled at 256^2
    pixels, so some land within 1e-5 of the claim step: the margin is
    1e-6, still ten times the libraries' rounding difference."""
    cfg = jax_tiny_config()
    cfg = cfg.replace(data=dataclasses.replace(cfg.data,
                                               image_size=(256, 256)))
    cfg = with_model(cfg, image_size=(256, 256),
                     test_compositor_backend="xla")
    _test_forward_matches_jax(cfg, jax_variables(cfg), margin=1e-6)


def test_factored_path_leaves_out_the_layout(weights):
    cfg, variables = weights
    out = _run_port(port_model(cfg, variables), _inputs(cfg))
    assert out.layout_pred is None


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


@pytest.mark.parametrize("factored", [True, False],
                         ids=["factored", "dense"])
def test_predicted_path_matches_jax_in_f64(weights, factored, x64):
    cfg, variables = weights
    cfg = with_model(cfg, factored_stem=factored, compute_dtype="float64",
                     test_compositor_backend="xla")
    inputs = _inputs(cfg, seed=2)
    want = jax_test_forward(cfg, variables, inputs, use_gt=False)
    got = _run_port(port_model(cfg, variables, torch.float64), inputs,
                    use_gt=False)
    for field in ("masks_pred", "boxes_pred", "imgs_pred"):
        np.testing.assert_allclose(getattr(got, field).numpy(),
                                   np.asarray(getattr(want, field)),
                                   atol=1e-6, rtol=0, err_msg=field)


def test_encode_crops_matches_jax(weights):
    cfg, variables = weights
    crops = np.random.RandomState(3).uniform(
        -1, 1, (4, cfg.model.object_size, cfg.model.object_size, 3)).astype(
            np.float32)
    want = JaxSceneModel(cfg.model).apply(
        variables, jnp.asarray(crops), train=False,
        method=JaxSceneModel.encode_crops)
    with torch.no_grad():
        got = port_model(cfg, variables).encode_crops(torch.from_numpy(crops))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("ndim", [2, 4])
def test_masked_batch_norm_matches_jax(weighted, ndim):
    """Batch statistics (weighted or not), the running update, and the
    running-average path, against the JAX module."""
    rng = np.random.RandomState(4)
    shape = (6, 5) if ndim == 2 else (6, 3, 4, 5)         # channels last
    x = (2 + 3 * rng.randn(*shape)).astype(np.float32)
    w = (rng.rand(6) > 0.4).astype(np.float32) if weighted else None
    jbn = JaxBN()
    variables = jax.device_get(jbn.init(jax.random.PRNGKey(0), x))
    variables["params"]["scale"] = rng.randn(5).astype(np.float32) * 0.1
    variables["params"]["bias"] = rng.randn(5).astype(np.float32)
    y, updated = jbn.apply(variables, jnp.asarray(x),
                           weights=None if w is None else jnp.asarray(w),
                           mutable=["batch_stats"])

    bn = MaskedBatchNorm(5)
    with torch.no_grad():
        bn.scale.copy_(torch.from_numpy(variables["params"]["scale"]))
        bn.bias.copy_(torch.from_numpy(variables["params"]["bias"]))
    xt = torch.from_numpy(x)
    xt = xt if ndim == 2 else xt.permute(0, 3, 1, 2)
    got = bn.train()(xt, None if w is None else torch.from_numpy(w))
    got = got if ndim == 2 else got.permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(y),
                               atol=1e-5)
    stats = updated["batch_stats"]
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(stats["mean"]), atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(stats["var"]), atol=1e-5)
    y_eval = jbn.apply({"params": variables["params"],
                        "batch_stats": jax.device_get(stats)},
                       jnp.asarray(x), use_running_average=True)
    got_eval = bn.eval()(xt)
    got_eval = got_eval if ndim == 2 else got_eval.permute(0, 2, 3, 1)
    np.testing.assert_allclose(got_eval.detach().numpy(), np.asarray(y_eval),
                               atol=1e-5)


def test_converter_is_strict(weights):
    cfg, variables = weights
    pcfg = port_config(cfg).model
    extra = {"params": {**variables["params"],
                        "stray": {"kernel": np.zeros(3, np.float32)}},
             "batch_stats": variables["batch_stats"]}
    with pytest.raises(ValueError, match="stray"):
        state_dict_from_jax(extra, pcfg)
    params = dict(variables["params"])
    params.pop("repr_net")
    with pytest.raises(KeyError, match="repr_net"):
        state_dict_from_jax({"params": params,
                             "batch_stats": variables["batch_stats"]}, pcfg)


def test_unrolled_blocks_and_batch_norm_mlps_match_jax():
    """The converter's other trees: unrolled ``resblock_i`` generator
    blocks, masked-BN MLPs (GCN, box and repr nets) and a box head without
    its final ReLU."""
    cfg = with_model(jax_small_config(), scan_blocks=False,
                     mlp_normalization="batch", box_net_final="none")
    variables = jax_variables(cfg, seed=5)
    assert "resblock_0" in variables["params"]["layout_to_image"]
    inputs = _inputs(cfg, seed=3)
    want = jax_test_forward(cfg, variables, inputs)
    got = _run_port(port_model(cfg, variables), inputs)
    for field in ("imgs_pred", "boxes_pred", "masks_pred", "obj_repr"):
        np.testing.assert_allclose(getattr(got, field).numpy(),
                                   np.asarray(getattr(want, field)),
                                   atol=FIELDS_F32[field], rtol=0,
                                   err_msg=field)
