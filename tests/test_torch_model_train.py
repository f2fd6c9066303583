"""The port's train-mode SceneModel forward against the JAX package's
(``model.apply(..., train=True, mutable=["batch_stats"])``), at
``test_config`` (64x64 images, O=5, appearance crops at 32 px) on the CPU
in f32, with the JAX weights carried across by
``convert.state_dict_from_jax``.

Compared: the image, the three train layouts (GT, predicted masks, wrong
texture), the encoded appearance vectors and the batch statistics the
forward moved. Tolerances: 2e-4 absolute on images (a deep generator of
f32 convs and instance norms, as tests/test_torch_model.py), 1e-5 absolute
plus 1e-5 relative on the rest (the layouts are sums of vectors of up to
~3 over the objects). Also: in train mode the factored stem is
differentiable, so the stem conv, the appearance encoder and everything
upstream of the layout vectors get gradients.
"""
import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from scene_generation_tpu.config import test_config as jax_small_config
from scene_generation_tpu.data import synthetic_batch
from scene_generation_tpu.models import SceneModel as JaxSceneModel
from scene_generation_tpu_torch.convert import state_dict_from_jax

from _torch_port import jax_variables, port_config, port_model, with_model

FIELDS = {"imgs_pred": 2e-4, "layout": 1e-5, "layout_pred": 1e-5,
          "layout_wrong": 1e-5, "obj_repr": 1e-5, "boxes_pred": 1e-5,
          "masks_pred": 1e-5}


def _inputs(cfg, seed=1):
    batch = synthetic_batch(cfg, seed=seed, batch_size=2)
    rng = np.random.RandomState(seed)
    n, o = batch.objs.shape
    return dict(objs=batch.objs, triples=batch.triples,
                attributes=batch.attributes, obj_mask=batch.obj_mask,
                triple_mask=batch.triple_mask,
                mask_noise=rng.randn(cfg.model.mask_noise_dim).astype(
                    np.float32),
                imgs=batch.imgs, boxes_gt=batch.boxes, masks_gt=batch.masks,
                wrong_rep=rng.randn(n, o, cfg.model.rep_size).astype(
                    np.float32))


def _port_train_forward(model, inputs):
    kw = {k: torch.from_numpy(np.asarray(v)) for k, v in inputs.items()}
    return model.train()(**kw)


@pytest.fixture(scope="module", params=[True, False],
                ids=["factored", "dense"])
def case(request):
    cfg = with_model(jax_small_config(), factored_stem=request.param)
    variables = jax_variables(cfg, seed=7)
    inputs = _inputs(cfg)
    kw = {k: jnp.asarray(v) for k, v in inputs.items()}
    args = [kw.pop(k) for k in ("objs", "triples", "attributes", "obj_mask",
                                "triple_mask", "mask_noise")]
    want, mutated = jax.jit(functools.partial(
        JaxSceneModel(cfg.model).apply, train=True,
        mutable=["batch_stats"]))(variables, *args, **kw)
    return cfg, variables, inputs, want, jax.device_get(mutated)


def test_train_forward_matches_jax(case):
    cfg, variables, inputs, want, _ = case
    got = _port_train_forward(port_model(cfg, variables), inputs)
    for field, tol in FIELDS.items():
        a = getattr(got, field).detach().numpy()
        b = np.asarray(getattr(want, field))
        assert a.shape == b.shape, field
        np.testing.assert_allclose(a, b, atol=tol, rtol=1e-5, err_msg=field)
    assert float(np.asarray(want.imgs_pred).std()) > 1e-3
    assert float(np.abs(np.asarray(want.layout_wrong)
                        - np.asarray(want.layout)).max()) > 1e-3


def test_train_forward_moves_batch_statistics_as_jax(case):
    cfg, variables, inputs, _, mutated = case
    model = port_model(cfg, variables)
    _port_train_forward(model, inputs)
    want = state_dict_from_jax({"params": variables["params"],
                                "batch_stats": mutated["batch_stats"]},
                               port_config(cfg).model)
    before = port_model(cfg, variables).state_dict()
    moved = 0
    for k, v in model.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=1e-5,
                                       rtol=1e-5, err_msg=k)
            moved += int(not torch.equal(v, before[k]))
    # The appearance encoder's and the mask net's batch norms moved.
    assert moved >= 2 * (2 + 4)


def test_train_mode_gradient_reaches_the_stem_and_the_encoder(case):
    cfg, variables, inputs, _, _ = case
    model = port_model(cfg, variables)
    out = _port_train_forward(model, inputs)
    out.imgs_pred.square().mean().backward()
    for name in ("layout_to_image.stem.conv.weight",
                 "image_encoder.cnn.convs.0.weight",
                 "image_encoder.dense.weight", "repr_net.layers.0.weight"):
        grad = dict(model.named_parameters())[name].grad
        assert grad is not None and float(grad.abs().max()) > 0, name
