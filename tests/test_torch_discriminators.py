"""The port's three discriminators against the JAX package's, at
``test_config``'s discriminator widths on the CPU, in f32, with the JAX
weights carried across by the converters of ``convert.py``.

D_img (multiscale PatchGAN, every stage's features), D_mask (the
class-conditional mask PatchGAN) and D_obj (crops, masked-BN CNN, score
and AC logits, in train mode with the batch statistics it updates, and in
eval mode). Tolerance 1e-5 absolute (a few f32 conv layers; values of
order 1).
"""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from scene_generation_tpu.config import test_config as jax_small_config
from scene_generation_tpu.models.discriminators import (
    AcCropDiscriminator as JaxAcCrop,
    MultiscaleDiscriminator as JaxMultiscale,
    MultiscaleMaskDiscriminator as JaxMaskD)
from scene_generation_tpu_torch.convert import (d_img_state_dict_from_jax,
                                                d_mask_state_dict_from_jax,
                                                d_obj_state_dict_from_jax)
from scene_generation_tpu_torch.models.discriminators import (
    AcCropDiscriminator, MultiscaleDiscriminator, MultiscaleMaskDiscriminator)

from _torch_port import port_config, random_variables

CFG = jax_small_config()
DC = CFG.discriminator
PDC = port_config(CFG).discriminator
TOL = 1e-5


def _nchw_to_nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


def _compare_feats(got, want):
    assert len(got) == len(want)
    for scale_got, scale_want in zip(got, want):
        assert len(scale_got) == len(scale_want)
        for a, b in zip(scale_got, scale_want):
            np.testing.assert_allclose(_nchw_to_nhwc(a), np.asarray(b),
                                       atol=TOL, rtol=0)


@pytest.mark.parametrize("norm", ["instance", "none"])
def test_image_discriminator_matches_jax(norm):
    jd = JaxMultiscale(ndf=DC.ndf, n_layers=DC.n_layers_d, norm=norm,
                       num_d=DC.num_d)
    x = np.random.RandomState(0).randn(2, 64, 64, 7).astype(np.float32)
    shapes = jax.eval_shape(jd.init, jax.random.PRNGKey(0), jnp.asarray(x))
    params = random_variables(shapes, 1)["params"]
    assert sorted(params) == ["scale_0", "scale_1"]
    want = jax.jit(jd.apply)({"params": params}, jnp.asarray(x))
    d = MultiscaleDiscriminator(7, ndf=DC.ndf, n_layers=DC.n_layers_d,
                                norm=norm, num_d=DC.num_d)
    d.load_state_dict(d_img_state_dict_from_jax(params, PDC))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = d(xt)
    _compare_feats(got, want)
    # The input gradient through both scales (the pool between them too).
    want_grad = jax.grad(lambda a: sum(
        jnp.sum(s[-1]) for s in jd.apply({"params": params}, a)))(
            jnp.asarray(x))
    sum(s[-1].sum() for s in got).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_grad),
                               atol=TOL, rtol=1e-5)


def test_mask_discriminator_matches_jax():
    num_classes = 12
    jd = JaxMaskD(ndf=DC.ndf_mask, n_layers=DC.n_layers_d_mask, num_d=2)
    rng = np.random.RandomState(2)
    masks = rng.rand(6, 16, 16, 1).astype(np.float32)
    cond = np.eye(num_classes, dtype=np.float32)[rng.randint(0, 12, 6)]
    shapes = jax.eval_shape(jd.init, jax.random.PRNGKey(0),
                            jnp.asarray(masks), jnp.asarray(cond))
    params = random_variables(shapes, 3)["params"]
    want = jax.jit(jd.apply)({"params": params}, jnp.asarray(masks),
                             jnp.asarray(cond))
    d = MultiscaleMaskDiscriminator(num_classes, ndf=DC.ndf_mask,
                                    n_layers=DC.n_layers_d_mask, num_d=2)
    d.load_state_dict(d_mask_state_dict_from_jax(
        params, dataclasses.replace(PDC, num_d_mask=2)))
    _compare_feats(d(torch.from_numpy(masks), torch.from_numpy(cond)), want)


@pytest.fixture(scope="module")
def d_obj_case():
    num_objects = 12
    jd = JaxAcCrop(num_objects=num_objects, object_size=DC.crop_size,
                   arch=DC.d_obj_arch)
    rng = np.random.RandomState(4)
    imgs = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    x0 = rng.uniform(0, .6, (2, 5))
    y0 = rng.uniform(0, .6, (2, 5))
    boxes = np.stack([x0, y0, x0 + rng.uniform(.2, .4, (2, 5)),
                      y0 + rng.uniform(.2, .4, (2, 5))], -1).astype(np.float32)
    obj_mask = np.ones((2, 5), np.float32)
    obj_mask[1, 3:] = 0
    args = [jnp.asarray(a) for a in (imgs, boxes, obj_mask)]
    shapes = jax.eval_shape(jd.init, jax.random.PRNGKey(0), *args)
    variables = random_variables(shapes, 5)
    d = AcCropDiscriminator(num_objects, object_size=DC.crop_size,
                            arch=DC.d_obj_arch)
    d.load_state_dict(d_obj_state_dict_from_jax(variables, PDC))
    torch_args = [torch.from_numpy(a) for a in (imgs, boxes, obj_mask)]
    return jd, variables, args, d, torch_args


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_object_discriminator_matches_jax(d_obj_case, train):
    jd, variables, args, d, torch_args = d_obj_case
    d.load_state_dict(d_obj_state_dict_from_jax(variables, PDC))
    if train:
        (scores, logits, crops), mut = jax.jit(
            lambda v, *a: jd.apply(v, *a, train=True,
                                   mutable=["batch_stats"]))(variables, *args)
    else:
        scores, logits, crops = jax.jit(
            lambda v, *a: jd.apply(v, *a, train=False))(variables, *args)
    got = d.train(train)(*torch_args)
    for a, b in zip(got, (scores, logits, crops)):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=TOL, rtol=0)
    assert float(np.abs(np.asarray(logits)).max()) > 1e-3
    if train:
        # The running statistics moved as JAX's did (masked by obj_mask).
        moved = d_obj_state_dict_from_jax(
            {"params": variables["params"],
             "batch_stats": jax.device_get(mut["batch_stats"])}, PDC)
        sd = d.state_dict()
        for k in moved:
            if k.endswith(("running_mean", "running_var")):
                assert not torch.equal(moved[k], torch.from_numpy(
                    np.asarray(variables["batch_stats"]["discriminator"]
                               ["CNN_0"]["MaskedBatchNorm_0"]
                               [k.rsplit("_", 1)[-1]])))
                np.testing.assert_allclose(sd[k].numpy(), moved[k].numpy(),
                                           atol=1e-6, rtol=0, err_msg=k)
