"""The port's losses (``losses.py``) and VGG features (``models/vgg.py``)
against the JAX package's, on the same numpy inputs on the CPU, in f32.

Every loss of the module, masked and unmasked; the feature-matching and
perceptual losses also for their gradients (the real / target features
must get none). Tolerances: 1e-6 relative on the losses (f32 reductions
in another order), 1e-5 absolute on VGG features of order 1.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from scene_generation_tpu import losses as JL
from scene_generation_tpu.models.vgg import Vgg19Features as JaxVgg
from scene_generation_tpu_torch import losses as L
from scene_generation_tpu_torch.convert import vgg_state_dict_from_jax
from scene_generation_tpu_torch.models.vgg import (Vgg19Features,
                                                   load_torch_vgg19)

from _torch_port import random_variables

RNG = np.random.RandomState(0)
SCORES_R = RNG.randn(3, 5).astype(np.float32) * 3
SCORES_F = RNG.randn(3, 5).astype(np.float32) * 3
W = (RNG.rand(3, 5) > 0.3).astype(np.float32)


def _close(got, want, rtol=1e-6):
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=rtol,
                               atol=1e-7)


def _pyramid(rng, scales=2, stages=3, n=4):
    return [[rng.randn(n, 6 // (j + 1), 5, 2).astype(np.float32)
             for j in range(stages)] for _ in range(scales)]


@pytest.mark.parametrize("gan_type", ["gan", "wgan", "lsgan"])
@pytest.mark.parametrize("masked", [False, True])
def test_gan_loss_pairs_match_jax(gan_type, masked):
    g, d = L.get_gan_losses(gan_type)
    jg, jd = JL.get_gan_losses(gan_type)
    w = W if masked else None
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    _close(g(t(SCORES_F), t(w)), jg(j(SCORES_F), j(w)))
    _close(d(t(SCORES_R), t(SCORES_F), t(w)),
           jd(j(SCORES_R), j(SCORES_F), j(w)))
    with pytest.raises(ValueError):
        L.get_gan_losses("hinge")


@pytest.mark.parametrize("use_lsgan", [True, False])
@pytest.mark.parametrize("real", [True, False])
def test_multiscale_gan_loss_matches_jax(use_lsgan, real):
    rng = np.random.RandomState(1)
    pred = _pyramid(rng)
    if not use_lsgan:
        pred = [[1 / (1 + np.exp(-p)) for p in s] for s in pred]
    w = (rng.rand(4) > 0.5).astype(np.float32)
    for wt in (None, w):
        got = L.multiscale_gan_loss(
            [[torch.from_numpy(p) for p in s] for s in pred], real,
            use_lsgan, None if wt is None else torch.from_numpy(wt))
        want = JL.multiscale_gan_loss(
            [[jnp.asarray(p) for p in s] for s in pred], real, use_lsgan,
            None if wt is None else jnp.asarray(wt))
        _close(got, want)


def test_feature_matching_loss_and_its_gradient_match_jax():
    rng = np.random.RandomState(2)
    fake, real = _pyramid(rng), _pyramid(rng)
    w = (rng.rand(4) > 0.5).astype(np.float32)

    def jax_loss(f, r):
        return JL.feature_matching_loss(f, r, jnp.asarray(w))

    want, (gf, gr) = jax.value_and_grad(jax_loss, argnums=(0, 1))(
        [[jnp.asarray(p) for p in s] for s in fake],
        [[jnp.asarray(p) for p in s] for s in real])
    tf = [[torch.from_numpy(p).requires_grad_(True) for p in s] for s in fake]
    tr = [[torch.from_numpy(p).requires_grad_(True) for p in s] for s in real]
    got = L.feature_matching_loss(tf, tr, torch.from_numpy(w))
    _close(got, want)
    got.backward()
    for s in range(2):
        for k in range(2):       # stages but the score map
            np.testing.assert_allclose(tf[s][k].grad.numpy(),
                                       np.asarray(gf[s][k]), atol=1e-7)
            assert tr[s][k].grad is None
            assert not np.asarray(gr[s][k]).any()


def test_classification_and_regression_losses_match_jax():
    rng = np.random.RandomState(3)
    logits = rng.randn(3, 5, 7).astype(np.float32) * 2
    labels = rng.randint(0, 7, (3, 5)).astype(np.int32)
    a, b = rng.randn(3, 5, 4).astype(np.float32), rng.randn(3, 5, 4).astype(
        np.float32)
    for w in (None, W):
        tw = None if w is None else torch.from_numpy(w)
        jw = None if w is None else jnp.asarray(w)
        _close(L.masked_cross_entropy(torch.from_numpy(logits),
                                      torch.from_numpy(labels), tw),
               JL.masked_cross_entropy(jnp.asarray(logits),
                                       jnp.asarray(labels), jw))
        for fn, jfn in ((L.mse_loss, JL.mse_loss), (L.l1_loss, JL.l1_loss),
                        (L.bce_loss, JL.bce_loss)):
            _close(fn(torch.from_numpy(a), torch.from_numpy(b), tw),
                   jfn(jnp.asarray(a), jnp.asarray(b), jw))
    # The masked mean's denominator is clamped at 1: all-zero weights give 0.
    zero = torch.zeros(3, 5)
    assert float(L.mse_loss(torch.from_numpy(a), torch.from_numpy(b),
                            zero)) == 0.0


@pytest.fixture(scope="module")
def vgg_pair():
    x = np.random.RandomState(4).uniform(-1, 1, (2, 32, 32, 3)).astype(
        np.float32)
    jv = JaxVgg()
    params = random_variables(
        jax.eval_shape(jv.init, jax.random.PRNGKey(0), jnp.asarray(x)),
        5)["params"]
    vgg = Vgg19Features()
    vgg.load_state_dict(vgg_state_dict_from_jax(params))
    return x, jv, params, vgg


def test_vgg_features_match_jax(vgg_pair):
    x, jv, params, vgg = vgg_pair
    want = jax.jit(jv.apply)({"params": params}, jnp.asarray(x))
    got = vgg(torch.from_numpy(x))
    assert len(got) == len(want) == 5
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.detach().permute(0, 2, 3, 1).numpy(),
                                   np.asarray(b), atol=1e-5, rtol=1e-5)


def test_vgg_perceptual_loss_matches_jax(vgg_pair):
    x, jv, params, vgg = vgg_pair
    y = np.random.RandomState(6).uniform(-1, 1, x.shape).astype(np.float32)

    def jax_loss(a):
        return JL.vgg_perceptual_loss(jv.apply({"params": params}, a),
                                      jv.apply({"params": params},
                                               jnp.asarray(y)))

    want, wgrad = jax.jit(jax.value_and_grad(jax_loss))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = L.vgg_perceptual_loss(vgg(xt), vgg(torch.from_numpy(y)))
    _close(got, want, rtol=1e-5)
    got.backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(wgrad),
                               atol=1e-5 * float(np.abs(wgrad).max()))


def test_vgg_loads_a_torchvision_state_dict(tmp_path):
    vgg = Vgg19Features()
    sd = {}
    for i, (name, conv) in zip((0, 2, 5, 7, 10, 12, 14, 16, 19, 21, 23, 25,
                                28), vgg.convs.items()):
        sd[f"features.{i}.weight"] = torch.full_like(conv.weight, 0.5)
        sd[f"features.{i}.bias"] = torch.full_like(conv.bias, 0.25)
    path = tmp_path / "vgg19-test.pth"
    torch.save(sd, path)
    assert load_torch_vgg19(vgg, str(path))
    assert float(vgg.convs["conv3_2"].weight.detach().mean()) == 0.5
    assert float(vgg.convs["conv5_1"].bias.detach().mean()) == 0.25
