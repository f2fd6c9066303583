"""The port's checkpoint evaluation against the JAX package's, on the CPU:
``metrics.jaccard`` and ``inception_score_from_probs`` (equal), the
test-mode eval step with the same weights (through ``convert``) and the
same mask noise, with and without the GT layout (IoU sums and recalls
within 1e-5, images within the 2e-4 of ``tests/test_torch_serving.py``),
``check_model`` over a loader, and InceptionV3 against the flax model on
two 75x75 images (logits and probabilities within 1e-4).
"""
import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scene_generation_tpu.config import test_config as jax_small_config
from scene_generation_tpu.data import synthetic_batch as jax_synthetic_batch
from scene_generation_tpu.metrics import jaccard as jax_jaccard
from scene_generation_tpu.models.inception import InceptionV3 as JaxInception
from scene_generation_tpu.models.inception import \
    resize_bilinear as jax_resize
from scene_generation_tpu.trainer.evaluation import \
    inception_score_from_probs as jax_inception_score
from scene_generation_tpu.trainer.evaluation import \
    make_eval_step as jax_make_eval_step
from scene_generation_tpu.trainer.train_state import Modules
from scene_generation_tpu_torch.convert import inception_state_dict_from_jax
from scene_generation_tpu_torch.data.loader import DataLoader
from scene_generation_tpu_torch.data.synthetic import SyntheticDataset
from scene_generation_tpu_torch.metrics import jaccard
from scene_generation_tpu_torch.models.inception import (InceptionV3,
                                                         resize_bilinear)
from scene_generation_tpu_torch.ops.layout import _sample_masks
from scene_generation_tpu_torch.trainer.evaluation import (
    check_model, inception_score_from_probs, make_eval_step)

from _torch_port import jax_variables, port_config, port_model

IMG_TOL = 2e-4        # tests/test_torch_serving.py's image tolerance


def _boxes(rng, shape):
    xy = rng.rand(*shape, 2)
    wh = rng.rand(*shape, 2) * 0.6
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def test_jaccard_equals_jax():
    rng = np.random.RandomState(0)
    pred, gt = _boxes(rng, (3, 7)), _boxes(rng, (3, 7))
    pred[0, 0] = gt[0, 0]                     # IoU 1
    pred[0, 1] = [0.2, 0.2, 0.2, 0.5]         # zero area
    gt[0, 1] = [0.2, 0.2, 0.2, 0.5]           # zero union
    mask = (rng.rand(3, 7) > 0.3).astype(np.float32)
    for m in (mask, None):
        got = jaccard(torch.from_numpy(pred), torch.from_numpy(gt),
                      None if m is None else torch.from_numpy(m))
        want = jax_jaccard(jnp.asarray(pred), jnp.asarray(gt),
                           None if m is None else jnp.asarray(m))
        for a, b in zip(got, want):
            np.testing.assert_allclose(float(a), float(b), rtol=1e-6)


@pytest.mark.parametrize("n", [13, 3])
def test_inception_score_equals_jax(n):
    rng = np.random.RandomState(n)
    logits = rng.randn(n, 10) * 2
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    assert inception_score_from_probs(probs) == jax_inception_score(probs)


@pytest.fixture(scope="module")
def models():
    cfg = jax_small_config()
    variables = jax_variables(cfg, seed=3)
    return cfg, variables, port_model(cfg, variables)


@pytest.mark.parametrize("use_gt", [True, False], ids=["val-gt", "val-sg"])
def test_eval_step_matches_jax(models, use_gt):
    cfg, variables, model = models
    batch = jax_synthetic_batch(cfg, seed=4, batch_size=2)
    noise = np.random.RandomState(5).randn(
        cfg.model.mask_noise_dim).astype(np.float32)
    got = make_eval_step(use_gt)(model, batch, torch.from_numpy(noise))
    state = collections.namedtuple("State", "g_params g_stats")(
        variables["params"], variables["batch_stats"])
    want = jax_make_eval_step(Modules(cfg), use_gt)(state, batch,
                                                    jnp.asarray(noise))
    imgs, (iou, r05, r03, nbox) = got[0], got[1:]
    assert float(nbox) == float(want[4]) > 0
    for a, b in zip((iou, r05, r03), want[1:4]):
        np.testing.assert_allclose(float(a), float(b), atol=1e-5)
    assert float(iou) > 0
    np.testing.assert_allclose(imgs.numpy(), np.asarray(want[0]),
                               atol=IMG_TOL, rtol=0)
    if not use_gt:
        # The predicted masks' resampled values stay away from the
        # test-mode claim's 0.5 step, so the images compare arithmetic.
        with torch.no_grad():
            out = model(*[torch.as_tensor(getattr(batch, k)) for k in (
                "objs", "triples")], torch.zeros(2, batch.objs.shape[1],
                                                 cfg.model.num_attributes),
                torch.as_tensor(batch.obj_mask),
                torch.as_tensor(batch.triple_mask), torch.from_numpy(noise),
                imgs=torch.as_tensor(batch.imgs),
                boxes_gt=torch.as_tensor(batch.boxes))
        s = _sample_masks(out.boxes_pred, out.masks_pred,
                          *cfg.model.image_size)
        valid = torch.as_tensor(batch.obj_mask).bool()
        assert float((s[valid] - 0.5).abs().min()) > 1e-5


def test_check_model_sweeps_a_loader(models):
    """``check_model`` over the val loader: the sums of the eval steps'
    IoUs over all GT boxes; the mask noise comes from its own generator,
    so two sweeps agree."""
    cfg, _, model = models
    pcfg = port_config(cfg)
    loader = DataLoader(SyntheticDataset(pcfg, 6, seed=1), 2,
                        pcfg.data.max_objs, pcfg.data.max_triples,
                        shuffle=False)
    probs = lambda imgs: torch.softmax(imgs.flatten(1)[:, :10], -1)  # noqa
    first = check_model(model, loader, use_gt=True, num_samples=4,
                        probs_fn=probs)
    again = check_model(model, loader, use_gt=True, num_samples=4,
                        probs_fn=probs)
    assert first == again
    iou, imean, istd, r05, r03 = first
    assert 0 < iou <= 1 and 0 <= r05 <= r03 <= 1 and imean >= 1.0
    assert model.training is False


def _flax_inception_variables(rng):
    """numpy values at the flax InceptionV3's shapes: He-scaled kernels,
    batch norms near the identity, a wider final layer so the logits
    spread over several units."""
    shapes = jax.eval_shape(
        lambda k, x: JaxInception().init(k, x, train=False),
        jax.random.PRNGKey(0), jnp.zeros((1, 299, 299, 3)))

    def fill(tree, path):
        out = {}
        for k, v in sorted(tree.items()):
            if isinstance(v, dict):
                out[k] = fill(v, path + (k,))
                continue
            s = v.shape
            if k == "kernel":
                a = rng.randn(*s) * np.sqrt(2.0 / np.prod(s[:-1]))
                a *= 8 if path[-1] == "fc" else 1
            elif k == "scale":
                a = 1 + 0.1 * rng.randn(*s)
            elif k == "var":
                a = 1 + 0.1 * rng.rand(*s)
            else:
                a = 0.1 * rng.randn(*s)
            out[k] = a.astype(np.float32)
        return out

    return {c: fill(shapes[c], (c,)) for c in sorted(shapes)}


def test_inception_v3_matches_flax():
    rng = np.random.RandomState(0)
    variables = _flax_inception_variables(rng)
    x = rng.uniform(-1, 1, (2, 75, 75, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, x: JaxInception().apply(
        v, jax_resize(x), train=False))(variables, x))
    model = InceptionV3()
    model.load_state_dict(inception_state_dict_from_jax(variables))
    with torch.no_grad():
        got = model.eval()(resize_bilinear(torch.from_numpy(x))).numpy()
    assert want.std() > 1.0
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    p_got = torch.softmax(torch.from_numpy(got), -1).numpy()
    p_want = np.asarray(jax.nn.softmax(want, -1))
    assert p_want.max() > 0.01
    np.testing.assert_allclose(p_got, p_want, atol=1e-4, rtol=0)
