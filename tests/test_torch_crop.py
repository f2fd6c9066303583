"""The port's crop op (``ops/crop.py``) against the JAX package's, on the
CPU, where the op runs its plain forward and backward.

The forward is held against JAX ``crop_bbox_batch`` on both of its paths
(XLA, and the Pallas kernel in interpret mode), square and rectangular;
``crop_bwd_plain`` against ``jax.vjp`` of ``crop_pallas`` (the custom VJP
around the TPU backward kernel) for all three cotangents; the
``autograd.Function`` by ``gradcheck`` in f64; and the box gradients
through ``crop_matrices`` against ``jax.grad``. Tolerances: 1e-5 absolute
on f32 values of order 1 (the same products summed in another order).
The backward computes only the gradients asked for (``needs``); and at the
train shapes the hats are banded, the property the card's kernels rely on
for their speed.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from scene_generation_tpu.ops.crop import crop_bbox_batch as jax_crop
from scene_generation_tpu.ops.crop import uncrop_bbox as jax_uncrop
from scene_generation_tpu.ops.images import wire_to_float as jax_wire
from scene_generation_tpu.ops.pallas.crop import crop_pallas
from scene_generation_tpu.ops.sampling import crop_matrices as jax_matrices
from scene_generation_tpu_torch.config import Config
from scene_generation_tpu_torch.data import synthetic_batch
from scene_generation_tpu_torch.ops.crop import (crop, crop_bbox_batch,
                                                 crop_bwd, crop_bwd_plain,
                                                 crop_fwd_plain, uncrop_bbox)
from scene_generation_tpu_torch.ops.images import wire_to_float
from scene_generation_tpu_torch.ops.sampling import (bilinear_sample_gather,
                                                      crop_matrices)


def _case(seed=0, n=2, o=4, h=32, w=24, c=3):
    """Images and boxes, one degenerate and one partly out of frame."""
    rng = np.random.RandomState(seed)
    imgs = rng.uniform(-1, 1, (n, h, w, c)).astype(np.float32)
    x0 = rng.uniform(0, .5, (n, o))
    y0 = rng.uniform(0, .5, (n, o))
    boxes = np.stack([x0, y0, x0 + rng.uniform(.2, .5, (n, o)),
                      y0 + rng.uniform(.2, .5, (n, o))], -1).astype(np.float32)
    boxes[0, 0] = [0.3, 0.3, 0.3, 0.8]
    boxes[0, 1] = [0.7, 0.7, 1.4, 1.4]
    return imgs, boxes


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("hh,ww", [(8, 8), (16, 16), (8, 16)])
def test_forward_matches_jax(backend, hh, ww):
    imgs, boxes = _case()
    want = jax_crop(jnp.asarray(imgs), jnp.asarray(boxes), hh, ww,
                    backend=backend, interpret=True)
    got = crop_bbox_batch(torch.from_numpy(imgs), torch.from_numpy(boxes),
                          hh, ww)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_plain_backward_matches_the_tpu_kernels_vjp():
    imgs, boxes = _case(1)
    ry, rx = jax_matrices(jnp.asarray(boxes), 8, 12, 32, 24)
    u = np.random.RandomState(2).randn(2, 4, 8, 12, 3).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b, c: crop_pallas(True, a, b, c),
                     jnp.asarray(imgs), ry, rx)
    want = vjp(jnp.asarray(u))
    got = crop_bwd_plain(torch.from_numpy(imgs),
                         torch.from_numpy(np.array(ry)),
                         torch.from_numpy(np.array(rx)),
                         torch.from_numpy(u))
    for name, a, b in zip(("d_imgs", "d_ry", "d_rx"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-5,
                                   rtol=1e-5, err_msg=name)


def test_function_gradcheck_f64():
    rng = np.random.RandomState(3)
    imgs = torch.from_numpy(rng.randn(2, 6, 5, 2)).requires_grad_(True)
    ry = torch.from_numpy(rng.rand(2, 3, 4, 6)).requires_grad_(True)
    rx = torch.from_numpy(rng.rand(2, 3, 3, 5)).requires_grad_(True)
    assert torch.autograd.gradcheck(crop, (imgs, ry, rx))
    # The Function's backward is crop_bwd_plain, not autograd of the
    # forward: both agree.
    u = torch.from_numpy(rng.randn(2, 3, 4, 3, 2))
    grads = torch.autograd.grad((crop_fwd_plain(imgs, ry, rx) * u).sum(),
                                (imgs, ry, rx))
    for a, b in zip(grads, crop_bwd_plain(imgs.detach(), ry.detach(),
                                          rx.detach(), u)):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


def test_box_gradients_match_jax():
    imgs, boxes = _case(4)
    target = np.random.RandomState(5).randn(2, 4, 8, 8, 3).astype(np.float32)

    def jax_loss(im, bx):
        return jnp.sum(jax_crop(im, bx, 8, backend="xla") * target)

    want = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(imgs),
                                              jnp.asarray(boxes))
    im = torch.from_numpy(imgs).requires_grad_(True)
    bx = torch.from_numpy(boxes).requires_grad_(True)
    (crop_bbox_batch(im, bx, 8) * torch.from_numpy(target)).sum().backward()
    for name, a, b in (("imgs", im.grad, want[0]), ("boxes", bx.grad,
                                                    want[1])):
        b = np.asarray(b)
        assert np.abs(b).max() > 0
        np.testing.assert_allclose(a.numpy(), b,
                                   atol=1e-5 * max(1.0, np.abs(b).max()),
                                   rtol=1e-4, err_msg=name)


def test_matrix_crop_matches_the_gather_oracle():
    imgs, boxes = _case(6)
    ry, rx = crop_matrices(torch.from_numpy(boxes), 8, 16, 32, 24)
    got = crop_bbox_batch(torch.from_numpy(imgs), torch.from_numpy(boxes),
                          8, 16)
    x0, y0, x1, y1 = (boxes[1, 2, i] for i in range(4))
    px = (x0 + (x1 - x0) * np.linspace(0, 1, 16)) * 23
    py = (y0 + (y1 - y0) * np.linspace(0, 1, 8)) * 31
    gy, gx = np.meshgrid(py, px, indexing="ij")
    want = bilinear_sample_gather(torch.from_numpy(imgs[1]),
                                  torch.from_numpy(gx.astype(np.float32)),
                                  torch.from_numpy(gy.astype(np.float32)))
    np.testing.assert_allclose(got[1, 2].numpy(), want.numpy(), atol=1e-5)
    assert ry.shape == (2, 4, 8, 32) and rx.shape == (2, 4, 16, 24)


def test_uncrop_and_wire_format_match_jax():
    rng = np.random.RandomState(7)
    feats = rng.randn(2, 3, 8, 6, 4).astype(np.float32)
    boxes = _case(8, o=3)[1]
    want = jax_uncrop(jnp.asarray(feats), jnp.asarray(boxes), 16, 12)
    got = uncrop_bbox(torch.from_numpy(feats), torch.from_numpy(boxes), 16,
                      12)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    wire = rng.randint(0, 256, (2, 4, 4, 3)).astype(np.uint8)
    np.testing.assert_allclose(wire_to_float(torch.from_numpy(wire)).numpy(),
                               np.asarray(jax_wire(jnp.asarray(wire))),
                               atol=1e-7)
    flt = torch.rand(2, 3)
    assert wire_to_float(flt) is flt


@pytest.mark.parametrize("hh", [64, 32])
def test_crop_matrices_are_banded_at_the_train_shapes(hh):
    """Every row of the hats holds at most two nonzeros and every column's
    nonzeros are one contiguous run of crop indices, for the synthetic
    batch's boxes and for edge boxes: degenerate, flipped, partly out of
    frame, wholly out of frame, and samples on grid lines."""
    cfg = Config()
    h, w = cfg.model.image_size
    boxes = synthetic_batch(cfg, seed=6, batch_size=12).boxes.copy()
    on_grid = (hh - 1) / (h - 1)
    boxes[0, :6] = [[0.4, 0.4, 0.4, 0.7],           # degenerate in x
                    [0.7, 0.2, 0.3, 0.6],           # flipped in x
                    [-0.2, 0.5, 0.3, 1.3],          # partly out of frame
                    [0.8, -0.3, 1.4, 0.4],
                    [1.2, 1.1, 1.7, 1.9],           # out of frame
                    [0.0, 0.0, on_grid, on_grid]]   # on grid lines
    ry, rx = crop_matrices(torch.from_numpy(boxes), hh, hh, h, w)
    assert ry.shape == (12, cfg.data.max_objs, hh, h)
    for m in (ry, rx):
        nz = m != 0
        assert int(nz.sum(-1).max()) <= 2
        runs = nz[..., :1, :].int() + (nz[..., 1:, :] & ~nz[..., :-1, :]).sum(
            -2, keepdim=True)
        assert int(runs.max()) <= 1
    # The degenerate box's column spans every crop row; the out-of-frame
    # box has none.
    assert int((rx[0, 0] != 0).sum(0).max()) == hh
    assert not bool((ry[0, 4] != 0).any())


@pytest.mark.parametrize("needs", [
    (True, False, False), (False, True, False), (False, False, True),
    (True, True, False), (True, False, True), (False, True, True),
    (False, False, False)])
def test_crop_bwd_returns_only_what_was_asked(needs):
    imgs, boxes = _case(9)
    ry, rx = crop_matrices(torch.from_numpy(boxes), 8, 12, 32, 24)
    u = torch.from_numpy(
        np.random.RandomState(10).randn(2, 4, 8, 12, 3).astype(np.float32))
    imgs = torch.from_numpy(imgs)
    full = crop_bwd(imgs, ry, rx, u)
    got = crop_bwd(imgs, ry, rx, u, needs)
    for name, g, f, need in zip(("d_imgs", "d_ry", "d_rx"), got, full, needs):
        if need:
            assert torch.equal(g, f), name
        else:
            assert g is None, name


@pytest.mark.parametrize("needs", [(True, False, False), (False, True, True),
                                   (True, False, True)])
def test_function_backward_with_partial_needs(needs):
    """``crop``'s backward on inputs of which only some require grad: the
    gradients asked for match ``jax.vjp`` of ``crop_pallas`` (f32) and pass
    ``gradcheck`` (f64)."""
    imgs, boxes = _case(11)
    ry, rx = jax_matrices(jnp.asarray(boxes), 8, 12, 32, 24)
    u = np.random.RandomState(12).randn(2, 4, 8, 12, 3).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b, c: crop_pallas(True, a, b, c),
                     jnp.asarray(imgs), ry, rx)
    want = vjp(jnp.asarray(u))
    ins = [torch.from_numpy(np.array(a)).requires_grad_(need)
           for a, need in zip((imgs, ry, rx), needs)]
    asked = [t for t in ins if t.requires_grad]
    got = torch.autograd.grad((crop(*ins) * torch.from_numpy(u)).sum(), asked)
    for a, b in zip(got, [b for b, need in zip(want, needs) if need]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-5,
                                   rtol=1e-5)

    rng = np.random.RandomState(13)
    ins = [torch.from_numpy(a).requires_grad_(need) for a, need in zip(
        (rng.randn(2, 6, 5, 2), rng.rand(2, 3, 4, 6), rng.rand(2, 3, 3, 5)),
        needs)]
    assert torch.autograd.gradcheck(crop, ins)
