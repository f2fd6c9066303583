"""The port's test-mode compositor against the JAX package's.

On the CPU ``composite_layout`` runs the prep and the compositor's plain
version (the TPU kernel's object loop); it is held against
``masks_to_layout(backend="pallas", interpret=True)`` and against the XLA
test path, on the inputs tests/test_pallas_compositor.py uses. The CUDA
kernel is held against the plain version on the card by
tests/test_torch_kernels_cuda.py.

Tolerance 2e-4 absolute, as tests/test_pallas_compositor.py: the layouts
are sums of up to O f32 products of resampled masks and vectors.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from scene_generation_tpu.ops.layout import masks_to_layout as jax_layout
from scene_generation_tpu_torch.ops import _cuda
from scene_generation_tpu_torch.ops.compositor import (composite,
                                                       composite_plain)
from scene_generation_tpu_torch.ops.layout import (composite_layout,
                                                   compositor_inputs)


def _case(seed=0, n=2, o=4, d=8, m=8, h=32, w=32):
    rng = np.random.RandomState(seed)
    vecs = rng.rand(n, o, d).astype(np.float32)
    x0 = rng.uniform(0, .5, (n, o))
    y0 = rng.uniform(0, .5, (n, o))
    boxes = np.stack([x0, y0, x0 + rng.uniform(.2, .5, (n, o)),
                      y0 + rng.uniform(.2, .5, (n, o))], -1).astype(np.float32)
    masks = (rng.rand(n, o, m, m) > 0.35).astype(np.float32)
    obj_mask = np.ones((n, o), np.float32)
    obj_mask[0, -1] = 0  # one padded slot with junk
    vecs[0, -1] = 55.0
    masks[0, -1] = 1.0
    return vecs, boxes, masks, obj_mask, h, w


def _port(vecs, boxes, masks, obj_mask, h, w):
    return composite_layout(*[torch.from_numpy(a) for a in
                              (vecs, boxes, masks, obj_mask)], h, w).numpy()


def _jax(vecs, boxes, masks, obj_mask, h, w, **kw):
    return np.asarray(jax_layout(*[jnp.asarray(a) for a in
                                   (vecs, boxes, masks, obj_mask)], h, w,
                                 test_mode=True, **kw))


@pytest.mark.parametrize("reference", ["pallas_interpret", "xla"])
def test_matches_jax(reference):
    case = _case()
    kw = (dict(backend="pallas", interpret=True)
          if reference == "pallas_interpret" else {})
    np.testing.assert_allclose(_port(*case), _jax(*case, **kw), atol=2e-4,
                               rtol=1e-4)


def test_uneven_height_matches_jax():
    vecs, boxes, masks, obj_mask, _, _ = _case(seed=1)
    case = (vecs, boxes, masks, obj_mask, 24, 20)
    np.testing.assert_allclose(_port(*case), _jax(*case), atol=2e-4,
                               rtol=1e-4)


def test_half_threshold_masks_claim_in_f32():
    """Masks of 0.5 + 2^-12 (which bf16 rounds to exactly 0.5) must claim
    pixels in f32; rounded to bf16 first, nothing is claimed."""
    n, o, d, m, h, w = 1, 2, 4, 8, 32, 32
    vecs = torch.ones((n, o, d))
    boxes = torch.tensor([0.1, 0.1, 0.9, 0.9]).repeat(n, o, 1)
    val = np.float32(0.5 + 2.0 ** -12)
    assert torch.tensor(val).bfloat16().float() == 0.5   # premise
    masks = torch.full((n, o, m, m), float(val))
    obj_mask = torch.ones((n, o))
    exact = composite_layout(vecs, boxes, masks, obj_mask, h, w)
    assert float(exact.abs().sum()) > 0.0
    rounded = masks.bfloat16().float()
    zeroed = composite_layout(vecs, boxes, rounded, obj_mask, h, w)
    assert float(zeroed.abs().sum()) == 0.0


def test_degenerate_and_out_of_frame_boxes_stay_finite_and_zero():
    vecs, boxes, masks, obj_mask, h, w = _case(seed=2)
    boxes[1, 0] = [0.3, 0.3, 0.3, 0.3]
    boxes[1, 1] = [-0.9, 1.2, -0.2, 1.9]
    keep = np.ones_like(obj_mask)
    keep[1, :2] = 0
    full = _port(vecs, boxes, masks, obj_mask, h, w)
    assert np.isfinite(full).all()
    np.testing.assert_allclose(full[1], _port(vecs, boxes, masks,
                                              obj_mask * keep, h, w)[1],
                               atol=1e-6)


def test_cpu_wrapper_runs_the_plain_version_without_a_launch():
    vecs, boxes, masks, obj_mask, h, w = _case(seed=3)
    inputs = compositor_inputs(*[torch.from_numpy(a) for a in
                                 (vecs, boxes, masks, obj_mask)], h, w)
    before = _cuda.LAUNCHES["compositor"]
    assert torch.equal(composite(*inputs), composite_plain(*inputs))
    assert _cuda.LAUNCHES["compositor"] == before
