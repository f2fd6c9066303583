"""Port ops against the JAX package's, in float32 on the CPU: sampling
matrices, scene-graph gather/pool and the layout weight field in train
mode and in both test-mode occlusion forms.

Tolerances: the ops are a few f32 products over <= 32 terms, so 1e-5
absolute covers the summation order of two libraries; gathers and the
0/1 claim logic must agree exactly.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from scene_generation_tpu.ops import graph_ops as jgraph
from scene_generation_tpu.ops import layout as jlayout
from scene_generation_tpu.ops import sampling as jsampling
from scene_generation_tpu_torch.ops import graph_ops, layout, sampling

from _torch_port import away_from_half

ATOL = 1e-5


def _boxes(rng, n, o):
    x0 = rng.uniform(-0.1, 0.6, (n, o))
    y0 = rng.uniform(-0.1, 0.6, (n, o))
    return np.stack([x0, y0, x0 + rng.uniform(0.1, 0.6, (n, o)),
                     y0 + rng.uniform(0.1, 0.6, (n, o))],
                    -1).astype(np.float32)


def _layout_case(seed=0, n=2, o=5, d=7, m=8, h=24, w=20):
    rng = np.random.RandomState(seed)
    vecs = rng.randn(n, o, d).astype(np.float32)
    boxes = _boxes(rng, n, o)
    masks = away_from_half(rng, (n, o, m, m))
    obj_mask = np.ones((n, o), np.float32)
    obj_mask[0, -1] = 0.0                 # one padded slot with junk
    vecs[0, -1] = 55.0
    masks[0, -1] = 1.0
    # A tie in mass: object 1 of image 1 copies object 0 exactly.
    vecs[1, 1], boxes[1, 1], masks[1, 1] = vecs[1, 0], boxes[1, 0], masks[1, 0]
    return vecs, boxes, masks, obj_mask, h, w


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def test_interp_matrix_matches_jax():
    coords = np.linspace(-3.0, 12.0, 61).astype(np.float32).reshape(1, 61)
    got = sampling.interp_matrix(torch.from_numpy(coords), 9).numpy()
    want = np.asarray(jsampling.interp_matrix(jnp.asarray(coords), 9))
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_box_sample_matrices_match_jax_incl_degenerate():
    rng = np.random.RandomState(1)
    boxes = _boxes(rng, 2, 4)
    boxes[0, 0] = [0.3, 0.3, 0.3, 0.3]          # zero extent: 1e-6 clamp
    boxes[0, 1] = [1.5, 1.5, 2.0, 2.0]          # fully out of frame
    got = sampling.box_sample_matrices(torch.from_numpy(boxes), 24, 20, 8)
    want = jsampling.box_sample_matrices(jnp.asarray(boxes), 24, 20, 8)
    for g, w in zip(got, want):
        assert np.isfinite(g.numpy()).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)
    assert float(got[0][0, 1].abs().sum()) == 0.0


def test_triple_gather_matches_jax():
    rng = np.random.RandomState(2)
    obj_vecs = rng.randn(3, 6, 5).astype(np.float32)
    edges = rng.randint(0, 6, (3, 8, 2)).astype(np.int32)
    got = graph_ops.triple_gather(*_t(obj_vecs, edges))
    want = jgraph.triple_gather(*_j(obj_vecs, edges))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("pooling", ["avg", "sum"])
def test_segment_pool_objects_matches_jax(pooling):
    rng = np.random.RandomState(3)
    new_s = rng.randn(3, 8, 5).astype(np.float32)
    new_o = rng.randn(3, 8, 5).astype(np.float32)
    edges = rng.randint(0, 4, (3, 8, 2)).astype(np.int32)   # objects 4, 5
    triple_mask = (rng.rand(3, 8) > 0.3).astype(np.float32)  # in no triple
    got = graph_ops.segment_pool_objects(*_t(new_s, new_o, edges,
                                             triple_mask), 6, pooling=pooling)
    want = jgraph.segment_pool_objects(*_j(new_s, new_o, edges, triple_mask),
                                       6, pooling=pooling)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert float(got[:, 4:].abs().max()) == 0.0


@pytest.mark.parametrize("mode", ["train", "matrix", "sort"])
def test_masks_to_layout_weights_match_jax(mode):
    vecs, boxes, masks, obj_mask, h, w = _layout_case()
    test_mode = mode != "train"
    impl = "matrix" if mode == "train" else mode
    got = layout.masks_to_layout_weights(*_t(vecs, boxes, masks, obj_mask),
                                         h, w, test_mode=test_mode,
                                         occlusion_impl=impl).numpy()
    want = np.asarray(jlayout.masks_to_layout_weights(
        *_j(vecs, boxes, masks, obj_mask), h, w, test_mode=test_mode,
        occlusion_impl=impl))
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert float(np.abs(got[0, -1]).max()) == 0.0       # padded slot
    if test_mode:
        # The tie: the lower slot wins every pixel the two share.
        assert (got[1, 0] > 0).any() and not (got[1, 1] > 0).any()


def test_occlusion_forms_agree_exactly():
    vecs, boxes, masks, obj_mask, h, w = _layout_case(seed=4)
    args = _t(vecs, boxes, masks, obj_mask)
    matrix = layout.masks_to_layout_weights(*args, h, w, test_mode=True)
    sort = layout.masks_to_layout_weights(*args, h, w, test_mode=True,
                                          occlusion_impl="sort")
    np.testing.assert_array_equal(matrix.numpy(), sort.numpy())


@pytest.mark.parametrize("test_mode", [False, True])
def test_masks_to_layout_matches_jax(test_mode):
    vecs, boxes, masks, obj_mask, h, w = _layout_case(seed=5)
    got = layout.masks_to_layout(*_t(vecs, boxes, masks, obj_mask), h, w,
                                 test_mode=test_mode).numpy()
    want = np.asarray(jlayout.masks_to_layout(
        *_j(vecs, boxes, masks, obj_mask), h, w, test_mode=test_mode))
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_boxes_to_layout_matches_jax():
    vecs, boxes, _, obj_mask, h, w = _layout_case(seed=6)
    got = layout.boxes_to_layout(*_t(vecs, boxes, obj_mask), h, w).numpy()
    want = np.asarray(jlayout.boxes_to_layout(*_j(vecs, boxes, obj_mask),
                                              h, w))
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_degenerate_and_out_of_frame_boxes_contribute_nothing():
    vecs, boxes, masks, obj_mask, h, w = _layout_case(seed=7)
    boxes[0, 0] = [0.4, 0.4, 0.4, 0.4]
    boxes[0, 1] = [1.2, -0.9, 1.8, -0.3]
    weights = layout.masks_to_layout_weights(
        *_t(vecs, boxes, masks, obj_mask), h, w, test_mode=True).numpy()
    assert np.isfinite(weights).all()
    assert float(np.abs(weights[0, :2]).max()) == 0.0
