"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU. This
file imports no JAX, so it runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

(``--noconftest``: the suite's conftest.py configures JAX.)
"""
import numpy as np
import pytest
import torch

from scene_generation_tpu_torch.models.layers import avg_pool_3x3_s2
from scene_generation_tpu_torch.ops import _cuda
from scene_generation_tpu_torch.ops.compositor import (composite,
                                                       composite_plain)
from scene_generation_tpu_torch.ops.crop import (crop, crop_bwd,
                                                 crop_bwd_plain, crop_fwd,
                                                 crop_fwd_plain)
from scene_generation_tpu_torch.ops.layout import compositor_inputs
from scene_generation_tpu_torch.ops.sampling import crop_matrices
from scene_generation_tpu_torch.ops.stem import stem, stem_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    """The card, with TF32 off for the plain versions' f32 products (and
    the previous flags restored after the test)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's kernels run only on the "
                    "card")
    flags = (torch.backends.cuda.matmul, torch.backends.cudnn)
    prev = [f.allow_tf32 for f in flags]
    for f in flags:
        f.allow_tf32 = False
    yield torch.device("cuda")
    for f, p in zip(flags, prev):
        f.allow_tf32 = p


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("o,c,h", [(9, 64, 128), (5, 8, 64), (4, 4, 32),
                                   (3, 6, 20), (2, 16, 150)])
def test_stem_kernel_matches_plain(device, dtype, o, c, h):
    rng = np.random.RandomState(0)
    w_t = torch.from_numpy(rng.rand(3, h + 6, h + 6, o).astype(
        np.float32)).to(device, dtype)
    g_t = torch.from_numpy(rng.randn(3, 7, 7, o, c).astype(
        np.float32)).to(device, dtype)
    before = _cuda.LAUNCHES["stem"]
    got = stem(w_t, g_t).float()
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["stem"] == before + 1
    want = stem_plain(w_t.float(), g_t.float())
    # f32: sums of 49*O products in another order; bf16: the output's
    # rounding (2^-8 relative) on top.
    tol = 1e-3 if dtype == torch.float32 else 2 ** -7 * float(
        want.abs().max())
    assert float((got - want).abs().max()) <= tol


def _compositor_case(device, dtype, n, o, d, m, h, w):
    rng = np.random.RandomState(1)
    vecs = rng.rand(n, o, d).astype(np.float32)
    x0 = rng.uniform(0, .6, (n, o))
    y0 = rng.uniform(0, .6, (n, o))
    boxes = np.stack([x0, y0, x0 + rng.uniform(.1, .5, (n, o)),
                      y0 + rng.uniform(.1, .5, (n, o))], -1).astype(np.float32)
    boxes[0, 0] = [0.3, 0.3, 0.3, 0.3]           # degenerate
    boxes[0, 1] = [1.2, 1.2, 1.8, 1.9]           # out of frame
    masks = 1 / (1 + np.exp(-3 * rng.randn(n, o, m, m)))
    obj_mask = np.ones((n, o), np.float32)
    obj_mask[1, -2:] = 0
    return compositor_inputs(
        torch.from_numpy(vecs).to(device, dtype),
        torch.from_numpy(boxes).to(device, dtype),
        torch.from_numpy(masks.astype(np.float32)).to(device, dtype),
        torch.from_numpy(obj_mask).to(device), h, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,o,d,m,h,w", [(4, 9, 204, 32, 128, 128),
                                         (3, 4, 7, 8, 36, 150)])
def test_compositor_kernel_matches_plain(device, dtype, n, o, d, m, h, w):
    inputs = _compositor_case(device, dtype, n, o, d, m, h, w)
    before = _cuda.LAUNCHES["compositor"]
    got = composite(*inputs).float()
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["compositor"] == before + 1
    want = composite_plain(*inputs).float()
    assert torch.isfinite(got).all()
    diff = (got - want).abs().amax(-1)
    # A claim flips only where a resampled value lies within rounding of
    # 0.5 (the sums run in another order); such a pixel differs by a whole
    # vector. Every other pixel differs by rounding of the output dtype.
    tol = 1e-4 if dtype == torch.float32 else 2 ** -8 * 2
    assert int((diff > tol).sum()) <= 8


def test_compositor_kernel_claims_half_threshold_in_f32(device):
    n, o, d, m, h, w = 1, 2, 4, 8, 32, 32
    val = 0.5 + 2.0 ** -12
    inputs = compositor_inputs(
        torch.ones((n, o, d), device=device),
        torch.tensor([0.1, 0.1, 0.9, 0.9], device=device).repeat(n, o, 1),
        torch.full((n, o, m, m), val, device=device),
        torch.ones((n, o), device=device), h, w)
    assert float(composite(*inputs).abs().sum()) > 0.0


def test_kernels_refuse_what_they_do_not_take(device):
    w_t = torch.rand(1, 14, 14, 3, device=device)
    g_t = torch.rand(1, 7, 7, 3, 4, device=device)
    with pytest.raises(TypeError):
        stem(w_t.half(), g_t.half())
    with pytest.raises(ValueError):
        stem(w_t.transpose(1, 2), g_t)
    with pytest.raises(ValueError):
        stem(w_t, g_t[:, :6])
    # Tiles beyond a block's shared memory: the launch is refused and
    # raised, and the next launch runs clean.
    with pytest.raises(RuntimeError, match="stem kernel"):
        stem(torch.rand(1, 518, 518, 40, device=device),
             torch.rand(1, 7, 7, 40, 4, device=device))
    got = stem(w_t, g_t)
    torch.cuda.synchronize()
    assert float((got - stem_plain(w_t, g_t)).abs().max()) <= 1e-4


def test_forward_only_kernels_refuse_inputs_that_require_grad(device):
    w_t = torch.rand(1, 14, 14, 3, device=device, requires_grad=True)
    g_t = torch.rand(1, 7, 7, 3, 4, device=device)
    with pytest.raises(RuntimeError, match="forward-only"):
        stem(w_t, g_t)
    with torch.no_grad():
        stem(w_t, g_t)
    inputs = compositor_inputs(
        torch.ones((1, 2, 4), device=device, requires_grad=True),
        torch.tensor([0.1, 0.1, 0.9, 0.9], device=device).repeat(1, 2, 1),
        torch.full((1, 2, 8, 8), 0.7, device=device),
        torch.ones((1, 2), device=device), 32, 32)
    with pytest.raises(RuntimeError, match="forward-only"):
        composite(*inputs)


def _crop_case(device, dtype, n, h, w, c, o, hh, ww, seed=0):
    """Random images and boxes, some partly out of frame, one degenerate;
    the gradient u is random too."""
    rng = np.random.RandomState(seed)
    imgs = rng.uniform(-1, 1, (n, h, w, c)).astype(np.float32)
    x0 = rng.uniform(-0.2, 0.8, (n, o))
    y0 = rng.uniform(-0.2, 0.8, (n, o))
    boxes = np.stack([x0, y0, x0 + rng.uniform(0.05, 0.6, (n, o)),
                      y0 + rng.uniform(0.05, 0.6, (n, o))], -1)
    boxes[0, 0] = [0.4, 0.4, 0.4, 0.7]
    boxes = torch.from_numpy(boxes.astype(np.float32)).to(device, dtype)
    ry, rx = crop_matrices(boxes, hh, ww, h, w)
    u = torch.from_numpy(rng.randn(n, o, hh, ww, c).astype(np.float32))
    return (torch.from_numpy(imgs).to(device, dtype), ry.contiguous(),
            rx.contiguous(), u.to(device, dtype))


CROP_SHAPES = [(12, 128, 128, 3, 9, 64, 64), (12, 128, 128, 3, 9, 32, 32),
               (2, 32, 48, 3, 4, 8, 16), (3, 20, 17, 5, 3, 19, 7)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", CROP_SHAPES)
def test_crop_kernels_match_plain(device, dtype, shape):
    imgs, ry, rx, u = _crop_case(device, dtype, *shape)
    before = dict(_cuda.LAUNCHES)
    got = crop_fwd(imgs, ry, rx)
    grads = crop_bwd(imgs, ry, rx, u)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["crop_fwd"] == before.get("crop_fwd", 0) + 1
    assert _cuda.LAUNCHES["crop_bwd"] == before.get("crop_bwd", 0) + 1
    want = crop_fwd_plain(imgs, ry, rx)
    want_grads = crop_bwd_plain(imgs, ry, rx, u)
    # f32: the same products summed in another order; bf16: both round one
    # f32 sum to bf16.
    for a, b in zip((got, *grads), (want, *want_grads)):
        a, b = a.float(), b.float()
        scale = float(b.abs().max())
        tol = 1e-5 * max(scale, 1.0) if dtype == torch.float32 else \
            2 ** -7 * scale
        assert torch.isfinite(a).all()
        assert float((a - b).abs().max()) <= tol
    again = crop_bwd(imgs, ry, rx, u)
    for a, b in zip(grads, again):
        assert torch.equal(a, b)        # no atomics: bitwise repeatable


def test_crop_function_backward_is_the_kernel(device):
    imgs, ry, rx, u = _crop_case(device, torch.float32, 2, 32, 32, 3, 4, 8, 8)
    imgs.requires_grad_(True)
    before = _cuda.LAUNCHES["crop_bwd"]
    (crop(imgs, ry, rx) * u).sum().backward()
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["crop_bwd"] == before + 1
    want = crop_bwd_plain(imgs.detach(), ry, rx, u)[0]
    assert float((imgs.grad - want).abs().max()) <= 1e-5


def test_discriminator_pool_gradient_matches_the_cpu(device):
    """The multiscale discriminators pool an NHWC input seen as NCHW
    (channels-last); its gradient on the card must be the CPU's."""
    x0 = torch.randn(2, 37, 36, 11)
    grads = []
    for dev in (device, torch.device("cpu")):
        x = x0.to(dev).requires_grad_(True)
        y = avg_pool_3x3_s2(x.permute(0, 3, 1, 2))
        gy = torch.linspace(-1, 1, y.numel(), device=dev).reshape(y.shape)
        grads.append(torch.autograd.grad((y * gy).sum(), x)[0].cpu())
    assert float((grads[0] - grads[1]).abs().max()) <= 1e-6
