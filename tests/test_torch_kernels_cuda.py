"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU. This
file imports no JAX, so it runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

(``--noconftest``: the suite's conftest.py configures JAX.)
"""
import ctypes
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from scene_generation_tpu_torch.models.layers import avg_pool_3x3_s2
from scene_generation_tpu_torch.ops import _cuda
from scene_generation_tpu_torch.ops.compositor import (composite,
                                                       composite_plain)
from scene_generation_tpu_torch.ops.crop import (crop, crop_bbox_batch,
                                                 crop_bwd, crop_bwd_plain,
                                                 crop_fwd, crop_fwd_plain)
from scene_generation_tpu_torch.ops.layout import compositor_inputs
from scene_generation_tpu_torch.ops.sampling import crop_matrices
from scene_generation_tpu_torch.ops.stem import (f32_launch_config, stem,
                                                 stem_plain, tc_launch_config)

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
    before = dict(_cuda.LAUNCHES)
    got = stem(w_t, g_t).float()
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["stem"] == before.get("stem", 0) + 1
    # bf16 runs the bf16 tensor-core kernel, f32 the 3xTF32 one.
    assert _cuda.LAUNCHES["stem_tc"] == before.get("stem_tc", 0) + (
        dtype == torch.bfloat16)
    assert _cuda.LAUNCHES["stem_f32"] == before.get("stem_f32", 0) + (
        dtype == torch.float32)
    want = stem_plain(w_t.float(), g_t.float())
    # f32: sums of 49*O products in another order; bf16: the output's
    # rounding (2^-8 relative) on top.
    tol = 1e-3 if dtype == torch.float32 else 2 ** -7 * float(
        want.abs().max())
    assert float((got - want).abs().max()) <= tol


# The serving shape, and a width that is not a multiple of a warp's 64
# pixels (nor of an m-tile's 16) with channels that fill no whole pass.
@pytest.mark.parametrize("n,h,w,o,c", [(16, 128, 128, 9, 64),
                                       (2, 20, 77, 9, 40)])
def test_stem_f32_kernel_matches_plain_and_repeats(device, n, h, w, o, c):
    """The 3xTF32 kernel within phase 3's 1e-4 of the plain f32 version
    (weights in [0, 1] as claimed masks are, taps N(0, 0.1^2): outputs of
    order 1), and bitwise equal to itself."""
    rng = np.random.RandomState(3)
    w_t = torch.from_numpy(rng.rand(n, h + 6, w + 6, o).astype(
        np.float32)).to(device)
    g_t = torch.from_numpy(0.1 * rng.randn(n, 7, 7, o, c).astype(
        np.float32)).to(device)
    before = _cuda.LAUNCHES["stem_f32"]
    got = stem(w_t, g_t)
    again = stem(w_t, g_t)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["stem_f32"] == before + 2
    assert torch.equal(got, again)
    want = stem_plain(w_t, g_t)
    assert float((got - want).abs().max()) <= 1e-4


def _f32_stem_case(device, n, h, w, o, c, seed=0):
    """A field in [0, 1] (claimed mask weights) and taps N(0, 0.1^2):
    outputs of order 1, held to phase 3's 1e-4."""
    rng = np.random.RandomState(seed)
    w_t = torch.from_numpy(rng.rand(n, h + 6, w + 6, o).astype(np.float32))
    g_t = torch.from_numpy(0.1 * rng.randn(n, 7, 7, o, c).astype(np.float32))
    return w_t.to(device), g_t.to(device)


def _assert_f32_stem_matches_plain(w_t, g_t, got, tol=1e-4):
    want = stem_plain(w_t, g_t)
    assert got.shape == want.shape
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= tol


# (N, H, W, O, C) at the edges of the f32 kernel's tiles: W of 63, 65 (a
# last band of one pixel) and 129, W != H; C of 9 (odd), 40, 72 (a second
# channel tile of 8) and 6 (16 tap rows staged); O = 1 (7 of 8 k), O = 10
# (72 k: tap rows of an odd number of chunks), O = 18 with 4 channels (126
# k, 16 tap rows) and O = 11 at 64 channels (bands of 32 pixels, since 64
# do not fit: 32, 32 and 6 of W = 70); 16 images of 8 rows
# and 150 small images (more bands than SMs: blocks walk several).
STEM_F32_SHAPES = [(2, 20, 120, 9, 64), (1, 33, 65, 9, 64),
                   (2, 12, 63, 9, 40), (1, 12, 129, 9, 72),
                   (1, 21, 130, 5, 9), (2, 20, 96, 1, 6),
                   (2, 9, 17, 10, 24), (1, 12, 40, 18, 4),
                   (1, 12, 70, 11, 64), (16, 8, 16, 9, 64),
                   (150, 12, 20, 9, 64)]


@pytest.mark.parametrize("shape", STEM_F32_SHAPES)
def test_stem_f32_kernel_matches_plain_on_ragged_edges(device, shape):
    w_t, g_t = _f32_stem_case(device, *shape)
    before = _cuda.LAUNCHES["stem_f32"]
    got = stem(w_t, g_t)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["stem_f32"] == before + 1
    _assert_f32_stem_matches_plain(w_t, g_t, got)


def test_stem_f32_kernel_bands_with_a_last_band_of_one_row(device):
    """16 images of 22 rows: bands of 3 rows, the last of 1 (on a card of
    132 SMs; the test reads the launch's band rows)."""
    n, h, w, o, c = 16, 22, 40, 9, 64
    config = f32_launch_config(n, h, w, o, c)
    w_t, g_t = _f32_stem_case(device, n, h, w, o, c, seed=3)
    got = stem(w_t, g_t)
    torch.cuda.synchronize()
    if torch.cuda.get_device_properties(0).multi_processor_count == 132:
        assert h % config["band_rows"] == 1
    _assert_f32_stem_matches_plain(w_t, g_t, got)


@pytest.mark.parametrize("offset", [1, 3])
def test_stem_f32_kernel_takes_inputs_at_any_element_offset(device, offset):
    """Contiguous views that start off a 16-byte boundary give the aligned
    inputs' output bit for bit."""
    w_t, g_t = _f32_stem_case(device, 2, 20, 33, 9, 16)
    views = []
    for t in (w_t, g_t):
        flat = torch.zeros(t.numel() + offset, dtype=t.dtype, device=device)
        flat[offset:] = t.reshape(-1)
        views.append(flat[offset:].view(t.shape))
    assert views[0].data_ptr() % 16 != 0 and views[0].is_contiguous()
    got = stem(*views)
    torch.cuda.synchronize()
    assert torch.equal(got, stem(w_t, g_t))
    _assert_f32_stem_matches_plain(w_t, g_t, got)


@pytest.mark.parametrize("x0", [0, 6, 37, 63, 64, 69])
def test_stem_f32_kernel_sends_each_dx_to_its_own_column(device, x0):
    """A field that is zero but at padded column x0: output column x0 - dx
    holds the dx taps alone, so a packed row read at a wrong pixel offset
    (or a band's halo read wrong) shows as a wrong or empty column."""
    n, h, w, o, c = 2, 10, 100, 9, 64
    rng = np.random.RandomState(4)
    field = np.zeros((n, h + 6, w + 6, o), np.float32)
    field[:, :, x0] = rng.uniform(0.5, 1.0, (n, h + 6, o))
    taps = rng.uniform(-1, 1, (n, 7, 7, o, c)).astype(np.float32)
    w_t = torch.from_numpy(field).to(device)
    g_t = torch.from_numpy(taps).to(device)
    got = stem(w_t, g_t)
    torch.cuda.synchronize()
    want = stem_plain(w_t, g_t)
    _assert_f32_stem_matches_plain(w_t, g_t, got)
    lit = [x0 - dx for dx in range(7) if 0 <= x0 - dx < w]
    assert bool((want[:, :, lit].abs().amax(dim=(0, 1, 3)) > 0).all())
    assert bool((got[:, :, lit].abs().amax(dim=(0, 1, 3)) > 0).all())
    dark = [x for x in range(w) if x not in lit]
    assert float(got[:, :, dark].abs().max()) == 0.0


def _tf32_truncated(x: np.ndarray) -> np.ndarray:
    return (x.astype(np.float32).view(np.uint32)
            & np.uint32(0xffffe000)).view(np.float32)


def test_wgmma_tf32_reads_the_high_19_bits_of_each_operand(device,
                                                           tmp_path):
    """What the f32 stem kernel builds on, asked of the card: a tf32
    warpgroup product (A from registers, B from shared memory in the
    kernel's non-swizzled K-major layout, the k stride in the descriptor's
    leading offset) reads each operand truncated to tf32, its 13 low
    mantissa bits ignored, neither rounded nor read whole. So a raw f32
    value is its own high part and x - trunc(x) the low one. One product a
    sum (diagonal operands) gives the products exactly; then full ones."""
    src = Path(__file__).resolve().parent / "csrc" / "wgmma_tf32_probe.cu"
    lib_path = tmp_path / "probe.so"
    subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", str(lib_path),
                    str(src)], check=True, capture_output=True)
    probe = ctypes.CDLL(str(lib_path)).wgmma_tf32_probe
    probe.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int]
    probe.restype = ctypes.c_int
    rng = np.random.RandomState(7)
    diagonal = np.arange(8)[None] == (np.arange(64) % 8)[:, None]
    for dense in (False, True):
        a = rng.uniform(1, 2, (64, 8)).astype(np.float32)
        b = rng.uniform(-2, 2, (64, 8)).astype(np.float32)
        if not dense:
            a, b = a * diagonal, b * diagonal
        a_t, b_t = torch.from_numpy(a).to(device), torch.from_numpy(b).to(device)
        d = torch.zeros(64, 64, device=device)
        assert probe(a_t.data_ptr(), b_t.data_ptr(), d.data_ptr(), 1) == 0
        got = d.cpu().double().numpy()
        truncated = (_tf32_truncated(a).astype(np.float64)
                     @ _tf32_truncated(b).astype(np.float64).T)
        whole = a.astype(np.float64) @ b.astype(np.float64).T
        if dense:      # eight products summed in f32 on the card
            assert np.abs(got - truncated).max() <= 2e-6 * np.abs(
                truncated).max()
        else:
            assert np.array_equal(got, truncated)
        assert np.abs(got - whole).max() > 1e-4


def test_stem_f32_kernel_keeps_the_low_13_bits(device):
    """Field 1 + d and taps +-(1 + d) / 8 with d below 2^-11 (in the 13
    mantissa bits a tf32 operand does not read): plain TF32 would sum
    +-1/8 and miss the d terms by about 1e-3 or more; 3xTF32 keeps them to
    within phase 3's 1e-4 (outputs up to about 10)."""
    n, h, w, o, c = 2, 16, 70, 9, 64
    rng = np.random.RandomState(5)
    field = (1 + rng.uniform(0, 2 ** -11, (n, h + 6, w + 6, o))).astype(
        np.float32)
    taps = ((1 + rng.uniform(0, 2 ** -11, (n, 7, 7, o, c))).astype(
        np.float32) * rng.choice([-0.125, 0.125], (n, 7, 7, o, c))).astype(
        np.float32)
    assert (_tf32_truncated(field) == 1).all()
    assert (np.abs(_tf32_truncated(taps)) == 0.125).all()
    w_t = torch.from_numpy(field).to(device)
    g_t = torch.from_numpy(taps).to(device)
    got = stem(w_t, g_t)
    torch.cuda.synchronize()
    want = stem_plain(w_t, g_t)
    tf32 = stem_plain(torch.from_numpy(_tf32_truncated(field)).double(),
                      torch.from_numpy(_tf32_truncated(taps)).double())
    assert float((tf32 - want.double().cpu()).abs().max()) > 1e-3
    _assert_f32_stem_matches_plain(w_t, g_t, got)


@pytest.mark.parametrize("n", [1, 12, 16])
def test_stem_f32_kernel_is_bitwise_repeatable(device, n):
    """A request (1), a val sweep's batch (12) and a serving batch (16)."""
    w_t, g_t = _f32_stem_case(device, n, 128, 128, 9, 64, seed=6)
    first = stem(w_t, g_t)
    assert torch.equal(first, stem(w_t, g_t))
    _assert_f32_stem_matches_plain(w_t, g_t, first)


@pytest.mark.parametrize("n", [12, 16])
def test_stem_f32_kernel_launch_config(device, n):
    """At a val sweep's and at the serving shape: one block an SM, no
    local memory, bands of 64 pixels, every band in one wave."""
    config = f32_launch_config(n, 128, 128, 9, 64)
    props = torch.cuda.get_device_properties(0)
    assert config["blocks_per_sm"] == 1
    assert config["local_bytes"] == 0
    assert config["threads"] == 384
    assert config["band_pixels"] == 64
    assert config["grid"] <= props.multi_processor_count
    bands = -(-128 // config["band_rows"])
    assert n * 2 * bands == config["grid"]
    assert config["dynamic_smem_bytes"] <= props.shared_memory_per_block_optin
    # 77 k a pixel at 64 channels: bands of 32 pixels fit, 64 do not.
    assert f32_launch_config(1, 12, 70, 11, 64)["band_pixels"] == 32


def test_stem_f32_kernel_refuses_a_shape_beyond_its_tiles(device):
    """O = 40 weight channels: 280 k a pixel, whose taps and packed rows
    exceed a block's shared memory even in bands of 32 pixels. The launch
    is refused with the shape in the message, nothing is computed some
    other way, and the next launch runs clean."""
    w_t = torch.rand(1, 38, 38, 40, device=device)
    g_t = torch.rand(1, 7, 7, 40, 16, device=device)
    before = _cuda.LAUNCHES["stem_f32"]
    with pytest.raises(RuntimeError, match=r"stem kernel at W=32, O=40, C=16"):
        stem(w_t, g_t)
    with pytest.raises(RuntimeError,
                       match=r"stem kernel config at W=32, O=40, C=16"):
        f32_launch_config(1, 32, 32, 40, 16)
    assert _cuda.LAUNCHES["stem_f32"] == before
    w_t, g_t = _f32_stem_case(device, 1, 8, 8, 3, 4)
    _assert_f32_stem_matches_plain(w_t, g_t, stem(w_t, g_t))


def _bf16_stem_case(device, n, h, w, o, c, scale=1.0, seed=0):
    rng = np.random.RandomState(seed)
    w_t = torch.from_numpy(scale * rng.uniform(-1, 1, (n, h + 6, w + 6, o)))
    g_t = torch.from_numpy(scale * rng.uniform(-1, 1, (n, 7, 7, o, c)))
    return (w_t.to(device, torch.bfloat16).contiguous(),
            g_t.to(device, torch.bfloat16).contiguous())


def _assert_bf16_stem_matches_plain(w_t, g_t, got):
    """Both sides sum exact bf16 products in f32 and round once: within
    2^-7 of the largest output."""
    want = stem_plain(w_t.float(), g_t.float())
    assert got.shape == want.shape
    assert torch.isfinite(got).all()
    assert float((got.float() - want).abs().max()) <= 2 ** -7 * float(
        want.abs().max())


# (N, H, W, O, C): every ragged edge of the tensor-core kernel's tiles: H
# not a multiple of its 8 rows, W not a multiple of its 16-pixel tiles
# (and W != H: (N, H+6, W+6) = (2, 26, 126)), C not a multiple of 8 or of
# its 64-channel pass (odd C too), O = 1 (7*O = 7 of 16 k), O = 9 (63 of
# 64) and O = 10 (70 of 80, rows of 128 k).
STEM_TC_SHAPES = [(2, 20, 120, 9, 64), (1, 127, 127, 9, 64),
                  (1, 150, 40, 1, 4), (2, 20, 150, 1, 6), (1, 127, 72, 9, 72),
                  (1, 21, 130, 5, 9), (2, 9, 17, 10, 24), (16, 8, 16, 9, 64)]


@pytest.mark.parametrize("shape", STEM_TC_SHAPES)
def test_stem_tc_kernel_matches_plain_on_ragged_edges(device, shape):
    w_t, g_t = _bf16_stem_case(device, *shape)
    before = _cuda.LAUNCHES["stem_tc"]
    got = stem(w_t, g_t)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["stem_tc"] == before + 1
    _assert_bf16_stem_matches_plain(w_t, g_t, got)


@pytest.mark.parametrize("offset", [1, 3])
def test_stem_tc_kernel_takes_inputs_at_any_element_offset(device, offset):
    """Contiguous views that start off a 16-byte boundary: the kernel's
    bulk copies align their chunks to the source."""
    w_t, g_t = _bf16_stem_case(device, 2, 20, 33, 9, 16)
    views = []
    for t in (w_t, g_t):
        flat = torch.zeros(t.numel() + offset, dtype=t.dtype, device=device)
        flat[offset:] = t.reshape(-1)
        views.append(flat[offset:].view(t.shape))
    assert views[0].data_ptr() % 16 != 0 and views[0].is_contiguous()
    got = stem(*views)
    torch.cuda.synchronize()
    assert torch.equal(got, stem(w_t, g_t))
    _assert_bf16_stem_matches_plain(w_t, g_t, got)


def test_stem_tc_kernel_is_bitwise_repeatable(device):
    w_t, g_t = _bf16_stem_case(device, 16, 128, 128, 9, 64)
    first = stem(w_t, g_t)
    assert torch.equal(first, stem(w_t, g_t))


# (N, H, W, O, C) at the edges of the warpgroup kernel's passes and
# bands: W of 63 and 64 (one pass of 64 pixels), 65 (a pass of 128 whose
# last 63 pixels lie past W) and 129 (one of 128, then one of 64); C of 8
# (56 channels of the 64-channel product unused), 64 and 72 (a second
# channel tile holding 8); O = 1 (7 of 16 k) and O = 10 (70 k: a second
# 64-k block of the packed rows); 17 images at the serving size (7 bands
# of 19 rows an image, the last of 14: 119 blocks) and 150 small images
# (one band each, more bands than SMs: blocks walk two images).
STEM_TC_EDGE_SHAPES = [(2, 12, 63, 9, 64), (2, 12, 64, 9, 64),
                       (2, 12, 65, 9, 64), (1, 12, 129, 9, 64),
                       (2, 12, 40, 9, 8), (2, 12, 40, 9, 72),
                       (2, 20, 96, 1, 64), (2, 12, 32, 10, 64),
                       (17, 128, 128, 9, 64), (150, 12, 20, 9, 64)]


@pytest.mark.parametrize("shape", STEM_TC_EDGE_SHAPES)
def test_stem_tc_kernel_matches_plain_at_the_edges_of_its_tiles(device,
                                                                 shape):
    w_t, g_t = _bf16_stem_case(device, *shape, seed=2)
    before = _cuda.LAUNCHES["stem_tc"]
    got = stem(w_t, g_t)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["stem_tc"] == before + 1
    _assert_bf16_stem_matches_plain(w_t, g_t, got)


def test_stem_tc_kernel_bands_with_a_last_band_of_one_row(device):
    """16 images of 22 rows: bands of 3 rows, the last of 1 (on a card of
    132 SMs, 8 bands an image; the test reads the launch's band rows)."""
    n, h, w, o, c = 16, 22, 40, 9, 64
    config = tc_launch_config(n, h, w, o, c)
    w_t, g_t = _bf16_stem_case(device, n, h, w, o, c, seed=3)
    got = stem(w_t, g_t)
    torch.cuda.synchronize()
    if torch.cuda.get_device_properties(0).multi_processor_count == 132:
        assert h % config["band_rows"] == 1
    _assert_bf16_stem_matches_plain(w_t, g_t, got)


@pytest.mark.parametrize("x0", [0, 6, 37, 63])
def test_stem_tc_kernel_sends_each_dx_to_its_own_column(device, x0):
    """A field that is zero but at padded column x0: output column x0 - dx
    holds the dx taps alone, so a packed row's window at a wrong offset
    shows as a wrong or empty column."""
    n, h, w, o, c = 2, 10, 64, 9, 64
    rng = np.random.RandomState(4)
    field = np.zeros((n, h + 6, w + 6, o), np.float32)
    field[:, :, x0] = rng.uniform(0.5, 1.0, (n, h + 6, o))
    taps = rng.uniform(-1, 1, (n, 7, 7, o, c)).astype(np.float32)
    w_t = torch.from_numpy(field).to(device, torch.bfloat16)
    g_t = torch.from_numpy(taps).to(device, torch.bfloat16)
    got = stem(w_t, g_t).float()
    torch.cuda.synchronize()
    want = stem_plain(w_t.float(), g_t.float())
    _assert_bf16_stem_matches_plain(w_t, g_t, got.bfloat16())
    lit = [x0 - dx for dx in range(7) if 0 <= x0 - dx < w]
    assert bool((want[:, :, lit].abs().amax(dim=(0, 1, 3)) > 0).all())
    assert bool((got[:, :, lit].abs().amax(dim=(0, 1, 3)) > 0).all())
    dark = [x for x in range(w) if x not in lit]
    assert float(got[:, :, dark].abs().max()) == 0.0


def test_stem_tc_kernel_launch_config(device):
    """At the serving shape: whole rows, one block an SM, no spills, every
    band of a 16-image batch in one wave."""
    config = tc_launch_config(16, 128, 128, 9, 64)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert config["band_pixels"] == 0
    assert config["blocks_per_sm"] == 1
    assert config["local_bytes"] == 0
    assert config["threads"] == 384
    assert config["grid"] <= sms
    assert config["ring_rows"] >= 7
    assert config["dynamic_smem_bytes"] <= (
        torch.cuda.get_device_properties(0).shared_memory_per_block_optin)


def test_stem_tc_kernel_at_the_edge_of_the_bf16_range(device):
    """Field and taps up to +-1e3: sums near 1e7 stay finite and exact to
    the output's rounding."""
    w_t, g_t = _bf16_stem_case(device, 2, 32, 48, 9, 64, scale=1e3, seed=1)
    got = stem(w_t, g_t)
    torch.cuda.synchronize()
    assert float(w_t.float().abs().max()) > 990
    _assert_bf16_stem_matches_plain(w_t, g_t, got)


# (N, H, W, O, C) the whole-row kernel refuses, which the banded kernel
# takes: W = 160 (bands of 128 and 32 pixels: a last band narrower than
# 128, one n64 pass), 250 (a last band of 122), 256 with H = 13 and C = 72
# (a second channel tile of 8), 512 with C = 40; O = 10 in bands of 64
# (W = 200: 64, 64, 64 and 8), O = 14 in bands of 32 (W = 160 at C = 24,
# each pass reading 32 pixels past its band) and O = 16 at W = 161 (a last
# band of one pixel); the 256 px serving batch.
STEM_TC_BANDED_SHAPES = [(2, 20, 160, 9, 64), (2, 12, 250, 9, 64),
                         (1, 13, 256, 9, 72), (2, 10, 512, 9, 40),
                         (2, 12, 200, 10, 64), (1, 12, 160, 14, 24),
                         (1, 12, 161, 16, 64), (16, 256, 256, 9, 64)]


@pytest.mark.parametrize("shape", STEM_TC_BANDED_SHAPES)
def test_stem_tc_banded_kernel_matches_plain(device, shape):
    w_t, g_t = _bf16_stem_case(device, *shape, seed=5)
    before = dict(_cuda.LAUNCHES)
    got = stem(w_t, g_t)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["stem_tc_banded"] == before.get(
        "stem_tc_banded", 0) + 1
    assert _cuda.LAUNCHES["stem_tc"] == before.get("stem_tc", 0)
    assert _cuda.LAUNCHES["stem"] == before.get("stem", 0) + 1
    _assert_bf16_stem_matches_plain(w_t, g_t, got)


@pytest.mark.parametrize("n,w", [(16, 256), (2, 512)])
def test_stem_tc_banded_kernel_is_bitwise_repeatable(device, n, w):
    w_t, g_t = _bf16_stem_case(device, n, 64, w, 9, 64, seed=6)
    first = stem(w_t, g_t)
    assert torch.equal(first, stem(w_t, g_t))
    _assert_bf16_stem_matches_plain(w_t, g_t, first)


@pytest.mark.parametrize("x0", [0, 128])
def test_stem_tc_banded_kernel_band_equals_the_whole_row_kernel(device, x0):
    """Each band sums its elements in the whole-row kernel's order: the
    band of pixels x0..x0+127 at W = 256 is, bit for bit, the whole-row
    kernel's output on the field's columns x0..x0+133 alone (W = 128)."""
    w_t, g_t = _bf16_stem_case(device, 4, 40, 256, 9, 64, seed=7)
    before = dict(_cuda.LAUNCHES)
    band = stem(w_t, g_t)[:, :, x0:x0 + 128]
    whole = stem(w_t[:, :, x0:x0 + 134].contiguous(), g_t)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["stem_tc_banded"] == before.get(
        "stem_tc_banded", 0) + 1
    assert _cuda.LAUNCHES["stem_tc"] == before.get("stem_tc", 0) + 1
    assert torch.equal(band, whole)


@pytest.mark.parametrize("x0", [0, 127, 130, 134, 255, 261])
def test_stem_tc_banded_kernel_sends_each_dx_to_its_own_column(device, x0):
    """A field that is zero but at padded column x0, at and across the
    boundary of two 128-pixel bands (x0 = 130 reaches output columns
    124-130 of both): a band's halo read at a wrong offset shows as a
    wrong or empty column."""
    n, h, w, o, c = 2, 10, 256, 9, 64
    rng = np.random.RandomState(4)
    field = np.zeros((n, h + 6, w + 6, o), np.float32)
    field[:, :, x0] = rng.uniform(0.5, 1.0, (n, h + 6, o))
    taps = rng.uniform(-1, 1, (n, 7, 7, o, c)).astype(np.float32)
    w_t = torch.from_numpy(field).to(device, torch.bfloat16)
    g_t = torch.from_numpy(taps).to(device, torch.bfloat16)
    assert tc_launch_config(n, h, w, o, c)["band_pixels"] == 128
    got = stem(w_t, g_t).float()
    torch.cuda.synchronize()
    want = stem_plain(w_t.float(), g_t.float())
    _assert_bf16_stem_matches_plain(w_t, g_t, got.bfloat16())
    lit = [x0 - dx for dx in range(7) if 0 <= x0 - dx < w]
    assert bool((want[:, :, lit].abs().amax(dim=(0, 1, 3)) > 0).all())
    assert bool((got[:, :, lit].abs().amax(dim=(0, 1, 3)) > 0).all())
    dark = [x for x in range(w) if x not in lit]
    assert float(got[:, :, dark].abs().max()) == 0.0


def test_stem_tc_banded_kernel_bands_with_a_last_band_of_one_row(device):
    """16 images of 10 rows at W = 256: 32 columns of 128 pixels, bands of
    3 rows, the last of 1 (on a card of 132 SMs; the test reads the
    launch's band rows)."""
    n, h, w, o, c = 16, 10, 256, 9, 64
    config = tc_launch_config(n, h, w, o, c)
    w_t, g_t = _bf16_stem_case(device, n, h, w, o, c, seed=3)
    got = stem(w_t, g_t)
    torch.cuda.synchronize()
    assert config["band_pixels"] == 128
    if torch.cuda.get_device_properties(0).multi_processor_count == 132:
        assert h % config["band_rows"] == 1
    _assert_bf16_stem_matches_plain(w_t, g_t, got)


def test_stem_tc_launch_config_reports_the_band(device):
    """The 128 px serving shape keeps whole rows (band_pixels 0,
    stem_tc_kernel); the 256 px one takes bands of 128 pixels, every band
    in one wave, one block an SM, no spills; O = 10 and O = 14 at 128 px
    take bands of 64 and 32 pixels."""
    props = torch.cuda.get_device_properties(0)
    assert tc_launch_config(16, 128, 128, 9, 64)["band_pixels"] == 0
    config = tc_launch_config(16, 256, 256, 9, 64)
    assert config["band_pixels"] == 128
    assert config["blocks_per_sm"] == 1
    assert config["local_bytes"] == 0
    assert config["threads"] == 384
    assert config["ring_rows"] >= 7
    assert config["grid"] <= props.multi_processor_count
    bands = -(-256 // config["band_rows"])
    assert 16 * 2 * bands == config["grid"]
    assert config["dynamic_smem_bytes"] <= props.shared_memory_per_block_optin
    assert tc_launch_config(16, 128, 128, 10, 64)["band_pixels"] == 64
    assert tc_launch_config(16, 128, 128, 14, 64)["band_pixels"] == 32


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


# The serving shape; then D = 7 and W = 150 (one element a thread); D = 13
# and H = 36, not a multiple of the 8-row tile; the 16-byte write path with
# H = 100; M = 48, more mask columns than a warp's lanes (f32 D = 6: the
# 16-byte path with half-chunks of 2 channels).
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,o,d,m,h,w", [(4, 9, 204, 32, 128, 128),
                                         (3, 4, 7, 8, 36, 150),
                                         (2, 9, 13, 32, 36, 128),
                                         (2, 5, 204, 32, 100, 64),
                                         (2, 3, 6, 48, 40, 40)])
def test_compositor_kernel_matches_plain(device, dtype, n, o, d, m, h, w):
    inputs = _compositor_case(device, dtype, n, o, d, m, h, w)
    before = _cuda.LAUNCHES["compositor"]
    got = composite(*inputs).float()
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["compositor"] == before + 1
    _assert_compositor_matches_plain(inputs, got)


def _assert_compositor_matches_plain(inputs, got):
    want = composite_plain(*inputs).float()
    assert got.shape == want.shape
    assert torch.isfinite(got).all()
    diff = (got - want).abs().amax(-1)
    # A claim flips only where a resampled value lies within rounding of
    # 0.5 (the sums run in another order); such a pixel differs by a whole
    # vector. Every other pixel differs by rounding of the output dtype.
    tol = 1e-4 if inputs[0].dtype == torch.float32 else 2 ** -8 * 2
    assert int((diff > tol).sum()) <= 8


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["dense", "holes"])
def test_compositor_kernel_matches_plain_on_dense_matrices(device, dtype,
                                                           kind):
    """ry and rx that are not hats: every row dense ('dense'), or with
    zeros inside rows' spans, rows of zeros and one object's matrices all
    zero ('holes'). The spans are then whole rows, or ragged ones."""
    rng = np.random.RandomState(7)
    n, o, d, m, h, w = 2, 5, 204, 32, 40, 64
    # Rows that sum to about 1 (2 with holes, half of them zeroed), so the
    # resampled masks spread around 0.5 and about half the pixels claim.
    top = 2.0 / m if kind == "dense" else 4.0 / m
    ry = rng.uniform(0, top, (n, o, h, m)).astype(np.float32)
    rx = rng.uniform(0, top, (n, o, w, m)).astype(np.float32)
    if kind == "holes":
        for a in (ry, rx):
            a[rng.rand(*a.shape) < 0.5] = 0.0
            a[:, :, 3] = 0.0
            a[0, 2] = 0.0
    masks = rng.rand(n, o, m, m).astype(np.float32)
    vecs = rng.randn(n, o, d).astype(np.float32)
    inputs = [torch.from_numpy(a).to(device, dtype)
              for a in (vecs, ry, rx, masks)]
    got = composite(*inputs).float()
    torch.cuda.synchronize()
    _assert_compositor_matches_plain(inputs, got)
    assert float(got.abs().sum()) > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_compositor_kernel_is_bitwise_repeatable(device, dtype):
    inputs = _compositor_case(device, dtype, 16, 9, 204, 32, 128, 128)
    first = composite(*inputs)
    assert torch.equal(first, composite(*inputs))


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
    # The bf16 kernels' taps alone at O = 40 (7 x 288 k x 64 channels)
    # exceed it, in whole rows and in bands.
    with pytest.raises(RuntimeError, match="stem kernel"):
        stem(torch.rand(1, 518, 518, 40, device=device).bfloat16(),
             torch.rand(1, 7, 7, 40, 4, device=device).bfloat16())
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
    for name in ("crop_fwd", "crop_bwd", "crop_bwd_boxes"):
        assert _cuda.LAUNCHES[name] == before.get(name, 0) + 1, name
    _assert_crop_matches_plain(imgs, ry, rx, u, got, grads)
    again = crop_bwd(imgs, ry, rx, u)
    for a, b in zip(grads, again):
        assert torch.equal(a, b)        # no atomics: bitwise repeatable


def _assert_crop_matches_plain(imgs, ry, rx, u, got, grads):
    """Forward and backward against the plain versions. f32: the same
    products summed in another order; bf16: both round one f32 sum to
    bf16."""
    want = crop_fwd_plain(imgs, ry, rx)
    want_grads = crop_bwd_plain(imgs, ry, rx, u)
    for name, a, b in zip(("out", "d_img", "d_ry", "d_rx"), (got, *grads),
                          (want, *want_grads)):
        a, b = a.float(), b.float()
        scale = float(b.abs().max())
        tol = 1e-5 * max(scale, 1.0) if imgs.dtype == torch.float32 else \
            2 ** -7 * scale
        assert torch.isfinite(a).all(), name
        assert float((a - b).abs().max()) <= tol, name


def _edge_boxes(o):
    """Degenerate in x and in y, flipped in x and in y, partly and wholly
    out of frame, samples on grid lines (x0 = 0 at 128 px and 32 px crops
    step 4 pixels), then ordinary boxes."""
    boxes = np.array([[0.4, 0.2, 0.4, 0.7], [0.1, 0.5, 0.6, 0.5],
                      [0.7, 0.2, 0.3, 0.6], [0.2, 0.9, 0.6, 0.1],
                      [-0.2, 0.5, 0.3, 1.3], [0.8, -0.3, 1.4, 0.4],
                      [1.2, 1.1, 1.7, 1.9], [0.0, 0.0, 124 / 127, 124 / 127],
                      [0.25, 0.3, 0.75, 0.9]], np.float32)
    return boxes[np.arange(o) % len(boxes)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [8, 64])
def test_crop_forward_matches_plain_at_the_accuracy_crops(device, dtype, n):
    """The accuracy net's 224 px crops of 128 px images (hats that
    upsample every box), at sample_images' batch 8 and eval_run's 64 (576
    crops): the kernel equals the plain version (f32 within 1e-5 of the
    largest value; bf16 one rounding)."""
    imgs, ry, rx, _ = _crop_case(device, dtype, n, 128, 128, 3, 9, 224, 224)
    got = crop_fwd(imgs, ry, rx)
    want = crop_fwd_plain(imgs, ry, rx)
    rel = 1e-5 if dtype == torch.float32 else 2 ** -7
    err = float((got.float() - want.float()).abs().max())
    assert err <= rel * float(want.float().abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hh", [64, 32])
def test_crop_kernels_match_plain_on_edge_hats(device, dtype, hh):
    rng = np.random.RandomState(3)
    n, o = 2, 9
    boxes = torch.from_numpy(np.stack([_edge_boxes(o), _edge_boxes(o)[::-1]]))
    imgs = torch.from_numpy(rng.uniform(-1, 1, (n, 128, 128, 3)).astype(
        np.float32)).to(device, dtype)
    ry, rx = crop_matrices(boxes.to(device, dtype), hh, hh, 128, 128)
    ry, rx = ry.contiguous(), rx.contiguous()
    u = torch.from_numpy(rng.randn(n, o, hh, hh, 3).astype(np.float32)).to(
        device, dtype)
    got = crop_fwd(imgs, ry, rx)
    _assert_crop_matches_plain(imgs, ry, rx, u, got, crop_bwd(imgs, ry, rx, u))


def _dense_case(device, dtype, kind, n=2, h=24, w=40, c=3, o=3, hh=16,
                ww=12, seed=4):
    """Random dense ry, rx ('dense'), or the same with holes: zeros inside
    rows' spans and whole rows and columns of zeros ('holes')."""
    rng = np.random.RandomState(seed)
    ry = rng.randn(n, o, hh, h).astype(np.float32)
    rx = rng.randn(n, o, ww, w).astype(np.float32)
    if kind == "holes":
        for m in (ry, rx):
            m[rng.rand(*m.shape) < 0.5] = 0.0
            m[:, :, 1] = 0.0                       # rows of zeros
            m[:, :, :, 2:5] = 0.0                  # columns of zeros
            m[0, 1] = 0.0                          # a matrix of zeros
    t = lambda a: torch.from_numpy(a).to(device, dtype)  # noqa: E731
    return (t(rng.uniform(-1, 1, (n, h, w, c)).astype(np.float32)), t(ry),
            t(rx), t(rng.randn(n, o, hh, ww, c).astype(np.float32)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["dense", "holes"])
def test_crop_kernels_match_plain_on_dense_matrices(device, dtype, kind):
    imgs, ry, rx, u = _dense_case(device, dtype, kind)
    got = crop_fwd(imgs, ry, rx)
    _assert_crop_matches_plain(imgs, ry, rx, u, got, crop_bwd(imgs, ry, rx, u))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_crop_d_img_alone_is_bitwise_the_full_backward(device, dtype):
    imgs, ry, rx, u = _crop_case(device, dtype, 12, 128, 128, 3, 9, 32, 32)
    before = dict(_cuda.LAUNCHES)
    alone = crop_bwd(imgs, ry, rx, u, needs=(True, False, False))
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["crop_bwd"] == before.get("crop_bwd", 0) + 1
    assert _cuda.LAUNCHES["crop_bwd_boxes"] == before.get("crop_bwd_boxes", 0)
    assert alone[1] is None and alone[2] is None
    full = crop_bwd(imgs, ry, rx, u)
    assert torch.equal(alone[0], full[0])
    boxes_only = crop_bwd(imgs, ry, rx, u, needs=(False, True, False))
    assert boxes_only[0] is None and boxes_only[2] is None
    assert torch.equal(boxes_only[1], full[1])


def _assert_crop_bitwise(imgs, ry, rx, u):
    """The forward and d_img equal the plain versions bit for bit (f32:
    both sum the same products in the same order, the hats' zeros aside),
    and two runs of each equal each other."""
    got, again = crop_fwd(imgs, ry, rx), crop_fwd(imgs, ry, rx)
    d_img = crop_bwd(imgs, ry, rx, u, needs=(True, False, False))[0]
    d_again = crop_bwd(imgs, ry, rx, u, needs=(True, False, False))[0]
    torch.cuda.synchronize()
    assert torch.equal(got, again) and torch.equal(d_img, d_again)
    assert torch.equal(got, crop_fwd_plain(imgs, ry, rx))
    assert torch.equal(d_img, crop_bwd_plain(imgs, ry, rx, u,
                                             (True, False, False))[0])


def test_crop_kernels_on_a_band_that_samples_no_image_row(device):
    """Boxes partly out of frame in y only, and one wholly out of it in y:
    the forward's bands of crop rows (13 bands of 5 rows at 18 crops of 64
    px) include bands whose rows sample no image row, and d_img's blocks of
    image rows include ones that no crop row samples. Their outputs are the
    plain version's zeros, bit for bit."""
    rng = np.random.RandomState(11)
    boxes = np.tile(_edge_boxes(9), (2, 1, 1))
    boxes[0, 0] = [0.1, 0.6, 0.5, 1.6]        # the lower rows out of frame
    boxes[0, 1] = [0.3, -0.9, 0.8, 0.3]       # the upper rows out of frame
    boxes[1, 0] = [0.2, 1.2, 0.7, 1.8]        # every row out of frame
    imgs = torch.from_numpy(rng.uniform(-1, 1, (2, 128, 128, 3)).astype(
        np.float32)).to(device)
    ry, rx = crop_matrices(torch.from_numpy(boxes).to(device), 64, 64, 128,
                           128)
    assert float(ry[1, 0].abs().sum()) == 0.0
    assert float(ry[0, 0, 40:].abs().sum()) == 0.0     # whole bands empty
    u = torch.from_numpy(rng.randn(2, 9, 64, 64, 3).astype(np.float32)).to(
        device)
    _assert_crop_bitwise(imgs, ry.contiguous(), rx.contiguous(), u)


def test_crop_kernels_at_a_height_no_band_divides(device):
    """HH = WW = 37 on 45 x 50 images: the forward's bands of crop rows (7
    rows: 6 bands) and d_img's blocks of image rows and columns (8 x 32)
    end short of their full size."""
    imgs, ry, rx, u = _crop_case(device, torch.float32, 2, 45, 50, 3, 9, 37,
                                 37, seed=12)
    _assert_crop_bitwise(imgs, ry, rx, u)


BOXES_ONLY = (False, True, True)


def _box_gradient_cases(device, dtype):
    """(name, (imgs, ry, rx, u)): hats at the train shapes, edge hats at
    both crop sizes, dense matrices and matrices with holes."""
    yield "hats", _crop_case(device, dtype, 12, 128, 128, 3, 9, 32, 32)
    rng = np.random.RandomState(3)
    boxes = torch.from_numpy(np.stack([_edge_boxes(9), _edge_boxes(9)[::-1]]))
    imgs = torch.from_numpy(rng.uniform(-1, 1, (2, 128, 128, 3)).astype(
        np.float32)).to(device, dtype)
    for hh in (64, 32):
        ry, rx = crop_matrices(boxes.to(device, dtype), hh, hh, 128, 128)
        u = torch.from_numpy(rng.randn(2, 9, hh, hh, 3).astype(
            np.float32)).to(device, dtype)
        yield f"edge_hats_{hh}", (imgs, ry.contiguous(), rx.contiguous(), u)
    for kind in ("dense", "holes"):
        yield kind, _dense_case(device, dtype, kind)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_crop_box_gradients_alone_match_plain(device, dtype):
    """The box gradients' kernel by itself (d_ry and d_rx, no d_img): one
    launch a call, within the plain version's tolerance (f32 1e-5, bf16
    2^-7 of the largest value), bitwise repeatable, and bitwise the d_ry and
    d_rx of the full backward."""
    for name, (imgs, ry, rx, u) in _box_gradient_cases(device, dtype):
        before = _cuda.LAUNCHES["crop_bwd_boxes"]
        got = crop_bwd(imgs, ry, rx, u, needs=BOXES_ONLY)
        torch.cuda.synchronize()
        assert _cuda.LAUNCHES["crop_bwd_boxes"] == before + 1, name
        assert got[0] is None, name
        want = crop_bwd_plain(imgs, ry, rx, u, needs=BOXES_ONLY)
        for a, b in zip(got[1:], want[1:]):
            a, b = a.float(), b.float()
            scale = float(b.abs().max())
            tol = 1e-5 * max(scale, 1.0) if dtype == torch.float32 else \
                2 ** -7 * scale
            assert torch.isfinite(a).all(), name
            assert float((a - b).abs().max()) <= tol, name
        again = crop_bwd(imgs, ry, rx, u, needs=BOXES_ONLY)
        full = crop_bwd(imgs, ry, rx, u)
        assert _cuda.LAUNCHES["crop_bwd_boxes"] == before + 3, name
        for i in (1, 2):
            assert torch.equal(got[i], again[i]), name
            assert torch.equal(got[i], full[i]), name


def test_crop_box_gradients_of_boxes_outside_the_image_are_zero(device):
    """Boxes wholly out of frame sample nothing: no column or row of the
    hats holds a nonzero, and d_ry and d_rx are exact zeros."""
    boxes = torch.tensor([[[1.2, 1.1, 1.7, 1.9], [-0.9, -0.8, -0.2, -0.1]]],
                         device=device)
    ry, rx = crop_matrices(boxes, 32, 32, 128, 128)
    assert float(ry.abs().sum() + rx.abs().sum()) == 0.0
    imgs = torch.rand(1, 128, 128, 3, device=device)
    u = torch.randn(1, 2, 32, 32, 3, device=device)
    _, d_ry, d_rx = crop_bwd(imgs, ry.contiguous(), rx.contiguous(), u,
                             needs=BOXES_ONLY)
    assert torch.equal(d_ry, torch.zeros_like(d_ry))
    assert torch.equal(d_rx, torch.zeros_like(d_rx))


def test_crop_box_gradient_matches_the_cpu(device):
    """Gradients reach the boxes through crop_matrices and the d_ry / d_rx
    kernels; on the card they match the CPU's plain backward."""
    rng = np.random.RandomState(5)
    imgs = rng.uniform(-1, 1, (2, 32, 48, 3)).astype(np.float32)
    boxes = np.stack([_edge_boxes(5), _edge_boxes(9)[4:]])
    target = rng.randn(2, 5, 8, 12, 3).astype(np.float32)
    grads = []
    for dev in (device, torch.device("cpu")):
        im = torch.from_numpy(imgs).to(dev).requires_grad_(True)
        bx = torch.from_numpy(boxes).to(dev).requires_grad_(True)
        before = _cuda.LAUNCHES["crop_bwd_boxes"]
        loss = (crop_bbox_batch(im, bx, 8, 12)
                * torch.from_numpy(target).to(dev)).sum()
        grads.append([g.cpu() for g in torch.autograd.grad(loss, (im, bx))])
        assert _cuda.LAUNCHES["crop_bwd_boxes"] == before + (
            dev.type == "cuda")
    for a, b in zip(*grads):
        scale = float(b.abs().max())
        assert scale > 0
        assert float((a - b).abs().max()) <= 1e-5 * max(scale, 1.0)


def test_crop_function_backward_is_the_kernel(device):
    imgs, ry, rx, u = _crop_case(device, torch.float32, 2, 32, 32, 3, 4, 8, 8)
    imgs.requires_grad_(True)
    before = dict(_cuda.LAUNCHES)
    (crop(imgs, ry, rx) * u).sum().backward()
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["crop_bwd"] == before.get("crop_bwd", 0) + 1
    # The boxes need no gradient: the d_ry / d_rx kernels stay idle.
    assert _cuda.LAUNCHES["crop_bwd_boxes"] == before.get("crop_bwd_boxes", 0)
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
