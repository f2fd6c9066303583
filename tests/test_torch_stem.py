"""The port's factored stem against the JAX package's ``stem_pallas``.

On the CPU the stem wrapper runs its plain version (F.unfold + one
per-image product); here it is held against the TPU kernel run in Pallas
interpret mode, at the shapes tests/test_factored_stem.py uses and at the
``test_config`` and ``tiny_config`` stem shapes. The CUDA kernel is held
against the plain version on the card by tests/test_torch_kernels_cuda.py.

Tolerances: f32 sums of 49*O products of O(1) values, 1e-4 absolute; bf16
outputs are compared within two bf16 ulps of their magnitude.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from scene_generation_tpu.config import test_config as small_config
from scene_generation_tpu.config import tiny_config
from scene_generation_tpu.ops.pallas.stem import stem_pallas
from scene_generation_tpu_torch.models.generators import StemConv
from scene_generation_tpu_torch.ops import _cuda
from scene_generation_tpu_torch.ops.stem import stem, stem_plain

SHAPES = {  # (O, C, H): the O=9/C=16/32x32 case, test_config, tiny_config
    "o9_c16_32": (9, 16, 32),
    "test_config": (small_config().data.max_objs, small_config().model.ngf,
                    small_config().model.image_size[0]),
    "tiny_config": (tiny_config().data.max_objs, tiny_config().model.ngf,
                    tiny_config().model.image_size[0]),
}


def _inputs(o, c, h, seed=0, n=2):
    rng = np.random.RandomState(seed)
    wmap = rng.rand(n, h + 6, h + 6, o).astype(np.float32)
    g = rng.randn(n, 7, 7, o, c).astype(np.float32)
    return wmap, g


@pytest.mark.parametrize("shape", list(SHAPES))
def test_plain_stem_matches_pallas_interpret(shape):
    wmap, g = _inputs(*SHAPES[shape])
    want = np.asarray(stem_pallas(jnp.asarray(wmap), jnp.asarray(g),
                                  interpret=True))
    got = stem_plain(torch.from_numpy(wmap), torch.from_numpy(g)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-5)


def test_plain_stem_bf16_matches_pallas_interpret():
    wmap, g = _inputs(9, 16, 32, seed=1)
    want = np.asarray(stem_pallas(jnp.asarray(wmap, jnp.bfloat16),
                                  jnp.asarray(g, jnp.bfloat16),
                                  interpret=True).astype(jnp.float32))
    got = stem_plain(torch.from_numpy(wmap).bfloat16(),
                     torch.from_numpy(g).bfloat16()).float().numpy()
    np.testing.assert_allclose(got, want, atol=2 * 2 ** -8 * np.abs(want).max())


def test_cpu_wrapper_runs_the_plain_version_without_a_launch():
    wmap, g = _inputs(5, 8, 16, seed=2)
    before = _cuda.LAUNCHES["stem"]
    got = stem(torch.from_numpy(wmap), torch.from_numpy(g))
    want = stem_plain(torch.from_numpy(wmap), torch.from_numpy(g))
    assert torch.equal(got, want)
    assert _cuda.LAUNCHES["stem"] == before


@pytest.mark.parametrize("cfg", [small_config, tiny_config])
def test_factored_stemconv_matches_dense(cfg):
    """conv(layout) == factored(weights, vecs): the layout is rank O."""
    mc = cfg().model
    n, o, d, h = 2, cfg().data.max_objs, mc.layout_nc, mc.image_size[0]
    rng = np.random.RandomState(3)
    wmap = torch.from_numpy(rng.rand(n, o, h, h).astype(np.float32))
    vecs = torch.from_numpy(rng.randn(n, o, d).astype(np.float32))
    sc = StemConv(d, mc.ngf)
    torch.nn.init.normal_(sc.conv.bias)
    pad = torch.nn.functional.pad
    layout = torch.einsum("nohw,nod->ndhw", wmap, vecs)
    with torch.no_grad():
        dense = sc(pad(layout, (3, 3, 3, 3), mode="reflect"))
        fact = sc.factored(pad(wmap, (3, 3, 3, 3), mode="reflect").permute(
            0, 2, 3, 1).contiguous(), vecs)
    np.testing.assert_allclose(fact.permute(0, 3, 1, 2).numpy(),
                               dense.numpy(), atol=2e-5, rtol=1e-5)
