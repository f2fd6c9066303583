"""The port's evaluation models and image I/O against the JAX package, on
the CPU: the accuracy net's ResNet (logits in eval and train mode, the
running statistics, the torchvision-name loader), LPIPS (VGG16 taps and
distances with the same random weights), FID (the Frechet distance, the
accumulator, the shallow fallback with JAX's kernels), ``decode_png``
and ``vis.py``. Inputs are drawn with numpy from a seed."""
import io
import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import PIL.Image
import pytest
import torch

from scene_generation_tpu import vis as jax_vis
from scene_generation_tpu.metrics_fid import FIDAccumulator as JaxFID
from scene_generation_tpu.metrics_fid import _stats as jax_stats
from scene_generation_tpu.metrics_fid import \
    create_shallow_features_fn as jax_shallow
from scene_generation_tpu.metrics_fid import \
    frechet_distance as jax_frechet
from scene_generation_tpu.metrics_lpips import Vgg16Features as JaxVgg16
from scene_generation_tpu.metrics_lpips import \
    create_lpips_fn as jax_create_lpips_fn
from scene_generation_tpu.models.resnet import ResNet as JaxResNet
from scene_generation_tpu.models.resnet import \
    load_torch_resnet as jax_load_torch_resnet
from scene_generation_tpu_torch import vis
from scene_generation_tpu_torch.convert import (lpips_state_dict_from_jax,
                                                resnet_state_dict_from_jax,
                                                shallow_kernels_from_jax)
from scene_generation_tpu_torch.data.image_utils import (decode_png,
                                                         encode_png)
from scene_generation_tpu_torch.metrics_fid import (FIDAccumulator, _stats,
                                                    create_shallow_features_fn,
                                                    frechet_distance)
from scene_generation_tpu_torch.metrics_lpips import (LPIPS, Vgg16Features,
                                                      create_lpips_fn)
from scene_generation_tpu_torch.models.resnet import (ResNet,
                                                      load_torch_resnet)

from _torch_port import random_variables


@pytest.fixture
def no_weight_files(monkeypatch, tmp_path):
    """No pretrained file can be found: another HOME, no lookup variable."""
    monkeypatch.setenv("HOME", str(tmp_path))
    for env in ("SGT_RESNET_WEIGHTS", "SGT_VGG16_WEIGHTS",
                "SGT_LPIPS_WEIGHTS", "SGT_INCEPTION_WEIGHTS"):
        monkeypatch.delenv(env, raising=False)


# --- ResNet (the accuracy net) -----------------------------------------------

# f32 through 16 convs and batch norms: 1e-4 of the logits' scale.
RESNET_TOL = 1e-4


@pytest.fixture(scope="module")
def resnet_pair():
    """The JAX ResNet (1, 1, 1, 1) at 32 px crops with numpy-drawn
    variables (random BN statistics), and the port's with them bridged."""
    net = JaxResNet(stage_sizes=(1, 1, 1, 1), num_classes=7)
    shapes = jax.eval_shape(net.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 32, 3)))
    variables = random_variables(shapes, 0)
    port = ResNet((1, 1, 1, 1), 7)
    port.load_state_dict(resnet_state_dict_from_jax(variables))
    x = np.random.RandomState(1).uniform(-1, 1, (4, 32, 32, 3)).astype(
        np.float32)
    return net, variables, port, x


def _close(got, want, tol, what):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, atol=tol * scale, rtol=0,
                               err_msg=what)


def test_resnet_logits_match_jax_in_eval_and_train_mode(resnet_pair):
    net, variables, port, x = resnet_pair
    want = jax.jit(lambda v, x: net.apply(v, x, train=False))(
        variables, jnp.asarray(x))
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x))
    _close(got, want, RESNET_TOL, "eval logits")

    want, mutated = jax.jit(lambda v, x: net.apply(
        v, x, train=True, mutable=["batch_stats"]))(variables, jnp.asarray(x))
    port.train()
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    _close(got, want, RESNET_TOL, "train logits")
    # The running statistics move as flax's (momentum 0.9, biased var).
    stats = resnet_state_dict_from_jax(
        {"params": variables["params"],
         "batch_stats": jax.device_get(mutated["batch_stats"])})
    for k, v in port.state_dict().items():
        if "running_" in k:
            _close(v, stats[k], 1e-5, k)


def test_resnet_torchvision_loader_matches_jax(resnet_pair, tmp_path):
    """One torchvision-named file, read by both packages' loaders (the
    port's fc kept with skip_fc), gives the same logits."""
    net, variables, port, x = resnet_pair
    gen = torch.Generator().manual_seed(3)
    sd = {k: (torch.rand(v.shape, generator=gen) + 0.5 if "running_var" in k
              else 0.1 * torch.randn(v.shape, generator=gen))
          for k, v in port.state_dict().items()
          if not k.endswith("num_batches_tracked")}
    path = str(tmp_path / "resnet101-test.pth")
    torch.save(sd, path)
    jvars, jloaded = jax_load_torch_resnet(variables, path=path)
    other = ResNet((1, 1, 1, 1), 7)
    other, loaded = load_torch_resnet(other, path=path)
    assert loaded and jloaded
    for k, v in sd.items():
        assert torch.equal(other.state_dict()[k], v), k
    want = jax.jit(lambda v, x: net.apply(v, x, train=False))(
        jvars, jnp.asarray(x))
    with torch.no_grad():
        got = other.eval()(torch.from_numpy(x))
    _close(got, want, RESNET_TOL, "loaded logits")
    fc = port.fc.weight.clone()
    kept, _ = load_torch_resnet(port, path=path, skip_fc=True)
    assert torch.equal(kept.fc.weight, fc)
    assert torch.equal(kept.conv1.weight, sd["conv1.weight"])


@pytest.mark.slow
def test_resnet101_logits_match_jax_at_224():
    """Full depth: the JAX resnet101 at 224 px crops, eval
    mode, against the port's with the variables bridged."""
    net = JaxResNet(stage_sizes=(3, 4, 23, 3), num_classes=172)
    shapes = jax.eval_shape(net.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 224, 224, 3)))
    variables = random_variables(shapes, 2)
    port = ResNet((3, 4, 23, 3), 172)
    port.load_state_dict(resnet_state_dict_from_jax(variables))
    x = np.random.RandomState(4).uniform(-1, 1, (2, 224, 224, 3)).astype(
        np.float32)
    want = jax.jit(lambda v, x: net.apply(v, x, train=False))(
        variables, jnp.asarray(x))
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x))
    _close(got, want, RESNET_TOL, "resnet101 logits")


def test_resnet_loader_without_a_file(no_weight_files):
    model = ResNet((1, 1, 1, 1), 3)
    assert load_torch_resnet(model)[1] is False


def test_resnet_loader_refuses_torchvision_widths(tmp_path):
    """A file of torchvision's widths (layer2 128 wide, where this net and
    the JAX package's keep 64) is refused by name, not loaded in part."""
    model = ResNet((1, 1, 1, 1), 3)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    sd["layer2.0.conv1.weight"] = torch.zeros(128, 256, 1, 1)
    path = str(tmp_path / "resnet101-torchvision.pth")
    torch.save(sd, path)
    with pytest.raises(ValueError, match="layer2.0.conv1.weight"):
        load_torch_resnet(model, path=path)


# --- LPIPS --------------------------------------------------------------------

# 13 f32 convs at 64 px: taps 1e-4 of their scale, distances 1e-4
# relative.
LPIPS_TOL = 1e-4


def test_vgg16_taps_and_lpips_distances_match_jax(no_weight_files,
                                                  monkeypatch):
    """``create_lpips_fn``'s own weights (flax's init from PRNGKey(0),
    uniform lin, no files) bridged into the port's LPIPS: the same taps
    and distances at 64 px."""
    import inspect
    # The same init, jitted: bitwise the eager one's values, in a quarter
    # of its time.
    init = JaxVgg16.init
    monkeypatch.setattr(JaxVgg16, "init", lambda self, rng, x: jax.jit(
        lambda r, y: init(self, r, y))(rng, x))
    jax_fn, jloaded = jax_create_lpips_fn()
    held = inspect.getclosurevars(jax_fn).nonlocals
    params = jax.device_get(held["variables"]["params"])
    lins = [np.asarray(w) for w in held["lins"]]
    port = LPIPS()
    port.load_state_dict(lpips_state_dict_from_jax(params, lins))
    rng = np.random.RandomState(0)
    x = rng.uniform(-1, 1, (3, 64, 64, 3)).astype(np.float32)
    y = np.clip(x + 0.3 * rng.randn(*x.shape), -1, 1).astype(np.float32)
    with torch.no_grad():
        taps = port.vgg(torch.from_numpy(x))
        got = port(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    jax_taps = jax.jit(JaxVgg16().apply)({"params": params}, jnp.asarray(x))
    for i, (a, b) in enumerate(zip(taps, jax_taps)):
        _close(a.numpy(), b, LPIPS_TOL, f"tap {i}")
    want = np.asarray(jax_fn(jnp.asarray(x), jnp.asarray(y)))
    np.testing.assert_allclose(got, want, rtol=LPIPS_TOL, atol=0)
    assert not jloaded
    # The port's own fallback: seeded, deterministic, zero on x == x.
    fn, loaded = create_lpips_fn("cpu")
    assert not loaded
    d = fn(x, y)
    assert torch.equal(d, create_lpips_fn("cpu")[0](x, y))
    assert float(fn(x, x).abs().max()) == 0.0 and bool((d > 0).all())


@pytest.mark.slow
def test_lpips_matches_jax_at_224(no_weight_files):
    """Full width: VGG16 LPIPS at 224 px with the same random weights."""
    model = JaxVgg16()
    params = jax.device_get(jax.jit(model.init)(
        jax.random.PRNGKey(1), jnp.zeros((1, 224, 224, 3)))["params"])
    lins = [np.random.RandomState(i).rand(c).astype(np.float32)
            for i, c in enumerate((64, 128, 256, 512, 512))]
    port = LPIPS()
    port.load_state_dict(lpips_state_dict_from_jax(params, lins))
    rng = np.random.RandomState(5)
    x = rng.uniform(-1, 1, (2, 224, 224, 3)).astype(np.float32)
    y = rng.uniform(-1, 1, (2, 224, 224, 3)).astype(np.float32)
    from scene_generation_tpu.metrics_lpips import _SCALE, _SHIFT
    apply = jax.jit(model.apply)
    taps = apply({"params": params}, (jnp.asarray(x) - _SHIFT) / _SCALE)
    taps_y = apply({"params": params}, (jnp.asarray(y) - _SHIFT) / _SCALE)
    want = 0.0        # the sum of create_lpips_fn's _lpips
    for a, b, w in zip(taps, taps_y, lins):
        a = a * jax.lax.rsqrt(jnp.sum(a * a, -1, keepdims=True) + 1e-10)
        b = b * jax.lax.rsqrt(jnp.sum(b * b, -1, keepdims=True) + 1e-10)
        want = want + jnp.mean(jnp.sum((a - b) ** 2 * w, -1), axis=(1, 2))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=LPIPS_TOL)


def test_vgg16_loader_reads_torchvision_names(tmp_path, monkeypatch):
    from scene_generation_tpu_torch.metrics_lpips import load_torch_vgg16
    vgg = Vgg16Features()
    idx = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
    sd = {f"features.{j}.{leaf}": torch.full_like(
              getattr(vgg, f"conv{i}").weight if leaf == "weight"
              else getattr(vgg, f"conv{i}").bias, float(i))
          for i, j in enumerate(idx) for leaf in ("weight", "bias")}
    path = str(tmp_path / "vgg16-test.pth")
    torch.save(sd, path)
    monkeypatch.setenv("SGT_VGG16_WEIGHTS", path)
    assert load_torch_vgg16(vgg)
    assert float(vgg.conv12.bias[0]) == 12.0


# --- FID ----------------------------------------------------------------------

def test_frechet_distance_and_accumulator_equal_jax():
    rng = np.random.RandomState(0)
    a, b = rng.randn(60, 6), rng.randn(50, 6) * 1.3 + 0.4
    assert frechet_distance(*_stats(a), *_stats(b)) == jax_frechet(
        *jax_stats(a), *jax_stats(b))
    stub = lambda x: np.asarray(x).reshape(len(x), -1)[:, :16]  # noqa: E731
    real = rng.rand(8, 4, 4, 3).astype(np.float32)
    fake = rng.rand(8, 4, 4, 3).astype(np.float32) + 0.5
    port, ref = FIDAccumulator(stub), JaxFID(stub)
    for acc in (port, ref):
        acc.add_real(real[:5])
        acc.add_real(real[5:])
        acc.add_fake(fake)
    assert port.compute() == ref.compute()


@pytest.fixture(scope="module")
def jax_shallow_fn():
    """The JAX package's shallow extractor and the four kernels it drew."""
    import inspect
    fn = jax_shallow()
    return fn, inspect.getclosurevars(fn.__wrapped__).nonlocals["kernels"]


@pytest.mark.parametrize("size", [64, 29])
def test_shallow_extractor_with_jax_kernels_matches_jax(size, jax_shallow_fn):
    """The fallback's four stride-2 'SAME' convs (odd and even sizes)."""
    jax_fn, kernels = jax_shallow_fn
    x = np.random.RandomState(size).uniform(-1, 1, (3, size, size, 3)).astype(
        np.float32)
    fn = create_shallow_features_fn(
        device="cpu", kernels=shallow_kernels_from_jax(kernels))
    _close(fn(x).numpy(), np.asarray(jax_fn(x)), 1e-5, "shallow features")
    own = create_shallow_features_fn(device="cpu")(x)
    assert own.shape == (3, 960) and float(own.std(0).mean()) > 1e-3


# --- PNG ------------------------------------------------------------------------

def _png(img: np.ndarray, filters) -> bytes:
    """An RGB PNG whose row y is written with filter ``filters[y % 5]``
    (PNG spec §9.2), so the decoder meets all five."""
    h, w, c = img.shape
    cur = img.reshape(h, w * c).astype(np.int32)
    rows = []
    for y in range(h):
        kind = filters[y % len(filters)]
        prev = cur[y - 1] if y else np.zeros(w * c, np.int32)
        left = np.concatenate([np.zeros(c, np.int32), cur[y, :-c]])
        upleft = np.concatenate([np.zeros(c, np.int32), prev[:-c]])
        if kind == 0:
            pred = 0
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prev
        elif kind == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = (np.abs(p - left), np.abs(p - prev),
                          np.abs(p - upleft))
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, upleft))
        rows.append(bytes([kind]) + ((cur[y] - pred) & 255).astype(
            np.uint8).tobytes())

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))


def test_decode_png_round_trips_and_equals_pil():
    rng = np.random.RandomState(0)
    img = rng.randint(0, 256, (23, 17, 3)).astype(np.uint8)
    assert np.array_equal(decode_png(encode_png(img)), img)
    data = _png(img, (0, 1, 2, 3, 4))
    assert np.array_equal(decode_png(data), img)
    assert np.array_equal(np.asarray(PIL.Image.open(io.BytesIO(data))), img)
    smooth = np.cumsum(rng.randint(0, 9, (31, 40, 4)), 1).astype(np.uint8)
    for mode, arr in (("RGB", smooth[..., :3]), ("RGBA", smooth),
                      ("L", smooth[..., 0])):
        buf = io.BytesIO()
        PIL.Image.fromarray(arr, mode).save(buf, format="PNG", optimize=True)
        want = np.asarray(PIL.Image.open(io.BytesIO(buf.getvalue())))
        got = decode_png(buf.getvalue())
        assert np.array_equal(got, want.reshape(got.shape)), mode
    with pytest.raises(ValueError):
        decode_png(b"GIF89a")


# --- vis --------------------------------------------------------------------

def test_vis_matches_jax():
    vocab = {"my_idx_to_obj": ["__image__", "cat", "dog"],
             "pred_idx_to_name": ["__in_image__", "left of", "above"]}
    objs, triples = [1, 2, 0], [[0, 1, 1], [1, 2, 0], [0, 0, 2]]
    assert vis.scene_graph_source(vocab, objs, triples) == \
        jax_vis.scene_graph_source(vocab, objs, triples)
    lay = np.random.RandomState(0).rand(2, 5, 6, 4).astype(np.float32)
    assert np.array_equal(vis.one_hot_to_rgb(lay), jax_vis.one_hot_to_rgb(lay))
    assert np.array_equal(vis.one_hot_to_rgb_compact(lay),
                          jax_vis.one_hot_to_rgb(lay))
    boxes = np.array([[0.1, 0.2, 0.5, 0.6], [0.4, 0.4, 0.9, 0.8],
                      [0, 0, 1, 1]], np.float32)
    plain = vis.draw_layout(vocab, objs, boxes, size=64)
    boxed = vis.draw_layout(vocab, objs, boxes, size=64, show_boxes=True)
    assert plain.shape == boxed.shape == (64, 64, 3)
    x0, y0, x1, y1 = (boxes[0] * 63).round().astype(int)
    assert (boxed[y0, x0:x1 + 1] == 255).all()
    assert (boxed[y0:y1 + 1, x1] == 255).all()
    # Outside the outlines the canvas is the plain layout; the __image__
    # box (the whole frame) gets no outline.
    edge = (boxed != plain).any(-1)
    assert not edge[0].any() and edge[y0, x0]
