"""The port's serving surface on the CPU: checkpoint round trip,
``InferenceModel.forward_json`` and an in-process HTTP /generate with the
response schema of the JAX package's serve.py, the device rule of the
entry points, the port's import isolation from JAX, and its numpy copies
of the JAX package's data code."""
import base64
import json
import os
import subprocess
import sys
import threading
import urllib.request
import zlib
from http.server import HTTPServer

import numpy as np
import pytest
import torch

from scene_generation_tpu.config import test_config as jax_small_config
from scene_generation_tpu.config import tiny_config as jax_tiny_config
from scene_generation_tpu.data import synthetic_batch as jax_synthetic_batch
from scene_generation_tpu.data.image_utils import deprocess as jax_deprocess
from scene_generation_tpu_torch import resolve_device
from scene_generation_tpu_torch.api import InferenceModel
from scene_generation_tpu_torch.config import test_config as port_small_config
from scene_generation_tpu_torch.convert import (load_checkpoint,
                                                save_checkpoint)
from scene_generation_tpu_torch.data import synthetic_batch, synthetic_vocab
from scene_generation_tpu_torch.data.image_utils import (deprocess,
                                                         encode_png)
from scene_generation_tpu_torch.entry import build_model
from scene_generation_tpu_torch.serve import Server, make_handler

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCENE = {"objects": ["class_1", "class_2", "class_3"],
         "relationships": [[0, "left of", 1], [1, "above", 2]],
         "attributes": {"size": [4, 5, 3], "location": [6, 12, 18]},
         "features": [-1, -1, -1], "image_id": 0}


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("port_ckpt"))
    cfg = port_small_config()
    model = build_model(cfg, "cpu", seed=0)
    save_checkpoint(d, model, cfg, synthetic_vocab(cfg.model.num_objs))
    return d


def test_checkpoint_round_trips(ckpt_dir):
    cfg, vocab, model = load_checkpoint(ckpt_dir, "cpu")
    assert cfg == port_small_config()
    assert vocab["object_idx_to_name"] == synthetic_vocab(
        cfg.model.num_objs)["object_idx_to_name"]
    want = build_model(cfg, "cpu", seed=0).state_dict()
    got = model.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert not model.training


def _check_schema(resp, n_objects):
    assert set(resp) == {"images", "layouts", "boxes_pred"}
    for b64 in resp["images"] + resp["layouts"]:
        assert base64.b64decode(b64)[:8] == b"\x89PNG\r\n\x1a\n"
    assert len(resp["boxes_pred"][0]) == n_objects + 1   # + __image__
    assert all(len(b) == 4 for b in resp["boxes_pred"][0])


def test_forward_json(ckpt_dir):
    model = InferenceModel.from_checkpoint(ckpt_dir, device="cpu")
    out, batch = model.forward_json(SCENE)
    h, w = model.cfg.model.image_size
    assert out.imgs_pred.shape == (1, h, w, 3)
    assert torch.isfinite(out.imgs_pred).all()
    assert int(batch.obj_mask[0].sum()) == 4
    _check_schema(Server(ckpt_dir, device="cpu").generate(
        {"scene_graphs": [SCENE]}), 3)


def test_http_generate_vocab_healthz(ckpt_dir):
    srv = Server(ckpt_dir, device="cpu")
    httpd = HTTPServer(("127.0.0.1", 0), make_handler(srv))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        health = json.loads(urllib.request.urlopen(base + "/healthz",
                                                   timeout=30).read())
        assert health == {"status": "ok", "device": "cpu",
                          "num_classes": port_small_config().model.num_objs}
        vocab = json.loads(urllib.request.urlopen(base + "/vocab",
                                                  timeout=30).read())
        assert "class_1" in vocab["objects"] and "__image__" not in \
            vocab["objects"]
        payload = json.dumps({"scene_graphs": [SCENE, SCENE]}).encode()
        req = urllib.request.Request(
            base + "/generate", data=payload,
            headers={"Content-Type": "application/json"})
        resp = json.loads(urllib.request.urlopen(req, timeout=300).read())
        _check_schema(resp, 3)
        assert len(resp["images"]) == 2
        bad = urllib.request.Request(base + "/generate", data=b"{not json")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(bad, timeout=30)
        assert e.value.code == 500
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()


def test_entry_points_without_a_device_or_cuda_raise(ckpt_dir, monkeypatch):
    from scene_generation_tpu_torch.entry import entry
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceModel.from_checkpoint(ckpt_dir)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Server(ckpt_dir)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()
    assert resolve_device("cpu") == torch.device("cpu")


def test_port_imports_no_jax():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.path.insert(0, sys.argv[1])\n"
        "import scene_generation_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'flax' or m.startswith('scene_generation_tpu.')\n"
        "       or m == 'scene_generation_tpu']\n"
        "print(len(sys.modules)); assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code, REPO], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("cfg", [jax_small_config, jax_tiny_config])
def test_synthetic_batches_are_bit_identical(cfg):
    from scene_generation_tpu_torch.config import Config
    pcfg = Config.from_json(cfg().to_json())
    for seed in (0, 7):
        want = jax_synthetic_batch(cfg(), seed=seed, batch_size=3)
        got = synthetic_batch(pcfg, seed=seed, batch_size=3)
        for field in want._fields:
            a, b = getattr(got, field), getattr(want, field)
            assert a.dtype == b.dtype and np.array_equal(a, b), field


def test_deprocess_matches_jax_and_png_decodes():
    img = np.random.RandomState(0).uniform(-1, 1, (5, 7, 3)).astype(
        np.float32)
    for rescale in (True, False):
        got = deprocess(img, rescale=rescale)
        assert np.array_equal(got, jax_deprocess(img, rescale=rescale))
    png = encode_png(got)
    idat = png[png.index(b"IDAT") + 4:png.index(b"IEND") - 8]
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(5, 22)
    assert np.array_equal(rows[:, 1:].reshape(5, 7, 3), got)


def test_scene_graph_encoding_and_cluster_features_match_jax(ckpt_dir):
    """The numpy JSON -> batch logic and the cluster-feature draw, against
    the JAX package's InferenceModel on the same vocab and feature table."""
    from scene_generation_tpu.api import InferenceModel as JaxInferenceModel
    model = InferenceModel.from_checkpoint(ckpt_dir, device="cpu")
    rep = model.cfg.model.rep_size
    rng = np.random.RandomState(0)
    table = {1: rng.randn(3, rep).astype(np.float32),
             2: rng.randn(1, rep).astype(np.float32),
             0: rng.randn(2, rep).astype(np.float32)}
    model.features = table
    jax_model = JaxInferenceModel.__new__(JaxInferenceModel)
    jax_model.cfg, jax_model.vocab = jax_small_config(), model.vocab
    jax_model.features, jax_model.features_one = table, None
    graphs = [dict(SCENE, features=[-1, 2, 0]),
              {"objects": ["class_3"], "image_id": 1}]
    got = model.encode_scene_graphs(graphs)
    want = jax_model.encode_scene_graphs(graphs)
    for a, b in zip(got[0], want[0]):
        assert np.array_equal(a, b)
    for a, b in zip(got[1:], want[1:]):
        assert np.array_equal(a, b)
    batch = got[0]
    feats = model.sample_cluster_features(batch.objs, batch.obj_mask,
                                          np.random.RandomState(4))
    ref = jax_model.sample_cluster_features(batch.objs, batch.obj_mask,
                                            np.random.RandomState(4))
    for a, b in zip(feats, ref):
        assert np.array_equal(a, b)
    assert feats[1].sum() > 0


# The tolerances of the test-mode forward's parity
# (tests/test_torch_model.py): f32, 1e-5 on boxes, masks and appearance
# vectors (a few layers of f32 products), 2e-4 on images (a deep generator
# of convs and instance norms).
GT_APPEARANCE_TOL = {"imgs_pred": 2e-4, "boxes_pred": 1e-5,
                     "masks_pred": 1e-5, "obj_repr": 1e-5}


@pytest.mark.parametrize("factored", [True, False],
                         ids=["factored", "dense"])
def test_forward_batch_gt_appearance_matches_jax(factored, monkeypatch):
    """``forward_batch(features=None)``: every object's appearance encoded
    from its crop of the batch's images (``sample_images.py
    --use_gt_textures``), against the JAX package's InferenceModel with
    the same weights, batch and mask noise, GT boxes and GT masks of
    0.1 / 0.9 (away from the test-mode claim's 0.5 step)."""
    import collections
    import types
    import jax
    from scene_generation_tpu.api import InferenceModel as JaxInferenceModel
    from scene_generation_tpu.models import SceneModel as JaxSceneModel
    from scene_generation_tpu_torch.ops.layout import _sample_masks
    from _torch_port import (away_from_half, jax_variables, port_config,
                             port_model, with_model)

    cfg = with_model(jax_small_config(), factored_stem=factored,
                     test_compositor_backend="xla")
    variables = jax_variables(cfg)
    mc = cfg.model
    batch = jax_synthetic_batch(cfg, seed=2, batch_size=2)
    n, o = batch.objs.shape
    batch = batch._replace(masks=away_from_half(
        np.random.RandomState(3), (n, o, mc.mask_size, mc.mask_size)))
    sampled = _sample_masks(torch.from_numpy(batch.boxes),
                            torch.from_numpy(batch.masks), *mc.image_size)
    valid = torch.from_numpy(batch.obj_mask).bool()
    assert float((sampled[valid] - 0.5).abs().min()) > 1e-5

    port = InferenceModel(port_config(cfg), {}, port_model(cfg, variables))
    noise = torch.randn(mc.mask_noise_dim,
                        generator=torch.Generator().manual_seed(5))
    got = port.forward_batch(batch, use_gt_boxes=True, use_gt_masks=True,
                             generator=torch.Generator().manual_seed(5))

    ref = JaxInferenceModel.__new__(JaxInferenceModel)
    ref.cfg, ref.vocab, ref._fwd_cache = cfg, {}, {}
    ref.mods = types.SimpleNamespace(model=JaxSceneModel(mc))
    # Only the generator's variables are read; a namedtuple is a pytree.
    state = collections.namedtuple("State", "g_params g_stats")
    ref.state = state(variables["params"], variables["batch_stats"])
    # The same noise on both sides: the JAX draw returns the port's.
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape: jax.numpy.asarray(noise.numpy()))
    want = ref.forward_batch(batch, use_gt_boxes=True, use_gt_masks=True,
                             rng=jax.random.PRNGKey(0))
    for field, tol in GT_APPEARANCE_TOL.items():
        a = getattr(got, field).numpy()
        b = np.asarray(getattr(want, field))
        assert a.shape == b.shape, field
        np.testing.assert_allclose(a, b, atol=tol, rtol=0, err_msg=field)
    # The appearance came from the crops: another image gives another one.
    other = port.forward_batch(batch._replace(imgs=batch.imgs[::-1].copy()),
                               use_gt_boxes=True, use_gt_masks=True,
                               generator=torch.Generator().manual_seed(5))
    assert not torch.equal(other.obj_repr, got.obj_repr)
