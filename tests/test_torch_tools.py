"""The port's inference and evaluation tools (``scene_generation_tpu_torch.
tools``) against the JAX package's scripts, on the CPU at ``tiny_config``:
one set of generator weights (drawn with numpy, bridged to the port and
saved as a port checkpoint; the JAX scripts get them through a patched
``InferenceModel.from_checkpoint``), the same synthetic data and the same
mask noise.

- encode_features: each class's features within 1e-5 of JAX's, the k=1
  table within 1e-6 of scikit-learn's (the class means);
- sample_images with that k=1 table and a tiny accuracy net bridged from
  JAX: ``results.json`` within 1e-5, the same files;
- train_accuracy_net from the same variables: every step's loss and
  accuracy, and in f64 the saved net;
- create_attributes_file: the same pickle;
- the GUI: ``json_to_scene_graph`` equal, ``/get_data`` PNGs within one
  grey level of JAX's ``forward_json`` image;
- compute_fid reads PNG directories as the JAX script does (bit-equal
  arrays);
- eval_run end to end, every requested sample generated.
"""
import collections
import importlib.util
import json
import os
import pickle
import subprocess
import sys
import threading
import types
import urllib.parse
import urllib.request
from http.server import HTTPServer

import jax
import numpy as np
import PIL.Image
import pytest
import torch

from scene_generation_tpu.api import InferenceModel as JaxInferenceModel
from scene_generation_tpu.config import tiny_config as jax_tiny_config
from scene_generation_tpu.data.image_utils import deprocess as jax_deprocess
from scene_generation_tpu.data.synthetic import \
    synthetic_vocab as jax_synthetic_vocab
from scene_generation_tpu.models import SceneModel as JaxSceneModel
from scene_generation_tpu.models.resnet import ResNet as JaxResNet
from scene_generation_tpu_torch.convert import (resnet_state_dict_from_jax,
                                                save_checkpoint)
from scene_generation_tpu_torch.data.image_utils import decode_png
from scene_generation_tpu_torch.models.resnet import ResNet
from scene_generation_tpu_torch.tools import (compute_diversity, compute_fid,
                                              create_attributes_file,
                                              encode_features, eval_run,
                                              gui_server, sample_images,
                                              train_accuracy_net)

from _torch_port import (jax_variables, one_torch_thread,  # noqa: F401
                         port_config, port_model, random_variables)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _script(relpath: str, name: str):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, relpath))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """A port checkpoint of ``tiny_config`` with numpy-drawn weights, and
    the JAX variables it was bridged from."""
    cfg = jax_tiny_config()
    variables = jax_variables(cfg)
    d = str(tmp_path_factory.mktemp("port_run"))
    vocab = jax_synthetic_vocab(cfg.model.num_objs)
    save_checkpoint(d, port_model(cfg, variables), port_config(cfg), vocab)
    return types.SimpleNamespace(cfg=cfg, variables=variables, dir=d,
                                 vocab=vocab)


def _port_noise(dim: int):
    """The mask noise the port's InferenceModel draws, call by call."""
    gen = torch.Generator().manual_seed(0)
    while True:
        yield torch.randn(dim, generator=gen).numpy()


@pytest.fixture
def jax_side(run, monkeypatch):
    """The JAX scripts' ``InferenceModel.from_checkpoint`` returns a model
    of ``run``'s variables (the features file read as the JAX api reads
    it), and its mask noise is the port's."""
    cfg = run.cfg
    state = collections.namedtuple("State", "g_params g_stats")(
        run.variables["params"], run.variables["batch_stats"])

    def from_checkpoint(cls, output_dir, checkpoint_name="checkpoint",
                        best=False, features_path=None):
        feats = (np.load(features_path, allow_pickle=True).item()
                 if features_path else None)
        return cls(cfg, run.vocab,
                   types.SimpleNamespace(model=JaxSceneModel(cfg.model)),
                   state, feats, None)

    monkeypatch.setattr(JaxInferenceModel, "from_checkpoint",
                        classmethod(from_checkpoint))
    noise = _port_noise(cfg.model.mask_noise_dim)
    normal = jax.random.normal

    def port_normal(key, shape=(), *a, **kw):
        if tuple(shape) == (cfg.model.mask_noise_dim,):
            return jax.numpy.asarray(next(noise))
        return normal(key, shape, *a, **kw)

    monkeypatch.setattr(jax.random, "normal", port_normal)

    def main(mod, argv):
        monkeypatch.setattr(sys, "argv", ["script"] + argv)
        return mod.main()

    return main


@pytest.fixture(scope="module")
def encoded(run, tmp_path_factory):
    """The port's encode_features over 16 synthetic images."""
    out = str(tmp_path_factory.mktemp("port_features"))
    feats = encode_features.main(
        ["--output_dir", run.dir, "--synthetic", "--num_samples", "16",
         "--batch_size", "8", "--save_dir", out, "--cpu"])
    return out, feats


def test_encode_features_matches_jax(run, encoded, jax_side, tmp_path):
    out, feats = encoded
    jax_out = str(tmp_path)
    jax_side(_script("scripts/encode_features.py", "jax_encode_features"),
             ["--output_dir", run.dir, "--synthetic", "--num_samples", "16",
              "--batch_size", "8", "--save_dir", jax_out, "--cpu"])
    load = lambda d, f: np.load(os.path.join(d, f),  # noqa: E731
                                allow_pickle=True).item()
    want = load(jax_out, "features.npy")
    got = load(out, "features.npy")
    assert sorted(got) == sorted(want) == sorted(feats)
    for c in want:
        # f32 appearance encoder: 1e-5 of the class's scale.
        scale = max(float(np.abs(want[c]).max()), 1.0)
        np.testing.assert_allclose(got[c], want[c], atol=1e-5 * scale,
                                   rtol=0, err_msg=f"class {c}")
    for name, k in (("100", 100), ("010", 10), ("001", 1)):
        table = load(out, f"features_clustered_{name}.npy")
        ref = load(jax_out, f"features_clustered_{name}.npy")
        assert sorted(table) == sorted(ref)
        for c in table:
            assert table[c].dtype == np.float32
            assert table[c].shape == ref[c].shape == (
                min(k, len(got[c])), run.cfg.model.rep_size)
    one, one_ref = (load(out, "features_clustered_001.npy"),
                    load(jax_out, "features_clustered_001.npy"))
    for c in one:
        np.testing.assert_allclose(one[c][0], got[c].mean(0), atol=1e-6)
        np.testing.assert_allclose(one[c], one_ref[c], atol=1e-5)
    # The port's serving API reads the files (k=100, and k=1 beside it).
    from scene_generation_tpu_torch.api import InferenceModel
    m = InferenceModel.from_checkpoint(
        run.dir, features_path=os.path.join(
            out, "features_clustered_100.npy"), device="cpu")
    assert sorted(m.features) == sorted(m.features_one) == sorted(got)


def _accuracy_net(run, tmp_path):
    """A tiny accuracy net (JAX's ResNet (1, 1, 1, 1), numpy-drawn) as the
    JAX variables and as the port's file."""
    net = JaxResNet(stage_sizes=(1, 1, 1, 1),
                    num_classes=run.cfg.model.num_objs)
    shapes = jax.eval_shape(net.init, jax.random.PRNGKey(0),
                            jax.numpy.zeros((1, 32, 32, 3)))
    variables = random_variables(shapes, 5)
    path = str(tmp_path / "acc.pt")
    torch.save({"state_dict": resnet_state_dict_from_jax(variables),
                "stage_sizes": [1, 1, 1, 1],
                "num_classes": run.cfg.model.num_objs, "crop_size": 32},
               path)
    return variables, path


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_train_accuracy_net_matches_jax(monkeypatch, tmp_path, dtype):
    """Both scripts at ``--tiny --synthetic`` (ResNet (1, 1, 1, 1), 32 px
    GT crops) from one set of numpy-drawn variables, bridged to the port:
    every step's masked cross-entropy and accuracy over 4 Adam steps, and
    in f64 (the crops f32, the net and Adam in f64) the saved net,
    parameters and running statistics.

    The saved parameters are compared in f64 only: in f32 most BN biases
    feed another BN's batch statistics, so their gradient is zero in
    exact arithmetic, and Adam turns its rounding noise into steps of
    about ``lr`` whose signs the two packages draw differently (up to
    3.8 ``lr`` apart after 4 steps here). In f64 that noise is far below
    Adam's eps. The f32 run's later losses still hold its updates."""
    import orbax.checkpoint
    wide = dtype == "float64"
    net = JaxResNet(stage_sizes=(1, 1, 1, 1),
                    num_classes=jax_tiny_config().model.num_objs)
    shapes = jax.eval_shape(net.init, jax.random.PRNGKey(0),
                            jax.numpy.zeros((1, 32, 32, 3)))
    variables = random_variables(shapes, 6)
    start = jax.tree.map(lambda x: x.astype(dtype), variables)
    monkeypatch.setattr(JaxResNet, "init", lambda self, *a, **kw: start)

    def bridged(stage_sizes, num_classes):
        port = ResNet(stage_sizes, num_classes)
        port.load_state_dict(resnet_state_dict_from_jax(variables))
        return port.to(getattr(torch, dtype))

    crop = train_accuracy_net.crop_bbox_batch
    monkeypatch.setattr(train_accuracy_net, "ResNet", bridged)
    monkeypatch.setattr(train_accuracy_net, "crop_bbox_batch",
                        lambda *a: crop(*a).to(getattr(torch, dtype)))
    jax_steps, port_steps, saved = [], [], {}
    jit = jax.jit

    def recording_jit(fn, *a, **kw):
        compiled = jit(fn, *a, **kw)
        if getattr(fn, "__name__", "") != "train_step":
            return compiled

        def step(*args):
            out = compiled(*args)
            jax_steps.append((float(out[3]), float(out[4])))
            return out
        return step

    monkeypatch.setattr(jax, "jit", recording_jit)
    monkeypatch.setattr(orbax.checkpoint, "PyTreeCheckpointer",
                        lambda: types.SimpleNamespace(
                            save=lambda path, tree, force: saved.update(tree)))
    port_step = train_accuracy_net.train_step

    def recording_step(*args):
        loss, acc = port_step(*args)
        port_steps.append((float(loss), float(acc)))
        return loss, acc

    monkeypatch.setattr(train_accuracy_net, "train_step", recording_step)
    argv = ["--synthetic", "--tiny", "--synthetic_size", "16",
            "--batch_size", "4"]
    monkeypatch.setattr(sys, "argv", ["script"] + argv + [
        "--save_path", str(tmp_path / "jax_acc")])
    with jax.enable_x64(wide):
        _script("scripts/train_accuracy_net.py", "jax_train_accuracy").main()
    port = train_accuracy_net.main(argv + [
        "--cpu", "--save_path", str(tmp_path / "acc.pt")])
    assert len(port_steps) == len(jax_steps) == 4
    # Losses through 16 convs and batch norms: 1e-5 relative in f32; in
    # f64 1e-6, what the f32 crops (the two packages' roundings) leave
    # after Adam; the accuracies are counts of equal argmaxes.
    tol = 1e-6 if wide else 1e-5
    for (loss, acc), (jloss, jacc) in zip(port_steps, jax_steps):
        assert abs(loss - jloss) <= tol * abs(jloss), (loss, jloss)
        assert abs(acc - jacc) <= 1e-6, (acc, jacc)
    got = torch.load(tmp_path / "acc.pt", weights_only=True)
    assert got["stage_sizes"] == [1, 1, 1, 1] and got["crop_size"] == 32
    for k, v in port.state_dict().items():
        assert torch.equal(got["state_dict"][k], v), k
    if not wide:
        return
    want = resnet_state_dict_from_jax(jax.device_get(saved))
    for k, v in port.state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        # Within 2e-5 of the leaf's scale (at scale 1 a fifth of one
        # Adam step of lr 1e-4), compared after the converter's f32 cast.
        scale = max(float(want[k].abs().max()), 1.0)
        d = float((v.float() - want[k]).abs().max())
        assert d <= 2e-5 * scale, (k, d)


@pytest.mark.parametrize("mode", [["--use_gt_attr", "1", "--use_gt_boxes",
                                   "1"], []], ids=["gtattr_boxes", "sg"])
def test_sample_images_matches_jax(run, encoded, jax_side, tmp_path,
                                   monkeypatch, mode):
    """The k=1 table (the sampling protocol's) and a tiny bridged accuracy
    net: the same results.json within 1e-5, the same files, the same GT
    images."""
    import orbax.checkpoint
    variables, acc_path = _accuracy_net(run, tmp_path)
    monkeypatch.setattr(orbax.checkpoint, "PyTreeCheckpointer",
                        lambda: types.SimpleNamespace(
                            restore=lambda path: variables))
    feats = os.path.join(encoded[0], "features_clustered_001.npy")
    common = ["--output_dir", run.dir, "--features_path", feats,
              "--synthetic", "--num_samples", "16", "--batch_size", "8",
              "--accuracy_model_path", acc_path, "--accuracy_tiny", "1",
              "--save_graphs", "1", "--cpu"] + mode
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_side(_script("scripts/sample_images.py", "jax_sample_images"),
             common + ["--save_dir", jdir])
    got = sample_images.main(common + ["--save_dir", pdir])
    with open(os.path.join(jdir, "results.json")) as f:
        want = json.load(f)
    with open(os.path.join(pdir, "results.json")) as f:
        assert json.load(f) == got
    assert sorted(got) == sorted(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-5, (k, got[k], want[k])
    assert got["num_images"] == 16 and 0 < got["object_accuracy"] < 1
    assert sorted(os.listdir(pdir)) == sorted(os.listdir(jdir))
    for i in (0, 15):
        stem = f"img{i:06d}_gt.png"
        with open(os.path.join(pdir, stem), "rb") as f:
            img = decode_png(f.read())
        assert np.array_equal(img, np.asarray(PIL.Image.open(
            os.path.join(jdir, stem))))


def test_create_attributes_file_matches_jax(jax_side, tmp_path):
    argv = ["--synthetic", "--num_samples", "24"]
    jax_side(_script("scripts/create_attributes_file.py", "jax_attributes"),
             argv + ["--save_path", str(tmp_path / "jax.pickle")])
    got = create_attributes_file.main(
        argv + ["--save_path", str(tmp_path / "port.pickle")])
    with open(tmp_path / "jax.pickle", "rb") as f:
        want = pickle.load(f)
    with open(tmp_path / "port.pickle", "rb") as f:
        assert pickle.load(f) == got == want
    assert len(want["size"]) > 5


def _scene(objs):
    return json.dumps({"image_id": 3, "objects": [
        dict(text=t, left=l, top=tp, width=w, height=h, size=s, location=lc,
             feature=ft)
        for t, l, tp, w, h, s, lc, ft in objs]})


SCENES = [
    _scene([("class_1", 0.1, 0.1, 0.3, 0.3, 2, 6, -1),
            ("class_2", 0.5, 0.4, 0.4, 0.5, 5, 18, 0),
            ("class_3", 0.05, 0.7, 0.2, 0.2, 1, 20, -1)]),
    # Nested boxes: "surrounding" and "inside" by the margin rule.
    _scene([("class_4", 0.0, 0.0, 1.0, 1.0, 9, 12, -1),
            ("class_5", 0.4, 0.4, 0.1, 0.1, 0, 12, -1),
            ("class_6", 0.3, 0.3, 0.4, 0.4, 6, 12, 1),
            ("class_1", 0.6, 0.1, 0.3, 0.2, 3, 4, -1)]),
    _scene([("class_2", 0.2, 0.2, 0.2, 0.2, 4, 12, -1)]),
    json.dumps({}),
]


def test_json_to_scene_graph_matches_jax():
    ref = _script("scripts/gui/server.py", "jax_gui_server")
    for scene in SCENES:
        assert gui_server.json_to_scene_graph(scene) == \
            ref.json_to_scene_graph(scene)
    preds = {r[1] for s in SCENES[:2]
             for r in gui_server.json_to_scene_graph(s)[0]["relationships"]}
    assert {"surrounding", "inside"} <= preds


def test_gui_get_data_matches_jax_forward_json(run, encoded, jax_side,
                                               tmp_path):
    """``GET /`` serves the repo's index.html; ``GET /get_data`` one scene
    at batch 1, whose PNG (fetched back over HTTP) is the JAX
    ``forward_json`` image within one grey level."""
    feats = os.path.join(encoded[0], "features_clustered_100.npy")
    backend = gui_server.GuiBackend(run.dir, features_path=feats,
                                    images_dir=str(tmp_path), device="cpu")
    httpd = HTTPServer(("127.0.0.1", 0), gui_server.make_handler(backend))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    get = lambda p: urllib.request.urlopen(base + p,  # noqa: E731
                                           timeout=60).read()
    try:
        with open(os.path.join(gui_server.GUI_DIR, "index.html"), "rb") as f:
            assert get("/") == f.read()
        assert "class_1" in json.loads(get("/vocab"))["objects"]
        resp = json.loads(get("/get_data?data=" + urllib.parse.quote(
            SCENES[0])))
        img = decode_png(get("/" + resp["img_pred"]))
        layout = decode_png(get("/" + resp["img_layout"]))
        assert layout.shape == (256, 256, 3) and (layout == 255).any()
        with pytest.raises(urllib.error.HTTPError) as e:
            get("/get_data?data=" + urllib.parse.quote("{bad"))
        assert e.value.code == 500
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()

    ref = JaxInferenceModel.from_checkpoint(run.dir, features_path=feats)
    ref.features_one = np.load(feats.replace("_100", "_001"),
                               allow_pickle=True).item()
    out, _ = ref.forward_json(gui_server.json_to_scene_graph(SCENES[0]))
    want = jax_deprocess(np.asarray(out.imgs_pred[0]))
    assert img.shape == want.shape
    assert int(np.abs(img.astype(int) - want).max()) <= 1


def test_compute_fid_reads_pngs_as_jax(tmp_path):
    ref = _script("scripts/compute_fid.py", "jax_compute_fid")
    rng = np.random.RandomState(0)
    for i in range(3):
        img = np.cumsum(rng.randint(0, 5, (40, 48, 3)), 1).astype(np.uint8)
        # PIL picks its own row filters: the decoder meets them all.
        PIL.Image.fromarray(img).save(tmp_path / f"a{i}.png", optimize=True)
    got = list(compute_fid.iter_image_batches(str(tmp_path), 2))
    want = list(ref.iter_image_batches(str(tmp_path), 2))
    assert [g.shape for g in got] == [w.shape for w in want] == [
        (2, 299, 299, 3), (1, 299, 299, 3)]
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


def test_eval_run_end_to_end(run, tmp_path, capsys):
    """Every stage on the CPU; 6 samples at stage batch 4 and 3 diversity
    pairs: every requested sample is generated (the last batch partial)."""
    acc = str(tmp_path / "acc.pt")
    train_accuracy_net.main(["--synthetic", "--tiny", "--cpu",
                             "--synthetic_size", "8", "--batch_size", "4",
                             "--save_path", acc])
    out = str(tmp_path / "eval")
    argv = ["--output_dir", run.dir, "--save_root", out, "--synthetic",
            "--cpu", "--num_samples", "6", "--encode_samples", "8",
            "--diversity_samples", "3", "--stage_batch_size", "4",
            "--accuracy_model_path", acc]
    summary = eval_run.main(argv)
    assert sorted(summary) == sorted(
        ["object_accuracy", "samples_gtlayout", "samples_gtattr",
         "samples_sg", "fid_gtlayout", "fid_sg", "diversity"])
    assert all(summary[f"samples_{m}"]["num_images"] == 6
               for m in ("gtlayout", "gtattr", "sg"))
    assert summary["fid_sg"]["n_fake"] == summary["fid_sg"]["n_real"] == 6
    assert summary["diversity"]["n"] == 3
    assert not summary["diversity"]["pretrained"]
    for f in ("features_clustered_010.npy", "grid_sg.png",
              "eval_summary.json"):
        assert os.path.exists(os.path.join(out, f)), f
    capsys.readouterr()
    # Done stages are skipped.
    assert eval_run.main(argv) == summary
    assert "+ encode_features" not in capsys.readouterr().out


@pytest.mark.parametrize("tool", [encode_features, sample_images,
                                  train_accuracy_net, create_attributes_file,
                                  compute_diversity])
def test_tools_read_coco_dir(tool, run):
    """The readers are ported: without ``--synthetic`` each tool reads
    ``--coco_dir`` (here the default, which does not exist) and raises
    the dataset's error (tests/test_torch_coco_cli.py runs them on one)."""
    argv = ["--output_dir", run.dir, "--cpu"] if tool not in (
        train_accuracy_net, create_attributes_file) else []
    with pytest.raises(FileNotFoundError, match="datasets/coco/annotations"):
        tool.main(argv)


def test_python_m_entry_point(tmp_path):
    path = str(tmp_path / "attrs.pickle")
    proc = subprocess.run(
        [sys.executable, "-m",
         "scene_generation_tpu_torch.tools.create_attributes_file",
         "--synthetic", "--num_samples", "4", "--save_path", path],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    with open(path, "rb") as f:
        assert set(pickle.load(f)) == {"size", "location"}
