"""The port's train CLI and tools on a COCO directory, against the JAX
package's, on the CPU at ``tiny_config``. The directory is the port's
``tools/make_fake_coco_dir`` output in PNG (the JAX side reads it through
PIL, the port without).

- ``train.main --coco_dir`` (2 steps) and ``--is_panoptic 1`` (1 step):
  the first step's batch equals the JAX CLI's and its losses equal the JAX
  CLI's (rtol 1e-4, atol 1e-6, the tolerances of
  ``tests/test_torch_train_step.py``; both CLIs' discriminators in f32),
  from the same initial state (the JAX CLI's, numpy-drawn, carried over by
  ``scripts/export_jax_to_torch``) and the same draws;
- ``encode_features --coco_dir`` (instances and panoptic checkpoints):
  each class's features within 1e-5 of the JAX script's;
- ``create_attributes_file --coco_dir``: the JAX script's pickle.
"""
import collections
import dataclasses
import importlib.util
import os
import pickle
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scene_generation_tpu.train as jax_train
from scene_generation_tpu.api import InferenceModel as JaxInferenceModel
from scene_generation_tpu.config import tiny_config as jax_tiny_config
from scene_generation_tpu.models import SceneModel as JaxSceneModel
from scene_generation_tpu.trainer.pools import create_pool as jax_pool
from scene_generation_tpu.trainer.train_state import Modules
from scene_generation_tpu_torch import train as port_train
from scene_generation_tpu_torch.convert import save_checkpoint
from scene_generation_tpu_torch.tools import (create_attributes_file,
                                              encode_features,
                                              make_fake_coco_dir)
from scene_generation_tpu_torch.trainer.step import Draws

from _torch_port import (jax_variables, one_torch_thread,  # noqa: F401
                         port_config, port_model, random_variables,
                         with_model)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _script(relpath: str, name: str):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, relpath))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def coco_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("coco_dir"))
    make_fake_coco_dir.main(["--root", root, "--num_train", "16",
                             "--num_val", "8", "--size", "120,90",
                             "--image_format", "png"])
    return root


def _numpy_state(export, cfg):
    """The JAX CLI's ``create_train_state`` at ``cfg``, its variables drawn
    with numpy at the shapes ``jax.eval_shape`` gives (nothing compiles):
    the modules and the state, whose key PRNGKey(3) draws use_gt = 1."""
    template = export.jax_template(cfg)
    trees = {k: random_variables(getattr(template, k), i)
             for i, k in enumerate(("g_params", "g_stats", "d_img_params",
                                    "d_obj_params", "d_obj_stats",
                                    "d_mask_params"))}
    mods = Modules(cfg)
    opts = {f"opt_{n}": tx.init(trees[f"{n}_params"])
            for n, tx in zip(("g", "d_img", "d_obj", "d_mask"),
                             mods.optimizers())}
    mc = cfg.model
    return mods, template.replace(
        step=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(3),
        pool=jax_pool(mc.num_objs, mc.pool_size, mc.rep_size),
        vgg_params=None, **trees, **opts)


def _jax_draws(state, mc) -> Draws:
    """The JAX step's draws from its state's key (trainer/step.py:55-58)."""
    _, r_noise, r_gt, r_pool = jax.random.split(state.rng, 4)
    return Draws(
        torch.tensor(float(jax.random.bernoulli(r_gt))),
        torch.from_numpy(np.array(jax.random.normal(
            r_noise, (mc.mask_noise_dim,)))),
        torch.from_numpy(np.array(jax.random.randint(
            r_pool, (mc.num_objs,), 0, jnp.maximum(state.pool.counts, 1)))))


def _f32_discriminators(config_from_args):
    def wrapped(a):
        cfg = config_from_args(a)
        return cfg.replace(discriminator=dataclasses.replace(
            cfg.discriminator, compute_dtype="float32"))
    return wrapped


def _batch(batch):
    return tuple(np.asarray(a) for a in batch)


@pytest.mark.parametrize("family,steps", [("instances", 2), ("panoptic", 1)])
def test_train_cli_first_step_equals_the_jax_cli(coco_dir, tmp_path,
                                                 monkeypatch, family, steps):
    common = ["--coco_dir", coco_dir, "--tiny", "--print_every", "1",
              "--checkpoint_every", "100", "--num_val_samples", "4",
              "--is_panoptic", str(int(family == "panoptic"))]
    seen = collections.defaultdict(list)
    export = _script("scripts/export_jax_to_torch.py", "export_jax_to_torch")

    # The JAX CLI: a numpy-drawn initial state (no init to compile), thread
    # workers (the same batches as its process workers, without spawning
    # JAX processes), its real jitted step.
    def jax_state(cfg, rng, batch, load_vgg=True):
        mods, state = _numpy_state(export, cfg)
        seen["state"].append(jax.device_get(state))
        return mods, state

    def jax_step(mods, donate=True):
        step = make_step(mods, donate=False)

        def wrapped(state, batch):
            new, metrics = step(state, batch)
            seen["jax_batches"].append(_batch(batch))
            seen["jax_metrics"].append(jax.device_get(metrics))
            return new, metrics
        return wrapped

    class ThreadLoader(jax_train.DataLoader):
        def __init__(self, *a, **kw):
            super().__init__(*a, **dict(kw, worker_type="thread"))

    # Both CLIs' configs with f32 discriminators, so that the losses
    # compare at f32's tolerance (bf16 would round them to 1e-3).
    for mod in (jax_train, port_train):
        monkeypatch.setattr(mod, "config_from_args",
                            _f32_discriminators(mod.config_from_args))
    make_step = jax_train.make_train_step
    monkeypatch.setattr(jax_train, "create_train_state", jax_state)
    monkeypatch.setattr(jax_train, "make_train_step", jax_step)
    monkeypatch.setattr(jax_train, "DataLoader", ThreadLoader)
    jax_train.main(common + ["--cpu", "--num_iterations", "1",
                             "--output_dir", str(tmp_path / "jax")])
    js, = seen["state"]

    # The port's CLI from that state, with the JAX step's draws first.
    create, step = port_train.create_train_state, port_train.train_step

    def port_state(cfg, device=None, seed=0, load_vgg=True, **kwargs):
        state = create(cfg, device, seed=seed, load_vgg=load_vgg, **kwargs)
        state.load_state_dict(export.convert_state(js, cfg))
        return state

    def port_step(state, batch, draws=None):
        if not seen["port_metrics"]:
            draws = _jax_draws(js, state.cfg.model)
        metrics = step(state, batch, draws)
        seen["port_batches"].append(_batch(batch))
        seen["port_metrics"].append(metrics)
        return metrics

    monkeypatch.setattr(port_train, "create_train_state", port_state)
    monkeypatch.setattr(port_train, "train_step", port_step)
    _, meta = port_train.main(common + [
        "--cpu", "--num_iterations", str(steps),
        "--output_dir", str(tmp_path / "port")])
    assert meta["counters"]["t"] == steps
    assert meta["vocab"]["is_panoptic"] == (family == "panoptic")
    assert len(seen["port_metrics"]) == steps
    for a, b in zip(seen["port_batches"][0], seen["jax_batches"][0]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    want, got = seen["jax_metrics"][0], seen["port_metrics"][0]
    scalars = sorted(k for k in want if not k.startswith("_"))
    assert scalars == sorted(k for k in got if not k.startswith("_"))
    assert float(want["use_gt"]) == 1.0 and float(want["bbox_pred"]) > 0
    for k in scalars:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


@pytest.fixture(scope="module", params=["instances", "panoptic"])
def coco_run(request, coco_dir, tmp_path_factory):
    """A port checkpoint of ``tiny_config`` over the COCO train split's
    classes (numpy-drawn weights) and the JAX variables behind it."""
    panoptic = request.param == "panoptic"
    pcfg = port_train.config_from_args(port_train.parse_args(
        ["--coco_dir", coco_dir, "--tiny"]))
    train, _ = port_train.coco_datasets(pcfg, coco_dir, panoptic)
    vocab = train.vocab
    cfg = with_model(jax_tiny_config(),
                     num_objs=len(vocab["object_to_idx"]))
    variables = jax_variables(cfg)
    d = str(tmp_path_factory.mktemp("coco_run"))
    save_checkpoint(d, port_model(cfg, variables), port_config(cfg), vocab)
    return types.SimpleNamespace(cfg=cfg, variables=variables, dir=d,
                                 vocab=vocab)


def test_encode_features_on_coco_matches_jax(coco_dir, coco_run, tmp_path,
                                             monkeypatch):
    out, jax_out = str(tmp_path / "port"), str(tmp_path / "jax")
    argv = ["--output_dir", coco_run.dir, "--coco_dir", coco_dir,
            "--num_samples", "8", "--batch_size", "4", "--cpu"]
    feats = encode_features.main(argv + ["--save_dir", out])
    state = collections.namedtuple("State", "g_params g_stats")(
        coco_run.variables["params"], coco_run.variables["batch_stats"])

    def from_checkpoint(cls, output_dir, checkpoint_name="checkpoint",
                        best=False, features_path=None):
        return cls(coco_run.cfg, coco_run.vocab,
                   types.SimpleNamespace(model=JaxSceneModel(
                       coco_run.cfg.model)), state, None, None)

    monkeypatch.setattr(JaxInferenceModel, "from_checkpoint",
                        classmethod(from_checkpoint))
    monkeypatch.setattr(sys, "path", [REPO] + sys.path)
    monkeypatch.setattr(sys, "argv", ["script"] + argv
                        + ["--save_dir", jax_out])
    _script("scripts/encode_features.py", "jax_encode_features").main()
    want = np.load(os.path.join(jax_out, "features.npy"),
                   allow_pickle=True).item()
    assert sorted(feats) == sorted(want) and len(want) >= 3
    for c in want:
        scale = max(float(np.abs(want[c]).max()), 1.0)
        np.testing.assert_allclose(feats[c], want[c], atol=1e-5 * scale,
                                   rtol=0, err_msg=f"class {c}")


def test_create_attributes_file_on_coco_matches_jax(coco_dir, tmp_path,
                                                    monkeypatch):
    argv = ["--coco_dir", coco_dir, "--num_samples", "12"]
    got = create_attributes_file.main(
        argv + ["--save_path", str(tmp_path / "port.pickle")])
    monkeypatch.setattr(sys, "argv", ["script"] + argv + [
        "--save_path", str(tmp_path / "jax.pickle")])
    _script("scripts/create_attributes_file.py", "jax_attributes").main()
    with open(tmp_path / "jax.pickle", "rb") as f:
        want = pickle.load(f)
    with open(tmp_path / "port.pickle", "rb") as f:
        assert pickle.load(f) == want == got
    assert len(want["size"]) >= 3
