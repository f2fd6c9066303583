"""The paper's own checkpoint in the port (``convert_reference.py`` and
``tools/port_reference_checkpoint.py``) against the JAX package's
reference converter, at ``test_config`` with the reference-parity bits
(``torch_deconv``, one-hot layout channels, the ReLU box head) on the CPU.

A reference-format checkpoint is written from a seed
(``tests/_reference_checkpoint.py``); the JAX package's strict converter
accepting it proves its key set. Then: the port's converters give bitwise
the tensors of ``state_dict_from_jax`` of the JAX converters' output, for
the generator and the three discriminators; the port's test-mode and
train-mode forwards on the converted weights equal the JAX forwards on one
seeded batch (``test_torch_model.py``'s and ``test_torch_model_train.py``'s
tolerances: 2e-4 on images, 1e-5 on the rest); the converter refuses a
missing key, an extra key and ``torch_deconv=False``; and the tool's
checkpoint serves (``InferenceModel``) and resumes one train step
(``train --restore_from_checkpoint 1``).
"""
import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scene_generation_tpu import convert as jax_convert
from scene_generation_tpu.config import test_config as jax_small_config
from scene_generation_tpu.models import SceneModel as JaxSceneModel
from scene_generation_tpu_torch import convert_reference
from scene_generation_tpu_torch import train as train_cli
from scene_generation_tpu_torch.api import InferenceModel
from scene_generation_tpu_torch.convert import (d_img_state_dict_from_jax,
                                                d_mask_state_dict_from_jax,
                                                d_obj_state_dict_from_jax,
                                                state_dict_from_jax)
from scene_generation_tpu_torch.data import synthetic_batch, synthetic_vocab
from scene_generation_tpu_torch.models import SceneModel
from scene_generation_tpu_torch.tools import port_reference_checkpoint
from scene_generation_tpu_torch.trainer.checkpoint import CheckpointManager

from _reference_checkpoint import reference_checkpoint, reference_state_dicts
from _torch_port import away_from_half, jax_test_forward, port_config
from _torch_port import one_torch_thread, with_model  # noqa: F401

IMAGE_TOL = 2e-4
OTHER_TOL = 1e-5


@pytest.fixture(scope="module")
def parity():
    """The reference-parity config (JAX and port) and its seeded
    reference state dicts."""
    jcfg = with_model(jax_small_config(), torch_deconv=True,
                      layout_embed_dim=0, box_net_final="relu",
                      test_compositor_backend="xla")
    pcfg = port_config(jcfg)
    return jcfg, pcfg, reference_state_dicts(pcfg, seed=4)


def _jax_d_variables(name, sd, dc):
    if name == "d_obj":
        return jax_convert.convert_reference_d_obj(
            sd, arch=dc.d_obj_arch, normalization=dc.d_normalization)
    if name == "d_img":
        return jax_convert.convert_reference_multiscale_d(
            sd, num_d=dc.num_d, n_layers=dc.n_layers_d)
    return jax_convert.convert_reference_multiscale_d(
        sd, num_d=dc.num_d_mask, n_layers=dc.n_layers_d_mask)


def _via_jax(name, sd, jcfg, pcfg):
    """The state dict the JAX converter and ``state_dict_from_jax`` (or its
    discriminator siblings) give."""
    dc = pcfg.discriminator
    if name == "g":
        return state_dict_from_jax(
            jax_convert.convert_reference_state_dict(sd, jcfg.model),
            pcfg.model)
    v = _jax_d_variables(name, sd, dc)
    if name == "d_obj":
        return d_obj_state_dict_from_jax(v, dc)
    if name == "d_img":
        return d_img_state_dict_from_jax(v["params"], dc)
    return d_mask_state_dict_from_jax(v["params"], dc)


def _via_port(name, sd, pcfg):
    dc = pcfg.discriminator
    if name == "g":
        return convert_reference.convert_reference_state_dict(sd, pcfg.model)
    if name == "d_obj":
        return convert_reference.convert_reference_d_obj(
            sd, arch=dc.d_obj_arch, normalization=dc.d_normalization)
    n_layers = dc.n_layers_d if name == "d_img" else dc.n_layers_d_mask
    num_d = dc.num_d if name == "d_img" else dc.num_d_mask
    return convert_reference.convert_reference_multiscale_d(
        sd, num_d=num_d, n_layers=n_layers, mask=name == "d_mask")


STATES = {"g": "model_state", "d_obj": "d_obj_state", "d_img": "d_img_state",
          "d_mask": "d_mask_state"}


@pytest.mark.parametrize("name", list(STATES))
def test_converter_equals_the_jax_converters_bitwise(parity, name):
    jcfg, pcfg, ref = parity
    sd = ref[STATES[name]]
    # The JAX converter is strict: it accepting the written state dict
    # proves the reference key set.
    want = _via_jax(name, sd, jcfg, pcfg)
    got = _via_port(name, sd, pcfg)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == torch.float32, k
        assert torch.equal(got[k], want[k]), k
    # ... and the result loads strictly into the port's module.
    from scene_generation_tpu_torch.trainer.train_state import build_modules
    modules = dict(zip(("g", "d_img", "d_obj", "d_mask"),
                       build_modules(pcfg)[:4]))
    modules[name].load_state_dict(got, strict=True)
    # batch norm's scale is the offset from 1; num_batches_tracked is
    # dropped.
    if name == "g":
        np.testing.assert_array_equal(
            got["mask_net.bns.0.scale"].numpy(),
            (sd["mask_net.2.weight"] - 1.0).numpy())
    assert any(k.endswith("num_batches_tracked") for k in sd) == (
        name in ("g", "d_obj"))


def _inputs(cfg, seed=1):
    batch = synthetic_batch(cfg, seed=seed, batch_size=2)
    rng = np.random.RandomState(seed)
    n, o = batch.objs.shape
    mc = cfg.model
    return dict(
        objs=batch.objs, triples=batch.triples, attributes=batch.attributes,
        obj_mask=batch.obj_mask, triple_mask=batch.triple_mask,
        mask_noise=rng.randn(mc.mask_noise_dim).astype(np.float32),
        boxes_gt=batch.boxes,
        masks_gt=away_from_half(rng, (n, o, mc.mask_size, mc.mask_size)),
        imgs=batch.imgs,
        wrong_rep=rng.randn(n, o, mc.rep_size).astype(np.float32),
        features=rng.randn(n, o, mc.rep_size).astype(np.float32),
        features_mask=(rng.rand(n, o) > 0.5).astype(np.float32))


TRAIN_ONLY, TEST_ONLY = ("imgs", "wrong_rep"), ("features", "features_mask")


@pytest.mark.parametrize("mode", ["test", "train"])
def test_forward_on_converted_weights_equals_jax(parity, mode):
    jcfg, pcfg, ref = parity
    variables = jax_convert.convert_reference_state_dict(
        ref["model_state"], jcfg.model)
    model = SceneModel(pcfg.model)
    model.load_state_dict(convert_reference.convert_reference_state_dict(
        ref["model_state"], pcfg.model), strict=True)
    inputs = _inputs(pcfg)
    kw = {k: torch.from_numpy(np.asarray(v)) for k, v in inputs.items()}
    if mode == "test":
        want = jax_test_forward(jcfg, variables, {
            k: v for k, v in inputs.items() if k not in TRAIN_ONLY})
        with torch.no_grad():
            got = model.eval()(**{k: v for k, v in kw.items()
                                  if k not in TRAIN_ONLY}, use_gt_box=True)
        fields = ("imgs_pred", "boxes_pred", "masks_pred", "obj_repr")
    else:
        jkw = {k: jnp.asarray(v) for k, v in inputs.items()
               if k not in TEST_ONLY}
        args = [jkw.pop(k) for k in ("objs", "triples", "attributes",
                                     "obj_mask", "triple_mask", "mask_noise")]
        want, _ = jax.jit(functools.partial(
            JaxSceneModel(jcfg.model).apply, train=True,
            mutable=["batch_stats"]))(variables, *args, **jkw)
        got = model.train()(**{k: v for k, v in kw.items()
                               if k not in TEST_ONLY})
        fields = ("imgs_pred", "layout", "layout_pred", "layout_wrong",
                  "obj_repr", "boxes_pred", "masks_pred")
    for field in fields:
        a = getattr(got, field).detach().numpy()
        b = np.asarray(getattr(want, field))
        assert a.shape == b.shape, field
        tol = IMAGE_TOL if field == "imgs_pred" else OTHER_TOL
        np.testing.assert_allclose(a, b, atol=tol, rtol=OTHER_TOL,
                                   err_msg=field)
    assert float(np.asarray(want.imgs_pred).std()) > 1e-3


@pytest.mark.parametrize("fault", ["missing", "extra", "same_deconv",
                                   "layout_embed"])
def test_converter_is_strict(parity, fault):
    _, pcfg, ref = parity
    sd = dict(ref["model_state"])
    mc = pcfg.model
    if fault == "missing":
        del sd["layout_to_image.model.1.weight"]
        err, match = KeyError, "layout_to_image.model.1.weight"
    elif fault == "extra":
        sd["layout_to_image.model.99.weight"] = torch.zeros(1)
        err, match = ValueError, "layout_to_image.model.99.weight"
    elif fault == "same_deconv":
        mc = dataclasses.replace(mc, torch_deconv=False)
        err, match = ValueError, "torch_deconv=True"
    else:
        mc = dataclasses.replace(mc, layout_embed_dim=8)
        err, match = ValueError, "layout_embed_dim=0"
    with pytest.raises(err, match=match):
        convert_reference.convert_reference_state_dict(sd, mc)
    if fault in ("missing", "extra"):
        d_sd = dict(ref["d_img_state"])
        if fault == "missing":
            del d_sd["scale0_layer0.0.weight"]
        else:
            d_sd["scale0_layer9.0.weight"] = torch.zeros(1)
        dc = pcfg.discriminator
        with pytest.raises(err):
            convert_reference.convert_reference_multiscale_d(
                d_sd, dc.num_d, dc.n_layers_d)


# The reference's args for a small model the train CLI can build from its
# flags: the widths the CLI has no flag for stay at the reference's
# defaults (ngf 64 and 9 resblocks are fixed in the reference).
ROUND_TRIP_ARGS = {"image_size": (32, 32), "mask_size": 16,
                   "gconv_num_layers": 1, "n_downsample_global": 1,
                   "use_attributes": True, "batch_size": 2}


def test_tool_round_trip_serves_and_resumes(tmp_path, one_torch_thread):
    vocab = synthetic_vocab(172)
    cfg = convert_reference.config_from_reference_args(
        ROUND_TRIP_ARGS, vocab, "float32")
    assert cfg.model.torch_deconv and cfg.model.box_net_final == "relu"
    ckpt = reference_checkpoint(cfg, ROUND_TRIP_ARGS, vocab, seed=9,
                                counters={"t": 5, "epoch": 1})
    pt = str(tmp_path / "checkpoint_with_model.pt")
    torch.save(ckpt, pt)
    out = str(tmp_path / "ported")
    meta = port_reference_checkpoint.main([
        "--torch_checkpoint", pt, "--output_dir", out,
        "--compute_dtype", "float32", "--cpu"])
    assert meta["counters"] == {"t": 5, "epoch": 1}
    assert meta["ported_from"] == os.path.abspath(pt)

    # Serving reads the converted generator bitwise.
    model = InferenceModel.from_checkpoint(out, device="cpu")
    want = convert_reference.convert_reference_state_dict(
        ckpt["model_state"], cfg.model)
    for k, v in model.model.state_dict().items():
        assert torch.equal(v, want[k]), k
    batch = synthetic_batch(model.cfg, seed=3, batch_size=2)
    imgs = model.forward_batch(batch, use_gt_boxes=True).imgs_pred
    assert imgs.shape == (2, 32, 32, 3) and torch.isfinite(imgs).all()

    # The discriminators are the reference's.
    state = torch.load(os.path.join(out, "checkpoint", "last", "state.pt"),
                       weights_only=True)
    d_img = convert_reference.convert_reference_multiscale_d(
        ckpt["d_img_state"], cfg.discriminator.num_d,
        cfg.discriminator.n_layers_d)
    assert all(torch.equal(state["d_img"][k], v) for k, v in d_img.items())
    assert state["gen"] is None and state["opt_g"]["count"] == 0

    # One resumed step with the train CLI's flags for the same model.
    argv = ["--synthetic", "--synthetic_size", "16", "--cpu",
            "--image_size", "32,32", "--mask_size", "16",
            "--gconv_num_layers", "1", "--n_downsample_global", "1",
            "--torch_deconv", "1", "--batch_size", "2",
            "--num_iterations", "6", "--print_every", "1",
            "--checkpoint_every", "100", "--num_val_samples", "2",
            "--output_dir", out, "--restore_from_checkpoint", "1"]
    state, meta = train_cli.main(argv)
    assert meta["counters"]["t"] == 6 and state.step == 1
    assert len(meta["losses_ts"]) == 1
    assert all(np.isfinite(v[-1]) for v in meta["losses"].values())
    saved = CheckpointManager(out, use_async=False).load_meta()
    assert saved["counters"]["t"] == 6
    assert json.loads(json.dumps(saved["config"]))["model"]["torch_deconv"]
