"""``scripts/export_jax_to_torch.py``: a JAX train checkpoint into the
port's layout, on the CPU.

A tiny JAX ``TrainState`` (``tiny_config`` with bf16 Adam mu; variables
drawn with numpy at the shapes ``jax.eval_shape`` gives), its four
optimizers stepped once by ``optax`` on random gradients (one jitted
update), its pool filled, is saved with the JAX package's
``CheckpointManager`` and exported. Then:

- the exported moments (in their stored dtypes), counts, pool, step and
  counters equal the JAX ones exactly;
- the port's ``InferenceModel.from_checkpoint`` serves the same images,
  boxes and masks as the JAX ``InferenceModel``'s forward on the restored
  JAX variables, for the same batch and mask noise (2e-4 on images, 1e-5
  on boxes and masks, the tolerances of ``tests/test_torch_serving.py``);
- the port's train CLI resumes from the export and steps on.
"""
import collections
import dataclasses
import importlib.util
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scene_generation_tpu.api import InferenceModel as JaxInferenceModel
from scene_generation_tpu.config import tiny_config as jax_tiny_config
from scene_generation_tpu.data import synthetic_batch
from scene_generation_tpu.data.synthetic import synthetic_vocab
from scene_generation_tpu.models import SceneModel as JaxSceneModel
from scene_generation_tpu.trainer.checkpoint import \
    CheckpointManager as JaxCheckpointManager
from scene_generation_tpu.trainer.train_state import Modules
from scene_generation_tpu_torch import train as port_train
from scene_generation_tpu_torch.api import InferenceModel
from scene_generation_tpu_torch.convert import (d_img_state_dict_from_jax,
                                                d_mask_state_dict_from_jax,
                                                d_obj_state_dict_from_jax,
                                                state_dict_from_jax)
from scene_generation_tpu_torch.trainer.checkpoint import CheckpointManager
from scene_generation_tpu_torch.trainer.train_state import build_modules

from _torch_port import (away_from_half, one_torch_thread,  # noqa: F401
                         port_config, random_variables)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = {"imgs_pred": 2e-4, "boxes_pred": 1e-5, "masks_pred": 1e-5}

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _exporter():
    spec = importlib.util.spec_from_file_location(
        "export_jax_to_torch",
        os.path.join(REPO, "scripts", "export_jax_to_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    exporter = _exporter()
    cfg = jax_tiny_config()
    cfg = cfg.replace(train=dataclasses.replace(cfg.train,
                                                adam_mu_dtype="bfloat16"))
    template = exporter.jax_template(cfg)
    rng = np.random.RandomState(0)
    trees = {k: random_variables(getattr(template, k), i)
             for i, k in enumerate(("g_params", "g_stats", "d_img_params",
                                    "d_obj_params", "d_obj_stats",
                                    "d_mask_params"))}
    names = ("g", "d_img", "d_obj", "d_mask")
    txs = dict(zip(names, Modules(cfg).optimizers()))
    params = {n: trees[f"{n}_params"] for n in names}
    grads = jax.tree.map(lambda p: rng.randn(*p.shape).astype(np.float32),
                         params)

    @jax.jit    # one compile for the four inits and updates
    def step_once(grads, params):
        return {n: txs[n].update(grads[n], txs[n].init(params[n]),
                                 params[n])[1] for n in names}

    opts = step_once(grads, params)
    mc = cfg.model
    vecs = rng.randn(mc.num_objs, mc.pool_size, mc.rep_size)
    state = template.replace(
        step=jnp.asarray(1, jnp.int32), rng=jax.random.PRNGKey(9),
        opt_g=opts["g"], opt_d_img=opts["d_img"], opt_d_obj=opts["d_obj"],
        opt_d_mask=opts["d_mask"],
        pool=type(template.pool)(
            jnp.asarray(vecs, jnp.float32),
            jnp.asarray(rng.randint(0, mc.pool_size + 1, mc.num_objs),
                        template.pool.counts.dtype)),
        vgg_params=None,
        **{k: v for k, v in trees.items()})
    src = str(tmp_path_factory.mktemp("jax_run"))
    ckpt = JaxCheckpointManager(src, "checkpoint", use_async=False)
    meta = ckpt.new_meta(cfg, synthetic_vocab(mc.num_objs))
    meta["counters"] = {"t": 1, "epoch": 1}
    ckpt.save(state)
    ckpt.save(state, best=True)
    ckpt.save_meta(meta)
    ckpt.wait()
    dst = str(tmp_path_factory.mktemp("port_run"))
    exporter.export(src, dst)
    return cfg, src, dst, jax.device_get(ckpt.restore(template))


def test_moments_pool_and_counters_equal_jax(exported):
    cfg, _, dst, js = exported
    pcfg = port_config(cfg)
    ckpt = CheckpointManager(dst, "checkpoint", use_async=False)
    assert ckpt.load_meta()["counters"] == {"t": 1, "epoch": 1}
    for best in (False, True):
        sd = torch.load(ckpt.state_path(best), weights_only=True)
        assert sd["step"] == 1 and sd["gen"] is None
        np.testing.assert_array_equal(sd["pool"]["vecs"].numpy(),
                                      np.asarray(js.pool.vecs))
        np.testing.assert_array_equal(sd["pool"]["counts"].numpy(),
                                      np.asarray(js.pool.counts))
    mc, dc = pcfg.model, pcfg.discriminator
    maps = {"g": lambda t: state_dict_from_jax(
                {"params": t, "batch_stats": js.g_stats}, mc),
            "d_img": lambda t: d_img_state_dict_from_jax(t, dc),
            "d_obj": lambda t: d_obj_state_dict_from_jax(
                {"params": t, "batch_stats": js.d_obj_stats}, dc),
            "d_mask": lambda t: d_mask_state_dict_from_jax(t, dc)}
    for (name, fn), module in zip(maps.items(), build_modules(pcfg)[:4]):
        jopt = getattr(js, f"opt_{name}")[0]
        opt = sd[f"opt_{name}"]
        assert opt["count"] == int(jopt.count) == 1
        keys = [k for k, _ in module.named_parameters()]
        for moment, dtype in (("mu", torch.bfloat16), ("nu", torch.float32)):
            want = fn(getattr(jopt, moment))
            assert len(opt[moment]) == len(keys) == len(
                jax.tree.leaves(getattr(jopt, moment)))
            for k, t in zip(keys, opt[moment]):
                assert t.dtype == dtype, (name, moment, k)
                assert torch.equal(t.float(), want[k]), (name, moment, k)
    # One leaf by hand: the object embeddings' mu, untransposed.
    k = [n for n, _ in build_modules(pcfg)[0].named_parameters()].index(
        "obj_embeddings.weight")
    np.testing.assert_array_equal(
        sd["opt_g"]["mu"][k].float().numpy(),
        np.asarray(js.opt_g[0].mu["obj_embeddings"]["embedding"],
                   np.float32))


def test_served_output_equals_jax(exported, monkeypatch):
    cfg, _, dst, js = exported
    mc = cfg.model
    batch = synthetic_batch(cfg, seed=2, batch_size=2)
    n, o = batch.objs.shape
    batch = batch._replace(masks=away_from_half(
        np.random.RandomState(3), (n, o, mc.mask_size, mc.mask_size)))
    port = InferenceModel.from_checkpoint(dst, best=True, device="cpu")
    assert port.cfg.model == port_config(cfg).model
    noise = torch.randn(mc.mask_noise_dim,
                        generator=torch.Generator().manual_seed(5))
    kw = dict(use_gt_boxes=True, use_gt_masks=True, use_gt_attributes=True)
    got = port.forward_batch(batch, generator=torch.Generator().manual_seed(5),
                             **kw)

    ref = JaxInferenceModel.__new__(JaxInferenceModel)
    ref.cfg, ref.vocab, ref._fwd_cache = cfg, {}, {}
    ref.mods = types.SimpleNamespace(model=JaxSceneModel(mc))
    ref.state = collections.namedtuple("State", "g_params g_stats")(
        js.g_params, js.g_stats)
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape: jnp.asarray(noise.numpy()))
    want = ref.forward_batch(batch, rng=jax.random.PRNGKey(0), **kw)
    for field, tol in TOL.items():
        np.testing.assert_allclose(getattr(got, field).numpy(),
                                   np.asarray(getattr(want, field)),
                                   atol=tol, rtol=0, err_msg=field)


def test_port_cli_resumes_from_the_export(exported, capsys):
    _, _, dst, _ = exported
    state, meta = port_train.main(
        ["--synthetic", "--tiny", "--cpu", "--num_iterations", "2",
         "--print_every", "1", "--checkpoint_every", "100",
         "--adam_mu_dtype", "bfloat16", "--output_dir", dst,
         "--restore_from_checkpoint", "1"])
    assert "restored checkpoint at t=1" in capsys.readouterr().out
    assert state.step == 2 and meta["counters"]["t"] == 2
    # No batch counter in a JAX meta: the stream started epoch 2.
    assert meta["counters"]["epoch"] == 2
