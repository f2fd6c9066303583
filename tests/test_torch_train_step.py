"""One port train step against one JAX train step, on the CPU.

Both start from one state: the JAX package's ``TrainState`` at
``tiny_config`` with the VGG term on (``vgg_features_weight=10``), every
module in f32 and a two-conv D_obj (``C4-8-2,C4-16-2`` on 16 px crops,
so that it has a batch norm whose statistics the step moves three
times), its variables drawn with numpy at the shapes ``jax.eval_shape``
gives (no init is compiled), carried into the port by the converters of
``convert.py``. The JAX step's random draws (``use_gt``, the mask noise
and the pool's read base, from ``jax.random.split(state.rng, 4)``) are
replicated here and injected into the port's step.

Compared after the step:
- every metric: 1e-4 relative (plus 1e-6 absolute), f32 sums of a few
  layers taken in another order;
- the first moments of all four Adams, leaf by leaf: after one step
  optax's ``mu`` and the port's ``mu`` are both exactly 0.5 * grad, so
  this compares the gradients (the parameters after one Adam step would
  compare only their signs). Per leaf, 1e-3 of that leaf's max |mu|,
  plus 1e-5 of the tree's max |mu| for leaves whose gradient vanishes in
  exact arithmetic (a bias before an instance norm) and is rounding noise
  on both sides;
- the batch statistics (the generator's, moved once; D_obj's, moved three
  times): 1e-5 relative;
- the pool's vectors and counts.
"""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from scene_generation_tpu.config import tiny_config as jax_tiny_config
from scene_generation_tpu.data import synthetic_batch
from scene_generation_tpu.ops.images import wire_to_float
from scene_generation_tpu.trainer.pools import create_pool as jax_pool
from scene_generation_tpu.trainer.step import make_train_step
from scene_generation_tpu.trainer.train_state import Modules
from scene_generation_tpu.trainer.train_state import \
    TrainState as JaxTrainState
from scene_generation_tpu_torch.config import TrainConfig
from scene_generation_tpu_torch.convert import (d_img_state_dict_from_jax,
                                                d_mask_state_dict_from_jax,
                                                d_obj_state_dict_from_jax,
                                                pool_from_jax,
                                                state_dict_from_jax,
                                                vgg_state_dict_from_jax)
from scene_generation_tpu_torch.train import main as train_main
from scene_generation_tpu_torch.trainer.optim import check_storage_dtypes
from scene_generation_tpu_torch.trainer.pools import (create_pool, draw_base,
                                                      pool_query)
from scene_generation_tpu_torch.trainer.step import Draws, train_step
from scene_generation_tpu_torch.trainer.train_state import (TrainState,
                                                            build_modules)

from _torch_port import port_config, random_variables


def _cfg():
    cfg = jax_tiny_config()
    return cfg.replace(
        loss=dataclasses.replace(cfg.loss, vgg_features_weight=10.0),
        discriminator=dataclasses.replace(
            cfg.discriminator, compute_dtype="float32",
            d_obj_arch="C4-8-2,C4-16-2", crop_size=16))


def _port_trees(pcfg, g, d_img, d_obj, d_mask, d_obj_stats, g_stats):
    """The JAX trees (parameters, or a moment tree of their structure) as
    the port's state dicts, one per optimizer."""
    mc, dc = pcfg.model, pcfg.discriminator
    return {
        "g": state_dict_from_jax({"params": g, "batch_stats": g_stats}, mc),
        "d_img": d_img_state_dict_from_jax(d_img, dc),
        "d_obj": d_obj_state_dict_from_jax(
            {"params": d_obj, "batch_stats": d_obj_stats}, dc),
        "d_mask": d_mask_state_dict_from_jax(d_mask, dc),
    }


def _jax_state(cfg, batch):
    """The JAX ``TrainState`` of ``create_train_state``, with numpy-drawn
    variables (``_torch_port.random_variables``)."""
    mods = Modules(cfg)
    mc = cfg.model
    n, o = batch.objs.shape
    key = jax.random.PRNGKey(0)
    b = {k: jnp.asarray(getattr(batch, k)) for k in batch._fields}

    def init(module, seed, *args, **kw):
        return random_variables(jax.eval_shape(module.init, key, *args, **kw),
                                seed)

    g = init(mods.model, 1, b["objs"], b["triples"], b["attributes"],
             b["obj_mask"], b["triple_mask"],
             jnp.zeros((mc.mask_noise_dim,)), imgs=b["imgs"],
             boxes_gt=b["boxes"], masks_gt=b["masks"])
    d_img = init(mods.d_img, 2, jnp.zeros(
        (n, *mc.image_size, mc.layout_nc + mc.output_nc)))
    d_obj = init(mods.d_obj, 3, wire_to_float(b["imgs"]), b["boxes"],
                 b["obj_mask"])
    d_mask = init(mods.d_mask, 4,
                  jnp.zeros((n * o, mc.mask_size, mc.mask_size, 1)),
                  jnp.zeros((n * o, mc.num_objs)))
    vgg = init(mods.vgg, 5, jnp.zeros((1, *mc.image_size, 3)))
    opt_g, opt_d_img, opt_d_obj, opt_d_mask = mods.optimizers()
    state = JaxTrainState(
        # PRNGKey(3) draws use_gt = 1, so the box term is on.
        step=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(3),
        g_params=g["params"], g_stats=g["batch_stats"],
        opt_g=opt_g.init(g["params"]),
        d_img_params=d_img["params"],
        opt_d_img=opt_d_img.init(d_img["params"]),
        d_obj_params=d_obj["params"], d_obj_stats=d_obj["batch_stats"],
        opt_d_obj=opt_d_obj.init(d_obj["params"]),
        d_mask_params=d_mask["params"],
        opt_d_mask=opt_d_mask.init(d_mask["params"]),
        pool=jax_pool(mc.num_objs, mc.pool_size, mc.rep_size),
        vgg_params=vgg["params"])
    return mods, state


@pytest.fixture(scope="module")
def stepped():
    cfg = _cfg()
    pcfg = port_config(cfg)
    batch = synthetic_batch(cfg, seed=0)
    mods, state = _jax_state(cfg, batch)
    s0 = jax.device_get(state)
    new, metrics = make_train_step(mods, donate=False)(state, batch)

    # The JAX step's draws (trainer/step.py:55-58, trainer/pools.py:81-82).
    _, r_noise, r_gt, r_pool = jax.random.split(state.rng, 4)
    mc = cfg.model
    draws = Draws(
        torch.tensor(float(jax.random.bernoulli(r_gt))),
        torch.from_numpy(np.array(jax.random.normal(
            r_noise, (mc.mask_noise_dim,)))),
        torch.from_numpy(np.array(jax.random.randint(
            r_pool, (mc.num_objs,), 0, jnp.maximum(state.pool.counts, 1)))))

    model, d_img, d_obj, d_mask, vgg = build_modules(pcfg)
    trees = _port_trees(pcfg, s0.g_params, s0.d_img_params, s0.d_obj_params,
                        s0.d_mask_params, s0.d_obj_stats, s0.g_stats)
    for name, module in (("g", model), ("d_img", d_img), ("d_obj", d_obj),
                         ("d_mask", d_mask)):
        module.load_state_dict(trees[name])
    vgg.load_state_dict(vgg_state_dict_from_jax(s0.vgg_params))
    port = TrainState(pcfg, model, d_img, d_obj, d_mask, vgg,
                      torch.device("cpu"))
    port.pool = pool_from_jax(s0.pool)
    port_metrics = train_step(port, batch, draws)
    return cfg, pcfg, jax.device_get(new), jax.device_get(metrics), port, \
        port_metrics


def test_metrics_match_jax(stepped):
    _, _, _, metrics, _, port_metrics = stepped
    scalars = {k for k in metrics if not k.startswith("_")}
    assert scalars == {k for k in port_metrics if not k.startswith("_")}
    assert "g_vgg" in scalars and len(scalars) == 18
    assert float(metrics["use_gt"]) == 1.0 and float(metrics["bbox_pred"]) > 0
    for k in sorted(scalars):
        np.testing.assert_allclose(float(port_metrics[k]), float(metrics[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    for k in ("_imgs_pred", "_layout_one_hot", "_layout_pred_one_hot"):
        np.testing.assert_allclose(port_metrics[k].numpy(),
                                   np.asarray(metrics[k]), atol=2e-4,
                                   err_msg=k)


def test_first_moments_of_all_four_optimizers_match_jax(stepped):
    _, pcfg, new, _, port, _ = stepped
    want = _port_trees(pcfg, new.opt_g[0].mu, new.opt_d_img[0].mu,
                       new.opt_d_obj[0].mu, new.opt_d_mask[0].mu,
                       new.d_obj_stats, new.g_stats)
    for name, module, opt in port.trees():
        tree = {k: v for k, v in want[name].items()
                if not k.endswith(("running_mean", "running_var"))}
        params = dict(module.named_parameters())
        assert sorted(tree) == sorted(params), name
        tree_max = max(float(v.abs().max()) for v in tree.values())
        assert tree_max > 0
        for k, mu in tree.items():
            got = opt.state[params[k]]["mu"]
            tol = 1e-3 * float(mu.abs().max()) + 1e-5 * tree_max
            err = float((got - mu).abs().max())
            assert err <= tol, f"{name}.{k}: {err} > {tol}"


def test_batch_statistics_and_pool_match_jax(stepped):
    _, pcfg, new, _, port, _ = stepped
    want = _port_trees(pcfg, new.g_params, new.d_img_params,
                       new.d_obj_params, new.d_mask_params, new.d_obj_stats,
                       new.g_stats)
    for name, module, _ in port.trees():
        sd = module.state_dict()
        for k, v in want[name].items():
            if k.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(sd[k].numpy(), v.numpy(),
                                           rtol=1e-5, atol=1e-6,
                                           err_msg=f"{name}.{k}")
    np.testing.assert_array_equal(port.pool.counts.numpy(),
                                  np.asarray(new.pool.counts))
    assert int(port.pool.counts.sum()) > 0
    np.testing.assert_allclose(port.pool.vecs.numpy(),
                               np.asarray(new.pool.vecs), atol=1e-5)


def test_every_parameter_tree_updates(stepped):
    _, pcfg, new, _, port, _ = stepped
    assert port.step == 1
    for name, module, opt in port.trees():
        changed = [bool(opt.state[p]["mu"].abs().max() > 0)
                   for p in module.parameters()]
        assert sum(changed) / len(changed) > 0.9, name


def test_pool_query_semantics():
    gen = torch.Generator().manual_seed(0)
    pool = create_pool(num_classes=3, pool_size=2, rep_size=4)
    objs = torch.tensor([1, 1, 2])
    reprs = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    mask = torch.ones(3)
    wrong, pool = pool_query(pool, draw_base(pool, gen), objs, reprs, mask)
    # An empty pool returns the object's own vector.
    torch.testing.assert_close(wrong, reprs)
    assert int(pool.counts[1]) == 2 and int(pool.counts[2]) == 1
    # The second query returns the stored vectors, not the new ones.
    wrong2, pool = pool_query(pool, draw_base(pool, gen), objs, reprs + 100,
                              mask)
    assert float(wrong2.abs().max()) < 100
    # Invalid rows neither read their class nor write.
    pool3 = create_pool(3, 2, 4)
    _, pool3 = pool_query(pool3, draw_base(pool3, gen), objs, reprs,
                          torch.zeros(3))
    assert int(pool3.counts.sum()) == 0 and not pool3.vecs.any()


def test_pool_at_capacity_no_write_collision():
    """At capacity, same-class objects of one batch overwrite distinct
    slots: every insert lands, and each reads a previous entry once."""
    cap, k = 4, 4
    gen = torch.Generator().manual_seed(1)
    pool = create_pool(num_classes=2, pool_size=cap, rep_size=1)
    mask = torch.ones(k)
    objs = torch.full((k,), 1)
    fill = torch.arange(k, dtype=torch.float32).reshape(k, 1)
    _, pool = pool_query(pool, draw_base(pool, gen), objs, fill, mask)
    assert int(pool.counts[1]) == cap
    for key in range(1, 6):
        fresh = torch.arange(k, dtype=torch.float32).reshape(k, 1) + 100 * key
        wrong, pool = pool_query(pool, draw_base(pool, gen), objs, fresh, mask)
        assert sorted(pool.vecs[1, :, 0].tolist()) == fresh[:, 0].tolist()
        prev = torch.arange(k, dtype=torch.float32) + 100 * (key - 1)
        torch.testing.assert_close(torch.sort(wrong[:, 0]).values, prev)


def test_storage_dtypes_are_not_ported_yet():
    """The storage dtypes are ported now (``tests/test_torch_optim.py``
    holds them against JAX): every flag value of the JAX CLI names a
    dtype, and a name that is none raises."""
    for name, values in (("adam_mu_dtype", ("", "bfloat16")),
                         ("adam_nu_dtype", ("", "float16", "bfloat16")),
                         ("grads_dtype", ("", "bfloat16"))):
        for v in values:
            got = check_storage_dtypes(TrainConfig(**{name: v}))[name]
            assert got == (getattr(torch, v) if v else None)
        with pytest.raises(ValueError, match="float64"):
            check_storage_dtypes(TrainConfig(**{name: "float64"}))


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_train_cli_runs_on_the_cpu(capsys, tmp_path, compute_dtype):
    """The CLI at the tiny config; bf16 runs the generator under autocast
    (the discriminators are bf16 by default either way). It prints the
    JAX CLI's lines: ``t = i / N (r it/s)`` and one ``[name]: value`` per
    loss term."""
    state, meta = train_main(["--synthetic", "--tiny", "--device", "cpu",
                              "--num_iterations", "2", "--print_every", "1",
                              "--output_dir", str(tmp_path),
                              "--compute_dtype", compute_dtype])
    assert state.step == 2 and meta["counters"]["t"] == 2
    out = capsys.readouterr().out.splitlines()
    heads = [i for i, ln in enumerate(out) if ln.startswith("t = ")]
    assert [out[i].split()[2] for i in heads] == ["1", "2"]
    for i in heads:
        vals = {}
        for ln in out[i + 1:]:
            if not ln.startswith("  ["):
                break
            name, val = ln.strip()[1:].split("]: ")
            vals[name] = float(val)
        assert "total_loss" in vals
        assert all(np.isfinite(v) for v in vals.values())
