#!/usr/bin/env python3
"""Export a JAX train checkpoint into the PyTorch port's checkpoint layout.

    python scripts/export_jax_to_torch.py --output_dir <JAX run dir> \\
        --to <port output dir> [--checkpoint_name checkpoint]

Reads ``<output_dir>/<checkpoint_name>`` as the JAX package writes it
(Orbax ``last/`` and ``best/``, ``meta.json``), restores each state with
the JAX package's ``CheckpointManager`` on the CPU (the template comes
from ``jax.eval_shape`` of ``create_train_state``, so nothing compiles),
converts it with ``scene_generation_tpu_torch.convert`` and writes
``<to>/<checkpoint_name>/{last,best}/state.pt`` and ``meta.json`` (the
JAX meta as it is: config, vocab, histories, counters). The port's train
CLI resumes from it (``--restore_from_checkpoint 1``) and its
``InferenceModel`` / ``serve.py`` serve it.

What carries over: the four module trees with their batch statistics, the
four Adam states (count, mu, nu, in their stored dtypes), the appearance
pool and the step. What does not: JAX's PRNG key has no torch
counterpart, so the exported state holds no generator state and the port
seeds its generator from the config's seed when it loads it. The weights,
moments, pool and counters are the JAX run's; the noise draws after a
resume differ, as they do between the two packages anyway. The meta's
counters have no ``batch`` entry, so a resume starts the next epoch, as
the JAX CLI's does.

This script is the one file outside the tests that imports both packages.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import jax  # noqa: E402
import numpy as np  # noqa: E402

from scene_generation_tpu.config import Config as JaxConfig  # noqa: E402
from scene_generation_tpu.data import synthetic_batch  # noqa: E402
from scene_generation_tpu.trainer.checkpoint import \
    CheckpointManager as JaxCheckpointManager  # noqa: E402
from scene_generation_tpu.trainer.train_state import \
    create_train_state  # noqa: E402
from scene_generation_tpu_torch.config import Config  # noqa: E402
from scene_generation_tpu_torch.convert import (  # noqa: E402
    adam_state_from_jax, d_img_state_dict_from_jax,
    d_mask_state_dict_from_jax, d_obj_state_dict_from_jax, pool_from_jax,
    state_dict_from_jax)
from scene_generation_tpu_torch.trainer.checkpoint import \
    CheckpointManager  # noqa: E402
from scene_generation_tpu_torch.trainer.train_state import (  # noqa: E402
    TrainState, build_modules)


def jax_template(cfg: JaxConfig):
    """The JAX ``TrainState``'s structure, shapes and dtypes at ``cfg``."""
    batch = synthetic_batch(cfg, seed=0, batch_size=1)
    return jax.eval_shape(
        lambda key: create_train_state(cfg, key, batch, load_vgg=False)[1],
        jax.random.PRNGKey(0))


def convert_state(js, pcfg: Config) -> dict:
    """A restored JAX ``TrainState`` (numpy leaves) -> the port's
    ``TrainState.state_dict()`` tree, the generator state left out."""
    mc, dc = pcfg.model, pcfg.discriminator
    maps = {
        "g": lambda tree: state_dict_from_jax(
            {"params": tree, "batch_stats": js.g_stats}, mc),
        "d_img": lambda tree: d_img_state_dict_from_jax(tree, dc),
        "d_obj": lambda tree: d_obj_state_dict_from_jax(
            {"params": tree, "batch_stats": js.d_obj_stats}, dc),
        "d_mask": lambda tree: d_mask_state_dict_from_jax(tree, dc),
    }
    params = {"g": js.g_params, "d_img": js.d_img_params,
              "d_obj": js.d_obj_params, "d_mask": js.d_mask_params}
    opts = {"g": js.opt_g, "d_img": js.opt_d_img, "d_obj": js.opt_d_obj,
            "d_mask": js.opt_d_mask}
    lrs = {"g": pcfg.train.learning_rate, "d_img": pcfg.train.learning_rate,
           "d_obj": pcfg.train.learning_rate,
           "d_mask": pcfg.train.mask_learning_rate}
    built = build_modules(pcfg)[:4]
    modules = dict(zip(("g", "d_img", "d_obj", "d_mask"), built))
    tree = {}
    for name, module in modules.items():
        tree[name] = maps[name](params[name])
        # The moment trees have the parameters' structure; the batch
        # statistics a map also emits are not optimizer state.
        opt = adam_state_from_jax(opts[name][0], maps[name],
                                  list(module.named_parameters()))
        tree[f"opt_{name}"] = dict(opt, lr=lrs[name])
    vecs, counts = pool_from_jax(js.pool)
    tree["pool"] = {"vecs": vecs, "counts": counts}
    tree["step"] = int(np.asarray(js.step))
    tree["gen"] = None
    # Every key and shape must fit the port's train state.
    TrainState(pcfg, *built, vgg=None, device="cpu").load_state_dict(tree)
    return tree


def export(output_dir: str, to: str,
           checkpoint_name: str = "checkpoint") -> dict:
    """Export every state of the JAX checkpoint; returns its meta."""
    src = JaxCheckpointManager(output_dir, checkpoint_name, use_async=False)
    meta = src.load_meta()
    if meta is None:
        raise FileNotFoundError(f"no checkpoint meta under {src.root}")
    jcfg = JaxConfig.from_json(json.dumps(meta["config"]))
    pcfg = Config.from_json(json.dumps(meta["config"]))
    template = jax_template(jcfg)
    dst = CheckpointManager(to, checkpoint_name, use_async=False)
    exported = []
    for best in (False, True):
        js = src.restore(template, best=best)
        if js is None:
            continue
        dst.save(convert_state(jax.device_get(js), pcfg), best=best)
        exported.append("best" if best else "last")
    if not exported:
        raise FileNotFoundError(f"no checkpoint state under {src.root}")
    dst.save_meta(meta)
    dst.wait()
    print(f"exported {', '.join(exported)} of {src.root} to {dst.root} "
          f"(t={meta['counters']['t']})")
    return meta


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--output_dir", required=True,
                   help="the JAX train run's output dir")
    p.add_argument("--checkpoint_name", default="checkpoint")
    p.add_argument("--to", required=True, help="the port's output dir")
    a = p.parse_args(argv)
    jax.config.update("jax_platforms", "cpu")
    export(a.output_dir, a.to, a.checkpoint_name)


if __name__ == "__main__":
    main()
