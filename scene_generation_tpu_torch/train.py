"""The port's train entry point: the adversarial training on synthetic
batches.

    python -m scene_generation_tpu_torch.train --synthetic --num_iterations N
    python -m scene_generation_tpu_torch.train --synthetic --tiny --device cpu --num_iterations 2

It takes the JAX CLI's flag names for the subset it has (``--synthetic``,
``--tiny``, ``--batch_size``, ``--num_iterations``, ``--print_every``,
``--seed``, ``--compute_dtype``) and ``--device`` (``cuda`` by default; it
raises without a GPU). It builds the train state, steps on synthetic
batches and prints the loss terms every ``print_every`` steps. It has no
checkpoints, evaluation, presets or logging sinks yet.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import sys
from typing import Callable, Dict, List, Optional

from scene_generation_tpu_torch.config import Config, tiny_config
from scene_generation_tpu_torch.data.synthetic import synthetic_batch
from scene_generation_tpu_torch.trainer.step import train_step
from scene_generation_tpu_torch.trainer.train_state import (
    TrainState, create_train_state)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--synthetic", action="store_true",
                   help="procedural scenes (the only dataset of the port yet)")
    p.add_argument("--tiny", action="store_true",
                   help="tiny architecture (CI/smoke)")
    p.add_argument("--batch_size", type=int, default=None,
                   help="default: the config's (12 full / 4 tiny)")
    p.add_argument("--num_iterations", type=int, default=1_000_000)
    p.add_argument("--print_every", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--compute_dtype",
                   choices=["float32", "bfloat16", "float16"],
                   default="float32",
                   help="the generator's compute dtype; the discriminators "
                        "and VGG use DiscriminatorConfig.compute_dtype")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def config_from_args(a: argparse.Namespace) -> Config:
    cfg = tiny_config() if a.tiny else Config()
    data = cfg.data if a.batch_size is None else dataclasses.replace(
        cfg.data, batch_size=a.batch_size)
    return cfg.replace(
        data=data,
        model=dataclasses.replace(cfg.model, compute_dtype=a.compute_dtype),
        train=dataclasses.replace(cfg.train, num_iterations=a.num_iterations,
                                  print_every=a.print_every, seed=a.seed))


def scalars(metrics) -> Dict[str, float]:
    """The loss terms as floats (one host sync), image entries left out."""
    return {k: float(v) for k, v in metrics.items() if not k.startswith("_")}


def run(state: TrainState, num_iterations: int, print_every: int,
        on_step: Optional[Callable[[int, dict], None]] = None
        ) -> List[Dict[str, float]]:
    """Step ``num_iterations`` times on synthetic batches (batch i drawn
    with seed ``cfg.train.seed + i``); print and return the loss terms of
    every ``print_every``-th step and the last."""
    cfg = state.cfg
    logged = []
    for i in range(num_iterations):
        batch = synthetic_batch(cfg, seed=cfg.train.seed + i)
        metrics = train_step(state, batch)
        if on_step is not None:
            on_step(i, metrics)
        if (i + 1) % print_every == 0 or i + 1 == num_iterations:
            vals = scalars(metrics)
            bad = [k for k, v in vals.items() if not math.isfinite(v)]
            if bad:
                raise FloatingPointError(
                    f"step {state.step}: non-finite {bad}")
            print(f"step {state.step} " + " ".join(
                f"{k}={v:.4f}" for k, v in vals.items()), flush=True)
            logged.append(vals)
    return logged


def main(argv=None) -> int:
    a = parse_args(argv)
    if not a.synthetic:
        print("only --synthetic data is ported yet", file=sys.stderr)
        return 2
    cfg = config_from_args(a)
    state = create_train_state(cfg, a.device, seed=cfg.train.seed)
    run(state, cfg.train.num_iterations, cfg.train.print_every)
    return 0


if __name__ == "__main__":
    sys.exit(main())
