"""One rank of ``tests/test_torch_distributed.py``'s two-process step: joins
the gloo group from torchrun's environment, steps the tiny config's state
(seed 5) on its half of the test's 4-image batch, and saves its loss
shares, first moments and pool counts to ``<dir>/rank<r>.pt``."""
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from scene_generation_tpu_torch.parallel import data_parallel  # noqa: E402
from scene_generation_tpu_torch.trainer.step import train_step  # noqa: E402
from scene_generation_tpu_torch.trainer.train_state import \
    create_train_state  # noqa: E402
from test_torch_distributed import _joined_and_halves, _tiny_cfg  # noqa: E402


def main(out_dir: str) -> None:
    comm, dev = data_parallel.init_process_group("cpu")
    try:
        cfg = _tiny_cfg()
        _, halves = _joined_and_halves(cfg)
        state = create_train_state(cfg, dev, seed=5, load_vgg=False,
                                   comm=comm)
        data_parallel.verify_replicated(comm, state)
        metrics = train_step(state, halves[comm.rank])
        mu = {f"{name}.{pn}": opt.state[p]["mu"]
              for name, m, opt in state.trees()
              for pn, p in m.named_parameters()}
        torch.save({"metrics": {k: v for k, v in metrics.items()
                                if not k.startswith("_")},
                    "mu": mu, "pool_counts": state.pool.counts},
                   os.path.join(out_dir, f"rank{comm.rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])
