"""``entry()``: the flagship test-mode forward (scene graph -> 128x128
image) at the full default ``Config()``, with seed-initialised weights,
shaped like the JAX package's ``__graft_entry__.entry()``; ``train_entry()``:
one adversarial train step of the same config.

    fn, args = entry()
    imgs = fn(*args)          # (2, 128, 128, 3) float32 on the card
    fn, args = train_entry()
    metrics = fn(*args)       # one G + D_mask + D_obj + D_img update

Run ``python -m scene_generation_tpu_torch.entry`` for a one-line check.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from scene_generation_tpu_torch import resolve_device
from scene_generation_tpu_torch.config import Config
from scene_generation_tpu_torch.data.synthetic import synthetic_batch
from scene_generation_tpu_torch.models import SceneModel, init_weights
from scene_generation_tpu_torch.trainer.step import train_step
from scene_generation_tpu_torch.trainer.train_state import create_train_state


def build_model(cfg: Config, device: Optional[str] = None,
                seed: int = 0) -> SceneModel:
    """A seed-initialised SceneModel on ``device`` in the config's compute
    dtype, in eval mode."""
    dev = resolve_device(device)
    model = init_weights(SceneModel(cfg.model), seed)
    return model.to(device=dev, dtype=cfg.model.torch_compute_dtype).eval()


def entry(device: Optional[str] = None, batch_size: int = 2,
          seed: int = 0) -> Tuple[Callable, tuple]:
    """``(fn, args)``: ``fn(*args)`` is the test-mode forward's images.

    ``args`` = (model, objs, triples, attributes, obj_mask, triple_mask,
    noise, features, features_mask), all on ``device`` (CUDA unless
    ``device="cpu"``); the features are zero with a zero mask, so every
    object's appearance comes from repr_net.
    """
    cfg = Config()
    dev = resolve_device(device)
    mc = cfg.model
    model = build_model(cfg, dev, seed)
    batch = synthetic_batch(cfg, seed=seed, batch_size=batch_size)
    n, o = batch.objs.shape

    def t(a, dtype=None):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    args = (model, t(batch.objs), t(batch.triples), t(batch.attributes),
            t(batch.obj_mask), t(batch.triple_mask),
            torch.zeros(mc.mask_noise_dim, device=dev),
            torch.zeros((n, o, mc.rep_size), device=dev),
            torch.zeros((n, o), device=dev))

    @torch.no_grad()
    def fn(model, objs, triples, attrs, obj_mask, triple_mask, noise,
           features, features_mask):
        return model(objs, triples, attrs, obj_mask, triple_mask, noise,
                     features=features, features_mask=features_mask).imgs_pred

    return fn, args


def train_entry(device: Optional[str] = None,
                batch_size: Optional[int] = None,
                seed: int = 0) -> Tuple[Callable, tuple]:
    """``(fn, args)``: ``fn(*args)`` runs one train step of the default
    ``Config()`` (batch 12 unless ``batch_size``) on a synthetic batch and
    returns its metrics. ``args`` = (state, batch): the seed-initialised
    train state on ``device`` (CUDA unless ``device="cpu"``) and the numpy
    batch; each call updates the state in place."""
    cfg = Config()
    state = create_train_state(cfg, device, seed=seed)
    batch = synthetic_batch(cfg, seed=seed, batch_size=batch_size)
    return train_step, (state, batch)


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    torch.cuda.synchronize()
    print("entry() OK:", tuple(out.shape), out.dtype, out.device)
