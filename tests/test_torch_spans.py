"""The port's profiler ranges on the CPU: ``forward_batch`` runs
``infer/inputs`` and then ``infer/model``; the model's five stage ranges
(``model/*``) each run once inside ``infer/model``, the crop inside
``model/appearance`` when the appearance comes from the image; a
train-mode forward has its layout and generator ranges;
``device_prefetch``'s ``loader/next`` holds no ``yield``; the ranges
change no output; and with no profiler on, no range is entered.

The ranges are read with the autograd profiler without Kineto: it sees
the same ``record_function`` ranges, and its first profile starts in
milliseconds where Kineto's takes seconds on the CPU."""
import contextlib

import numpy as np
import pytest
import torch
from torch.autograd.profiler import profile
from torch.profiler import record_function

from scene_generation_tpu_torch.api import InferenceModel
from scene_generation_tpu_torch.config import test_config as small_config
from scene_generation_tpu_torch.data import synthetic_batch
from scene_generation_tpu_torch.data.loader import device_prefetch
from scene_generation_tpu_torch.entry import build_model
from scene_generation_tpu_torch.profiling import span

STAGES = ("model/graph", "model/appearance", "model/heads", "model/layout",
          "model/generator")


@pytest.fixture(scope="module")
def served():
    cfg = small_config()
    model = InferenceModel(cfg, {}, build_model(cfg, "cpu", seed=0))
    return model, synthetic_batch(cfg, seed=0, batch_size=1)


@pytest.fixture(scope="module")
def traced(served):
    """Each appearance path's forward under the profiler: its output and
    its profile."""
    model, batch = served
    out = {}
    for appearance in ("features", "crop"):
        kw = ({} if appearance == "crop"
              else dict(features=features(model, batch)))
        with profile(use_kineto=False) as prof:
            y = forward(model, batch, **kw)
        out[appearance] = (y, prof)
    return out


def ranges(prof, prefixes=("infer/", "model/", "loader/")):
    """(name, start, end) of the program's ranges, in start order."""
    return sorted(((e.name, e.time_range.start, e.time_range.end)
                   for e in prof.function_events
                   if e.name.startswith(prefixes)), key=lambda r: r[1])


def features(model, batch):
    n, o = batch.objs.shape
    return np.ones((n, o, model.cfg.model.rep_size), np.float32)


def forward(model, batch, **kw):
    return model.forward_batch(batch, generator=torch.Generator()
                               .manual_seed(7), **kw)


def inside(r, outer) -> bool:
    return outer[1] <= r[1] and r[2] <= outer[2]


@pytest.mark.parametrize("appearance", ["features", "crop"])
def test_forward_batch_ranges(traced, appearance):
    prof = traced[appearance][1]
    got = ranges(prof)
    infer = [r for r in got if r[0].startswith("infer/")]
    assert [r[0] for r in infer] == ["infer/inputs", "infer/model"]
    assert infer[0][2] <= infer[1][1]
    stages = [r for r in got if r[0].startswith("model/")]
    assert [r[0] for r in stages] == list(STAGES)
    assert all(inside(r, infer[1]) for r in stages)
    app = stages[1]
    crops = [e for e in prof.function_events if e.name == "_Crop"]
    if appearance == "crop":
        assert crops and all(inside((e.name, e.time_range.start,
                                     e.time_range.end), app) for e in crops)
    else:
        assert not crops


def test_train_forward_ranges():
    cfg = small_config()
    model = build_model(cfg, "cpu", seed=0).train()
    b = synthetic_batch(cfg, seed=1, batch_size=1)
    t = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt)  # noqa
    with torch.no_grad(), profile(use_kineto=False) as prof:
        model(t(b.objs, torch.long), t(b.triples, torch.long),
              t(b.attributes), t(b.obj_mask), t(b.triple_mask),
              torch.zeros(cfg.model.mask_noise_dim), imgs=t(b.imgs),
              boxes_gt=t(b.boxes), masks_gt=t(b.masks))
    names = [r[0] for r in ranges(prof, ("model/",))]
    assert names[:3] == ["model/graph", "model/appearance", "model/heads"]
    assert names.count("model/generator") == 1
    # The GT layout, the predicted-mask layout, the wrong-texture layout.
    assert names.count("model/layout") == 3


def test_ranges_change_no_output(served, traced):
    model, batch = served
    on = traced["features"][0]
    off = forward(model, batch, features=features(model, batch))
    for name in ("imgs_pred", "boxes_pred", "masks_pred"):
        assert torch.equal(getattr(off, name), getattr(on, name)), name


def test_loader_next_holds_no_yield():
    items = [torch.full((2,), float(i)) for i in range(3)]
    out = []
    with profile(use_kineto=False) as prof:
        for item in device_prefetch(iter(items), "cpu"):
            with record_function("consumer"):
                out.append(item)
    assert out == items
    got = ranges(prof, ("loader/", "consumer"))
    nexts = [r for r in got if r[0] == "loader/next"]
    consumers = [r for r in got if r[0] == "consumer"]
    assert len(nexts) == len(items) + 1 and len(consumers) == len(items)
    assert not any(inside(c, n) for c in consumers for n in nexts)


def test_span_enters_nothing_without_profiler():
    assert isinstance(span("model/graph"), contextlib.nullcontext)
    with profile(use_kineto=False):
        assert isinstance(span("model/graph"), record_function)
    assert isinstance(span("model/graph"), contextlib.nullcontext)
