"""``InferenceModel.forward_batch`` through ``models/replay.py``: on the
card a signature's first call runs eagerly, its second captures the model
as a CUDA graph, later ones replay it, and every replayed output equals
the eager model's on the same inputs, bit for bit, in bf16 and f32, with
the appearance given and encoded from crops, and at 256 px in bf16 (the
stem in pixel bands). Outputs of successive calls
are fresh tensors; ``_cuda.LAUNCHES`` counts the stem once a call on
every path; a new batch size captures anew; train mode and grad-enabled
calls stay eager. On the CPU every call runs eagerly and equals the model
called directly.

The card tests are marked ``cuda`` and skip without an NVIDIA GPU. This
file imports no JAX, so it runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_graph_replay.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from scene_generation_tpu_torch.api import InferenceModel
from scene_generation_tpu_torch.config import Config
from scene_generation_tpu_torch.config import test_config as small_config
from scene_generation_tpu_torch.data import synthetic_batch
from scene_generation_tpu_torch.entry import build_model
from scene_generation_tpu_torch.ops import _cuda

BATCH = 16
FIELDS = ("imgs_pred", "boxes_pred", "masks_pred", "obj_repr", "cls_vecs")
STEM = {torch.bfloat16: "stem_tc", torch.float32: "stem_f32"}


def features(cfg, batch, seed):
    """Random appearance vectors, every object's given."""
    n, o = batch.objs.shape
    rng = np.random.RandomState(seed)
    return (rng.randn(n, o, cfg.model.rep_size).astype(np.float32),
            np.ones((n, o), np.float32))


def forward(im, cfg, batch, seed, appearance):
    kw = {}
    if appearance == "features":
        kw = dict(zip(("features", "features_mask"),
                      features(cfg, batch, seed)))
    return im.forward_batch(batch, use_gt_attributes=True,
                            generator=torch.Generator().manual_seed(seed),
                            **kw)


def assert_equal(a, b):
    for name in FIELDS:
        x, y = getattr(a, name), getattr(b, name)
        assert torch.equal(x, y), name


def card_model(cfg, dtype):
    """``cfg``'s model on the card in ``dtype``, its mask head scaled to
    unit logit spread (seed weights put every mask within 1e-4 of 0.5,
    which bf16 rounds to 0.5, so that nothing is claimed and every image
    is the same)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs run only on the card")
    model = build_model(cfg, "cuda", seed=0).to(dtype)
    model.requires_grad_(False)
    batch = synthetic_batch(cfg, seed=100, batch_size=BATCH)
    out = forward(InferenceModel(cfg, {}, model), cfg, batch, 100,
                  "features")
    spread = float(torch.logit(out.masks_pred.double()).std())
    model.mask_net.out.weight.div_(spread)
    model.mask_net.out.bias.div_(spread)
    return model


def config_256() -> Config:
    """The paper's 256x256 COCO-Stuff model: Config() with the reference
    trainer's --image_size 256,256."""
    cfg = Config()
    return cfg.replace(
        data=dataclasses.replace(cfg.data, image_size=(256, 256)),
        model=dataclasses.replace(cfg.model, image_size=(256, 256)))


@pytest.fixture(scope="module", params=[torch.bfloat16, torch.float32],
                ids=["bf16", "f32"])
def served(request):
    """The default Config()'s model on the card in one dtype
    (``card_model``)."""
    cfg = Config()
    return cfg, card_model(cfg, request.param), request.param


@pytest.mark.cuda
@pytest.mark.parametrize("appearance", ["features", "crop"])
def test_replay_equals_eager(served, appearance):
    cfg, model, dtype = served
    batches = [synthetic_batch(cfg, seed=s, batch_size=BATCH)
               for s in (1, 2, 3)]
    # The eager model on each batch: a new InferenceModel's first call.
    want = [forward(InferenceModel(cfg, {}, model), cfg, b, s, appearance)
            for s, b in enumerate(batches)]
    for w in want[1:]:
        assert not torch.equal(w.imgs_pred, want[0].imgs_pred)
        assert not torch.equal(w.boxes_pred, want[0].boxes_pred)
    im = InferenceModel(cfg, {}, model)
    _cuda.LAUNCHES.clear()
    _cuda.MODEL_CALLS.clear()
    order = [0, 0, 1, 2, 0, 1, 2]
    got = [forward(im, cfg, batches[i], i, appearance) for i in order]
    torch.cuda.synchronize()
    assert dict(_cuda.MODEL_CALLS) == {"eager": 1, "capture": 1,
                                       "replay": 5}
    # Every output still holds its own call's answer after the later
    # calls: none is the graph's static output.
    for i, out in zip(order, got):
        assert_equal(out, want[i])
    ptrs = [getattr(out, name).data_ptr() for out in got for name in FIELDS]
    assert len(set(ptrs)) == len(ptrs)
    stem = STEM[dtype]
    assert _cuda.LAUNCHES[stem] == len(order), dict(_cuda.LAUNCHES)
    assert _cuda.LAUNCHES["stem"] == len(order)
    crops = len(order) if appearance == "crop" else 0
    assert _cuda.LAUNCHES["crop_fwd"] == crops, dict(_cuda.LAUNCHES)


@pytest.mark.cuda
def test_replay_equals_eager_at_256_px():
    """The 256 px model in bf16 at b16: the stem runs in pixel bands
    (``stem_tc_banded``, never ``stem_tc``) on every path, and each
    replayed output equals the eager model's bit for bit."""
    cfg = config_256()
    model = card_model(cfg, torch.bfloat16)
    batches = [synthetic_batch(cfg, seed=s, batch_size=BATCH)
               for s in (1, 2)]
    want = [forward(InferenceModel(cfg, {}, model), cfg, b, s, "features")
            for s, b in enumerate(batches)]
    assert want[0].imgs_pred.shape == (BATCH, 256, 256, 3)
    assert not torch.equal(want[1].imgs_pred, want[0].imgs_pred)
    im = InferenceModel(cfg, {}, model)
    _cuda.LAUNCHES.clear()
    _cuda.MODEL_CALLS.clear()
    order = [0, 0, 1, 0, 1]
    got = [forward(im, cfg, batches[i], i, "features") for i in order]
    torch.cuda.synchronize()
    assert dict(_cuda.MODEL_CALLS) == {"eager": 1, "capture": 1,
                                       "replay": 3}
    for i, out in zip(order, got):
        assert_equal(out, want[i])
    assert _cuda.LAUNCHES["stem_tc_banded"] == len(order), dict(
        _cuda.LAUNCHES)
    assert _cuda.LAUNCHES["stem"] == len(order)
    assert _cuda.LAUNCHES["stem_tc"] == 0


@pytest.mark.cuda
def test_new_signature_captures_anew_and_eager_paths(served):
    cfg, model, dtype = served
    im = InferenceModel(cfg, {}, model)
    _cuda.LAUNCHES.clear()
    _cuda.MODEL_CALLS.clear()
    for n in (BATCH, BATCH, 8, 8, BATCH, 8):
        forward(im, cfg, synthetic_batch(cfg, seed=n, batch_size=n), n,
                "features")
    assert dict(_cuda.MODEL_CALLS) == {"eager": 2, "capture": 2,
                                       "replay": 2}
    assert _cuda.LAUNCHES[STEM[dtype]] == 6
    # Grad enabled: staged and run eagerly.
    batch = synthetic_batch(cfg, seed=5, batch_size=BATCH)
    n, o = batch.objs.shape
    host = {k: torch.as_tensor(np.asarray(v)) for k, v in dict(
        objs=batch.objs, triples=batch.triples,
        attributes=batch.attributes.astype(np.float32),
        obj_mask=batch.obj_mask.astype(np.float32),
        triple_mask=batch.triple_mask.astype(np.float32),
        mask_noise=np.zeros(cfg.model.mask_noise_dim, np.float32),
        features=np.zeros((n, o, cfg.model.rep_size), np.float32),
        features_mask=np.zeros((n, o), np.float32)).items()}
    with torch.enable_grad():
        for _ in range(3):
            call = im.replay.stage(host, False)
            assert call.path == "eager"
            im.replay.run(call)
    assert _cuda.MODEL_CALLS["eager"] == 5
    # Train mode: staged eagerly every time, and run so where it runs (in
    # f32: the train-mode forward keeps its parameters f32), with the GT
    # boxes and masks it reads.
    model.train()
    try:
        for _ in range(3):
            if dtype == torch.float32:
                im.forward_batch(batch, use_gt_masks=True,
                                 features=host["features"].numpy(),
                                 features_mask=host["features_mask"].numpy())
            else:
                assert im.replay.stage(host, False).path == "eager"
    finally:
        model.eval()
    eager = 8 if dtype == torch.float32 else 5
    assert dict(_cuda.MODEL_CALLS) == {"eager": eager, "capture": 2,
                                       "replay": 2}


def test_cpu_calls_run_eagerly():
    cfg = small_config()
    model = build_model(cfg, "cpu", seed=0)
    im = InferenceModel(cfg, {}, model)
    batch = synthetic_batch(cfg, seed=0, batch_size=2)
    feats, fmask = features(cfg, batch, 0)
    _cuda.MODEL_CALLS.clear()
    outs = [forward(im, cfg, batch, 0, "features") for _ in range(3)]
    assert dict(_cuda.MODEL_CALLS) == {"eager": 3}
    t = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt)  # noqa
    noise = torch.randn(cfg.model.mask_noise_dim,
                        generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        want = model(t(batch.objs, None), t(batch.triples, None),
                     t(batch.attributes), t(batch.obj_mask),
                     t(batch.triple_mask), noise, features=t(feats),
                     features_mask=t(fmask))
    for out in outs:
        assert_equal(out, want)
