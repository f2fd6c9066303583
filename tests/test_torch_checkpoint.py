"""The port's checkpoints (``trainer/checkpoint.py`` and the train CLI's
use of it), after the JAX package's ``test_resume.py``,
``test_best_promotion.py`` and ``test_checkpoint_async.py``:

- a run checkpointed at t=3 and resumed to t=6 ends bit for bit where a
  straight 6-step run ends (every tensor of the train state, the loss
  history's last entry, the counters);
- ``save()`` returns after a copy of the state, so the next step's in-place
  update does not reach the file, and ``save_meta()`` writes the dict as
  it was when called;
- promote, save and meta, queued in that order, all land;
- a failure on the background thread surfaces at ``wait()``;
- a checkpoint restored under another ``adam_mu_dtype`` is cast, with one
  warning;
- best promotion improves only on a better score, restarts its history
  when the metric changes, and the CLI keys it on val-sg IoU without
  Inception weights;
- (slow: a subprocess) a SIGKILL during an asynchronous save leaves the
  previous state and meta the durable pair.
"""
import dataclasses
import json
import os
import signal
import subprocess
import sys

import pytest
import torch

from scene_generation_tpu_torch import train as train_mod
from scene_generation_tpu_torch.config import tiny_config
from scene_generation_tpu_torch.data import synthetic_batch
from scene_generation_tpu_torch.trainer import checkpoint as ckpt_mod
from scene_generation_tpu_torch.trainer.checkpoint import (CheckpointManager,
                                                           tree_leaves)
from scene_generation_tpu_torch.trainer.step import train_step
from scene_generation_tpu_torch.trainer.train_state import create_train_state

from _torch_port import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tiny config: batch 4; --synthetic_size 8 -> 2 steps an epoch, so t=3
# is in the middle of epoch 2.
COMMON = ["--synthetic", "--tiny", "--cpu", "--print_every", "3",
          "--checkpoint_every", "3", "--synthetic_size", "8"]


def _state(cfg=None):
    return create_train_state(cfg or tiny_config(), "cpu", seed=0,
                              load_vgg=False)


def _assert_trees_equal(a, b):
    la, lb = list(tree_leaves(a)), list(tree_leaves(b))
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), path
        else:
            assert x == y, path


def test_resume_matches_uninterrupted(tmp_path):
    out_a = str(tmp_path / "straight")
    state_a, meta_a = train_mod.main(
        COMMON + ["--num_iterations", "6", "--output_dir", out_a])
    out_b = str(tmp_path / "resumed")
    train_mod.main(COMMON + ["--num_iterations", "3", "--output_dir", out_b])
    state_b, meta_b = train_mod.main(
        COMMON + ["--num_iterations", "6", "--output_dir", out_b,
                  "--restore_from_checkpoint", "1"])
    assert meta_b["counters"] == meta_a["counters"] == {
        "t": 6, "epoch": 3, "batch": 2}
    _assert_trees_equal(state_a.state_dict(), state_b.state_dict())
    assert meta_b["losses"]["total_loss"][-1] == \
        meta_a["losses"]["total_loss"][-1]
    assert meta_b["checkpoint_ts"] == meta_a["checkpoint_ts"] == [3, 6]


def test_async_save_survives_the_next_step_and_meta_mutation(tmp_path):
    """restore() gives the state as of save() although the next train
    step updates every parameter and moment in place right after it, and
    meta.json holds the dict as of save_meta()."""
    cfg = tiny_config()
    state = _state(cfg)
    train_step(state, synthetic_batch(cfg, seed=0))
    want = ckpt_mod.tree_map(lambda t: t.clone(), state.state_dict())
    ckpt = CheckpointManager(str(tmp_path), "ckpt", use_async=True)
    meta = {"counters": {"t": 1, "epoch": 1}}
    ckpt.save(state)
    train_step(state, synthetic_batch(cfg, seed=1))
    ckpt.save_meta(meta)
    meta["counters"]["t"] = 999
    ckpt.wait()
    restored = ckpt.restore(_state(cfg))
    _assert_trees_equal(restored.state_dict(), want)
    assert restored.step == 1
    assert ckpt.load_meta()["counters"]["t"] == 1


def test_async_promote_then_save_then_meta_all_land(tmp_path):
    ckpt = CheckpointManager(str(tmp_path), "ckpt", use_async=True)
    meta = {"best_t": [], "counters": {"t": 4, "epoch": 0}}
    assert ckpt.maybe_promote_best(meta, {"w": torch.tensor([1.0])}, 0.5,
                                   metric="val_sg_iou")
    ckpt.save({"w": torch.tensor([2.0])})
    ckpt.save_meta(meta)
    ckpt.wait()
    best = ckpt.restore({"w": torch.zeros(1)}, best=True)
    last = ckpt.restore({"w": torch.zeros(1)})
    assert float(best["w"][0]) == 1.0 and float(last["w"][0]) == 2.0
    assert ckpt.load_meta()["best_t"] == [4]


def test_background_failure_surfaces(tmp_path, monkeypatch):
    ckpt = CheckpointManager(str(tmp_path), "ckpt", use_async=True)

    def boom(directory, tree):
        raise RuntimeError("disk on fire")

    monkeypatch.setattr(ckpt_mod, "_write_state", boom)
    ckpt.save({"w": torch.zeros(4)})
    with pytest.raises(RuntimeError, match="disk on fire"):
        ckpt.wait()
    # Once raised, the error is consumed: the manager stays usable.
    ckpt.wait()


def test_restore_casts_flipped_optimizer_dtype(tmp_path, capsys):
    """A state saved with f32 Adam moments, restored into an
    ``adam_mu_dtype=bfloat16`` state: every mu comes back bf16 (the
    configured dtype), with one warning."""
    cfg = tiny_config()
    state = _state(cfg)
    train_step(state, synthetic_batch(cfg, seed=0))
    ckpt = CheckpointManager(str(tmp_path), "ckpt", use_async=False)
    ckpt.save(state)
    bf16 = cfg.replace(train=dataclasses.replace(cfg.train,
                                                 adam_mu_dtype="bfloat16"))
    capsys.readouterr()
    restored = ckpt.restore(_state(bf16))
    for (name, _, saved), (_, _, got) in zip(state.trees(),
                                             restored.trees()):
        for a, b in zip(saved.state_dict()["mu"], got.state_dict()["mu"]):
            assert b.dtype == torch.bfloat16, name
            assert torch.equal(b, a.to(torch.bfloat16)), name
        for a, b in zip(saved.state_dict()["nu"], got.state_dict()["nu"]):
            assert b.dtype == torch.float32 and torch.equal(a, b), name
    out = capsys.readouterr().out
    assert out.count("checkpoint dtypes") == 1


def test_promotes_on_metric_improvement_only(tmp_path):
    ckpt = CheckpointManager(str(tmp_path), "ckpt", use_async=False)
    meta = {"best_t": [], "counters": {"t": 0, "epoch": 0}}
    for t, w, score, promoted in ((100, 1.0, 0.30, True),
                                  (200, 2.0, 0.25, False),
                                  (300, 3.0, 0.40, True)):
        meta["counters"]["t"] = t
        assert ckpt.maybe_promote_best(meta, {"w": torch.tensor([w])}, score,
                                       metric="val_sg_iou") == promoted
    assert meta["best_t"] == [100, 300]
    assert meta["val_sg_iou"] == [0.30, 0.25, 0.40]
    assert meta["best_metric"] == "val_sg_iou"
    best = ckpt.restore({"w": torch.zeros(1)}, best=True)
    assert float(best["w"][0]) == 3.0


def test_metric_switch_restarts_history(tmp_path):
    ckpt = CheckpointManager(str(tmp_path), "ckpt", use_async=False)
    meta = {"best_t": [], "counters": {"t": 100, "epoch": 0}}
    assert ckpt.maybe_promote_best(meta, {"w": torch.tensor([1.0])}, 5.0,
                                   metric="val_inception")
    meta["counters"]["t"] = 200
    # 0.3 < 5.0, but it is an IoU now: a fresh history, so it promotes.
    assert ckpt.maybe_promote_best(meta, {"w": torch.tensor([2.0])}, 0.3,
                                   metric="val_sg_iou")
    assert meta["val_sg_iou"] == [0.3]
    assert meta["best_metric"] == "val_sg_iou"


def test_train_cli_keys_on_iou_without_inception_weights(tmp_path,
                                                         monkeypatch):
    promoted = []
    real = CheckpointManager.maybe_promote_best

    def spy(self, meta, state, score, metric="val_inception"):
        promoted.append((metric, score))
        return real(self, meta, state, score, metric=metric)

    def fake_check_model(model, loader, use_gt, num_samples, probs_fn=None,
                         **kw):
        return (0.25 if use_gt else 0.125, 7.7, 0.0, 0.5, 0.5)

    monkeypatch.setattr(CheckpointManager, "maybe_promote_best", spy)
    monkeypatch.setattr(train_mod, "check_model", fake_check_model)
    out = str(tmp_path / "run")
    _, meta = train_mod.main(["--synthetic", "--tiny", "--cpu",
                              "--num_iterations", "2", "--print_every", "2",
                              "--checkpoint_every", "2", "--output_dir", out,
                              "--synthetic_size", "8"])
    assert promoted == [("val_sg_iou", 0.125)]
    assert meta["val_gt_iou"] == [0.25] and meta["best_t"] == [2]


_KILL_WORKER = """
import sys, time, torch
sys.path.insert(0, sys.argv[2])
from scene_generation_tpu_torch.trainer import checkpoint as ckpt_mod
ckpt = ckpt_mod.CheckpointManager(sys.argv[1], "checkpoint")
ckpt.save({"w": torch.full((256,), 2.0)})
ckpt.save_meta({"counters": {"t": 2, "epoch": 0}})
ckpt.wait()
print("DURABLE_T2", flush=True)
real = ckpt_mod._write_state
def slow(directory, tree):
    time.sleep(60.0)
    return real(directory, tree)
ckpt_mod._write_state = slow
ckpt.save({"w": torch.full((256,), 4.0)})
ckpt.save_meta({"counters": {"t": 4, "epoch": 0}})
print("ASYNC_PENDING", flush=True)
time.sleep(120.0)
"""


@pytest.mark.slow
def test_sigkill_mid_async_save_keeps_previous_durable(tmp_path):
    """Slow: a subprocess. SIGKILL lands while the t=4 save is stalled on
    the background thread; the t=2 state and meta stay the durable pair
    (each file is replaced whole, and meta queues behind the state)."""
    out_dir = str(tmp_path / "run")
    proc = subprocess.Popen([sys.executable, "-c", _KILL_WORKER, out_dir,
                             REPO], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        seen = []
        for line in proc.stdout:
            seen.append(line.strip())
            if "ASYNC_PENDING" in line:
                break
        else:
            pytest.fail(f"worker exited early: {seen}")
        assert "DURABLE_T2" in seen
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    ckpt = CheckpointManager(out_dir, "checkpoint", use_async=False)
    assert ckpt.has_checkpoint()
    assert ckpt.load_meta()["counters"]["t"] == 2
    restored = ckpt.restore({"w": torch.zeros(256)})
    assert torch.equal(restored["w"], torch.full((256,), 2.0))
    with open(os.path.join(out_dir, "checkpoint", "meta.json")) as f:
        assert json.load(f)["counters"] == {"t": 2, "epoch": 0}
