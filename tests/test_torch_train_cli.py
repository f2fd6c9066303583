"""The port's train CLI (``scene_generation_tpu_torch/train.py``) on the
CPU at the tiny config, after the JAX package's ``test_preset.py``,
``test_nan_gate.py``, ``test_train_epochs.py`` and ``test_initial_eval.py``:

- for the same argv the port's config equals the JAX ``config_from_args``
  config on every field both have, for each preset and with explicit
  overrides;
- the documented run: 4 steps with a checkpoint every 2 write ``last/``,
  ``best/`` and ``meta.json``, and a resume to 6 ends bit for bit where a
  straight 6-step run ends;
- the NaN gate dumps ``<name>_nan_abort`` and leaves ``last/`` alone;
- SIGTERM (sent from an ``on_step`` hook) checkpoints and returns;
- the epoch counter follows the consumed batches;
- ``--initial_eval 1`` runs.
"""
import json
import os
import signal

import pytest
import torch

from scene_generation_tpu.train import config_from_args as jax_config
from scene_generation_tpu.train import parse_args as jax_parse
from scene_generation_tpu_torch import train as train_mod
from scene_generation_tpu_torch.trainer.checkpoint import tree_leaves

from _torch_port import one_torch_thread  # noqa: F401

TINY = ["--synthetic", "--tiny", "--cpu"]

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _shared(a: dict, b: dict, path=""):
    """(path, a value, b value) of every leaf key both dicts have."""
    for k in sorted(set(a) & set(b)):
        if isinstance(a[k], dict):
            yield from _shared(a[k], b[k], f"{path}/{k}")
        else:
            yield f"{path}/{k}", a[k], b[k]


@pytest.mark.parametrize("argv", [
    [], ["--preset", "quality"], ["--preset", "throughput"],
    ["--preset", "quality", "--box_net_final", "relu", "--batch_size", "6",
     "--adam_mu_dtype", "", "--synthetic_size", "64"],
    ["--tiny", "--preset", "throughput", "--adam_nu_dtype", "float16",
     "--grads_dtype", "bfloat16", "--learning_rate", "3e-4"],
], ids=["parity", "quality", "throughput", "quality-overridden",
        "tiny-throughput"])
def test_config_equals_jax_config_from_args(argv):
    argv = ["--synthetic"] + argv
    a_jax, a_port = jax_parse(argv), train_mod.parse_args(argv)
    for k, v in vars(a_jax).items():
        if k not in ("cpu",):
            assert getattr(a_port, k) == v, k
    want = json.loads(jax_config(a_jax).to_json())
    got = json.loads(train_mod.config_from_args(a_port).to_json())
    pairs = list(_shared(want, got))
    assert len(pairs) > 80
    for path, w, g in pairs:
        assert g == w, path
    assert {k for k in want["model"]} - {k for k in got["model"]} <= {
        "scan_blocks", "remat_generator", "test_compositor_backend",
        "test_stem_backend"}


def test_unported_flags_raise(monkeypatch):
    """``--scan_blocks 1`` is the one flag the port refuses; the COCO flags
    read their directory (tests/test_torch_coco_cli.py trains on one) and
    ``--distributed`` needs torchrun's environment
    (tests/test_torch_distributed.py runs it)."""
    with pytest.raises(NotImplementedError):
        train_mod.main(["--synthetic", "--scan_blocks", "1", "--cpu"])
    for extra in (["--coco_dir", "x"], ["--coco_dir", "x",
                                        "--is_panoptic", "1"]):
        with pytest.raises(FileNotFoundError, match="x/annotations"):
            train_mod.main(extra + ["--cpu"])
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        train_mod.main(["--synthetic", "--distributed", "--cpu"])


def test_runs_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_mod.main(["--synthetic", "--tiny"])


def _leaves(state):
    return list(tree_leaves(state.state_dict()))


def test_checkpoint_then_resume_equals_a_straight_run(tmp_path, capsys):
    """The documented CPU run: t=4 is in the middle of the first epoch
    (512 synthetic images), and the resume continues it. (Its val sweeps
    are cut to 8 images: they read the state and do not change it.)"""
    common = TINY + ["--checkpoint_every", "2", "--print_every", "1",
                     "--num_val_samples", "8"]
    out = str(tmp_path / "run")
    train_mod.main(common + ["--num_iterations", "4", "--output_dir", out])
    root = os.path.join(out, "checkpoint")
    for name in ("last/state.pt", "best/state.pt", "meta.json"):
        assert os.path.exists(os.path.join(root, name)), name
    resumed, meta = train_mod.main(common + ["--num_iterations", "6",
                                             "--output_dir", out,
                                             "--restore_from_checkpoint",
                                             "1"])
    assert "restored checkpoint at t=4" in capsys.readouterr().out
    straight, _ = train_mod.main(common + ["--num_iterations", "6",
                                           "--output_dir",
                                           str(tmp_path / "straight")])
    assert meta["counters"] == {"t": 6, "epoch": 1, "batch": 6}
    for (path, a), (_, b) in zip(_leaves(straight), _leaves(resumed)):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), path
        else:
            assert a == b, path


def test_nan_gate_dumps_and_keeps_last(tmp_path, monkeypatch):
    real = train_mod.train_step

    def poisoned(state, batch):
        metrics = real(state, batch)
        if state.step >= 3:
            metrics = dict(metrics,
                           total_loss=metrics["total_loss"] + float("nan"))
        return metrics

    monkeypatch.setattr(train_mod, "train_step", poisoned)
    out = str(tmp_path / "run")
    with pytest.raises(FloatingPointError, match="non-finite"):
        train_mod.main(TINY + ["--num_iterations", "4", "--print_every", "1",
                               "--checkpoint_every", "2", "--output_dir",
                               out, "--synthetic_size", "8"])
    with open(os.path.join(out, "checkpoint", "meta.json")) as f:
        assert json.load(f)["counters"]["t"] == 2
    assert os.path.exists(os.path.join(out, "checkpoint", "last",
                                       "state.pt"))
    with open(os.path.join(out, "checkpoint_nan_abort", "meta.json")) as f:
        nan_meta = json.load(f)
    assert nan_meta["nan_abort"] == {"t": 3, "keys": ["total_loss"]}
    assert os.path.exists(os.path.join(out, "checkpoint_nan_abort", "last",
                                       "state.pt"))


def test_sigterm_checkpoints_and_exits_cleanly(tmp_path, capsys):
    before = signal.getsignal(signal.SIGTERM)

    def on_step(t, batch, metrics):
        if t == 2:
            os.kill(os.getpid(), signal.SIGTERM)

    out = str(tmp_path / "run")
    state, meta = train_mod.main(
        TINY + ["--num_iterations", "10", "--print_every", "5",
                "--checkpoint_every", "100", "--output_dir", out,
                "--synthetic_size", "8"], on_step=on_step)
    assert state.step == 2 and meta["counters"]["t"] == 2
    assert "preempted: checkpointed at t=2" in capsys.readouterr().out
    with open(os.path.join(out, "checkpoint", "meta.json")) as f:
        assert json.load(f)["counters"]["t"] == 2
    assert signal.getsignal(signal.SIGTERM) is before


def test_epoch_counter_tracks_consumed_batches(tmp_path):
    # batch 4, 8 images: 2 steps an epoch; steps 1..5 are epochs
    # 1, 1, 2, 2, 3.
    out = str(tmp_path / "run")
    train_mod.main(TINY + ["--num_iterations", "5", "--print_every", "5",
                           "--checkpoint_every", "100", "--output_dir", out,
                           "--synthetic_size", "8"])
    with open(os.path.join(out, "checkpoint", "meta.json")) as f:
        counters = json.load(f)["counters"]
    assert (counters["t"], counters["epoch"]) == (5, 3)


def test_initial_eval_flag_runs(tmp_path, capsys):
    out = str(tmp_path / "run")
    train_mod.main(TINY + ["--num_iterations", "2", "--print_every", "2",
                           "--checkpoint_every", "100", "--output_dir", out,
                           "--synthetic_size", "8", "--initial_eval", "1"])
    assert "initial: val-gt iou" in capsys.readouterr().out
    with open(os.path.join(out, "checkpoint", "meta.json")) as f:
        assert json.load(f)["counters"]["t"] == 2


def test_timing_profile_and_inception_flags(tmp_path, capsys):
    """--timing prints the window's ms/step; --profile_dir writes a
    torch.profiler trace of its steps; --eval_inception scores the val
    sweeps with InceptionV3 (seed-initialised here: no weights on disk,
    so the JAX CLI's warning, and best promotion stays on val-sg IoU)."""
    out, prof = str(tmp_path / "run"), str(tmp_path / "prof")
    _, meta = train_mod.main(
        TINY + ["--num_iterations", "3", "--print_every", "1",
                "--checkpoint_every", "3", "--output_dir", out,
                "--synthetic_size", "8", "--num_val_samples", "4",
                "--timing", "--profile_dir", prof, "--profile_start", "2",
                "--profile_steps", "1", "--eval_inception"])
    text = capsys.readouterr().out
    assert text.count("[timing]") == 2
    assert "no InceptionV3 weights found" in text
    assert os.path.getsize(os.path.join(prof, "trace.json")) > 0
    assert meta["val_gt_inception"][0] >= 1.0
    assert meta["best_metric"] == "val_sg_iou"
