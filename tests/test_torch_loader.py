"""The port's dataset and loader (``data/synthetic.py::SyntheticDataset``,
``data/loader.py``) against the JAX package's, on the CPU, and the train
CLI's data stream against the JAX CLI's.

Every comparison is exact: the same (seed, index) gives the same example,
the same (seed, epoch) the same batches, for any worker type.
"""
import dataclasses

import numpy as np
import pytest
import torch

import scene_generation_tpu.train as jax_train
from scene_generation_tpu.config import tiny_config as jax_tiny_config
from scene_generation_tpu.data.loader import DataLoader as JaxDataLoader
from scene_generation_tpu.data.synthetic import \
    SyntheticDataset as JaxSyntheticDataset
from scene_generation_tpu_torch import train as port_train
from scene_generation_tpu_torch.data import SyntheticDataset
from scene_generation_tpu_torch.data.loader import DataLoader

from _torch_port import one_torch_thread, port_config  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _cfg(batch_size=4):
    cfg = jax_tiny_config()
    return cfg.replace(data=dataclasses.replace(cfg.data,
                                                batch_size=batch_size))


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for name, a, b in zip(w._fields, g, w):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=name)


def _loaders(size, **kw):
    cfg = _cfg()
    d = cfg.data
    args = (d.batch_size, d.max_objs, d.max_triples)
    return (DataLoader(SyntheticDataset(port_config(cfg), size, seed=3),
                       *args, **kw),
            JaxDataLoader(JaxSyntheticDataset(cfg, size, seed=3), *args,
                          **kw))


def test_synthetic_dataset_examples_equal_jax():
    cfg = _cfg()
    port = SyntheticDataset(port_config(cfg), size=6, seed=5)
    jax_ds = JaxSyntheticDataset(cfg, size=6, seed=5)
    assert len(port) == len(jax_ds) == 6
    assert port.vocab == jax_ds.vocab
    for i in range(6):
        for a, b in zip(port[i], jax_ds[i]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (False, True),
                                               (True, False)])
def test_batches_equal_jax_for_seed_and_epoch(shuffle, drop_last):
    port, jax_dl = _loaders(10, shuffle=shuffle, drop_last=drop_last,
                            seed=7)
    assert len(port) == len(jax_dl) == (2 if drop_last else 3)
    for epoch in (0, 3):
        port.set_epoch(epoch)
        jax_dl.set_epoch(epoch)
        _assert_batches_equal(list(port), list(jax_dl))


def test_two_process_slices_equal_jax():
    for index in (0, 1):
        port, jax_dl = _loaders(12, seed=1, process_count=2,
                                process_index=index)
        port.set_epoch(2)
        jax_dl.set_epoch(2)
        got, want = list(port), list(jax_dl)
        assert got[0].objs.shape[0] == 2
        _assert_batches_equal(got, want)


def test_epoch_advances_and_skip_resumes_mid_epoch():
    port, _ = _loaders(16, seed=2)
    port.set_epoch(4)
    full = list(port)
    assert len(full) == 4
    port.set_epoch(4, skip_batches=3)
    _assert_batches_equal(list(port), full[3:])
    # Each iteration moves to the next epoch.
    port.set_epoch(4)
    list(port)
    again, _ = _loaders(16, seed=2)
    again.set_epoch(5)
    _assert_batches_equal(list(port), list(again))


def test_thread_and_process_workers_give_the_same_batches():
    threads, _ = _loaders(8, seed=4, num_workers=3)
    procs, _ = _loaders(8, seed=4, num_workers=2, worker_type="process")
    try:
        for dl in (threads, procs):
            dl.set_epoch(1)
        _assert_batches_equal(list(procs), list(threads))
        # The pool is built once and kept across epochs.
        pool = procs._process_pool
        procs.set_epoch(1)
        _assert_batches_equal(list(procs), _epoch(threads, 1))
        assert procs._process_pool is pool
    finally:
        procs.close()


def _epoch(dl, epoch):
    dl.set_epoch(epoch)
    return list(dl)


def test_early_break_does_not_hang():
    port, _ = _loaders(40, seed=0, prefetch=1, num_workers=1)
    it = iter(port)
    next(it)
    it.close()               # the producer must see stop and exit
    port.set_epoch(0)
    assert len(list(port)) == 10


def _image_metrics(batch, num_objs):
    """Stand-ins for the step's image entries (the CLIs' image panels)."""
    n, h, w, _ = np.asarray(batch.imgs).shape
    return {"_imgs_pred": np.zeros((n, h, w, 3), np.float32),
            "_layout_one_hot": np.zeros((n, h, w, num_objs), np.float32),
            "_layout_pred_one_hot": np.zeros((n, h, w, num_objs),
                                             np.float32)}


def _jax_cli_batches(monkeypatch, argv, steps):
    """The batches the JAX CLI's step function receives: the train state
    and the step are stubbed out, so nothing compiles."""
    import jax.numpy as jnp
    seen = []

    def fake_state(cfg, rng, batch, load_vgg=True):
        return None, {"w": jnp.zeros((1,))}

    def fake_step(mods):
        def step(state, batch):
            seen.append(tuple(np.asarray(a) for a in batch))
            metrics = {k: jnp.asarray(v) for k, v in
                       _image_metrics(batch, 7).items()}
            return state, dict(metrics, total_loss=jnp.zeros(()))
        return step

    monkeypatch.setattr(jax_train, "create_train_state", fake_state)
    monkeypatch.setattr(jax_train, "make_train_step", fake_step)
    jax_train.main(argv + ["--cpu", "--num_iterations", str(steps)])
    return seen


def test_train_cli_data_stream_equals_jax_cli(monkeypatch, tmp_path):
    """The repair of the port CLI's data stream: for the same --synthetic
    --synthetic_size --batch_size --seed, the batches of steps 1..5 (two
    batches an epoch, so two epoch boundaries) equal the JAX CLI's."""
    common = ["--synthetic", "--tiny", "--synthetic_size", "9",
              "--batch_size", "4", "--seed", "3", "--print_every", "100",
              "--checkpoint_every", "100"]
    want = _jax_cli_batches(
        monkeypatch, common + ["--output_dir", str(tmp_path / "jax")], 5)
    got = []

    def fake_step(state, batch):
        got.append(tuple(np.asarray(a) for a in batch))
        metrics = {k: torch.from_numpy(v) for k, v in
                   _image_metrics(batch, 7).items()}
        return dict(metrics, total_loss=torch.zeros(()))

    monkeypatch.setattr(port_train, "train_step", fake_step)
    port_train.main(common + ["--cpu", "--num_iterations", "5",
                              "--output_dir", str(tmp_path / "port")])
    assert len(want) == len(got) == 5
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    # Epochs 1, 1, 2, 2, 3: not one batch repeated.
    assert len({w[0].tobytes() for w in want}) == 5
