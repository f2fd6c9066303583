"""Data parallelism of the port (``parallel/data_parallel.py``), on the CPU.

Under GSPMD the JAX step is one function of the global batch; the port's
proof is that a step on 2 ranks, each holding half of the batch, equals
one single-process step on the joined batch. The halves here hold
different object counts, so a mean of two local means would be wrong.

Tier-1 (one process): the ranks run as two threads over ``ThreadGroup``,
a fake of the one collective the port uses (an in-place sum), and the
pieces are held one by one: batch statistics, loss shares and their
gradients, the gathered pool query, the draws, then the whole step. The
tolerance is float32's: the halves sum in another order than the joined
batch (1e-5 relative on losses and statistics, 1e-4 of a leaf's max on
moments).

Marked ``slow`` (they spawn processes): two real gloo processes, one step
equal to the joined step, and ``train.main --distributed`` under two
ranks (rank 0 alone writes the checkpoint; both restore it).
"""
import dataclasses
import os
import socket
import subprocess
import sys
import threading

import pytest
import torch

from scene_generation_tpu_torch import losses as L
from scene_generation_tpu_torch.config import tiny_config
from scene_generation_tpu_torch.data import synthetic_batch
from scene_generation_tpu_torch.data.batching import Batch
from scene_generation_tpu_torch.models.layers import MaskedBatchNorm
from scene_generation_tpu_torch.parallel import data_parallel
from scene_generation_tpu_torch.trainer import step as step_mod
from scene_generation_tpu_torch.trainer.pools import (create_pool,
                                                      pool_query,
                                                      pool_query_gathered)
from scene_generation_tpu_torch.trainer.step import train_step
from scene_generation_tpu_torch.trainer.train_state import create_train_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class ThreadGroup:
    """Ranks as threads: ``all_reduce_`` sums every rank's tensor in rank
    order (the same on every rank) behind two barriers."""

    def __init__(self, world: int):
        self.world = world
        self.barrier = threading.Barrier(world, timeout=120)
        self.slots = [None] * world

    def rank(self, r: int) -> data_parallel.Collectives:
        group = self

        class Rank(data_parallel.Collectives):
            rank, world_size = r, group.world

            def all_reduce_(self, t):
                group.slots[r] = t.detach().clone()
                group.barrier.wait()
                total = group.slots[0].clone()
                for other in group.slots[1:]:
                    total += other
                group.barrier.wait()
                return t.copy_(total)

        return Rank()


def run_ranks(fn, world: int = 2):
    """``fn(comm)`` on ``world`` threads; their results in rank order."""
    group = ThreadGroup(world)
    out, errors = [None] * world, []

    def target(r):
        try:
            out[r] = fn(group.rank(r))
        except BaseException as e:   # re-raised in the caller below
            errors.append(e)
            group.barrier.abort()

    threads = [threading.Thread(target=target, args=(r,))
               for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive(), "a rank hung"
    if errors:
        raise errors[0]
    return out


def halves_mask():
    """An object mask of 4 images x 3 slots whose halves hold 5 and 2
    objects."""
    return torch.tensor([[1, 1, 1], [1, 1, 0], [1, 0, 0], [1, 0, 0]],
                        dtype=torch.float32)


def close(a, b, rel=1e-5):
    a = torch.as_tensor(a).detach().double()
    b = torch.as_tensor(b).detach().double()
    return float((a - b).abs().max()) <= rel * float(b.abs().max()) + 1e-7


def _bn_step(bn, xs, ws, probe, weighted, comm=data_parallel.SINGLE):
    """A batch norm's output, and the gradients of ``sum(y * probe)`` (this
    rank's share) with respect to its input, scale and bias (the latter two
    summed over the ranks)."""
    with data_parallel.step_shard(comm, ws):
        xs = xs.clone().requires_grad_(True)
        y = bn(xs, ws if weighted else None)
        gx, gs, gb = torch.autograd.grad((y * probe).sum(),
                                         (xs, bn.scale, bn.bias))
        gs, gb = data_parallel.reduce_grads(comm, [gs, gb])
    return y.detach(), gx, gs, gb


@pytest.mark.parametrize("weighted", [True, False])
def test_batch_norm_statistics_of_two_halves_equal_joined(weighted):
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(12, 5, 3, 3, generator=gen)
    w = halves_mask().reshape(12)
    probe = torch.randn(12, 5, 3, 3, generator=gen)

    def fresh():
        bn = MaskedBatchNorm(5)
        bn.init_params(torch.Generator().manual_seed(1))
        return bn.train()

    joined_bn, bns = fresh(), [fresh(), fresh()]
    want = _bn_step(joined_bn, x, w, probe, weighted)

    def rank(comm):
        sl = slice(6 * comm.rank, 6 * comm.rank + 6)
        return _bn_step(bns[comm.rank], x[sl], w[sl].clone(), probe[sl],
                        weighted, comm)

    got = run_ranks(rank)
    assert close(torch.cat([got[0][0], got[1][0]]), want[0])
    assert close(torch.cat([got[0][1], got[1][1]]), want[1])
    for i in (2, 3):
        assert close(got[0][i], want[i]) and close(got[1][i], want[i])
    for bn in bns:
        assert close(bn.running_mean, joined_bn.running_mean)
        assert close(bn.running_var, joined_bn.running_var)


def test_loss_shares_sum_to_joined_loss_and_gradients():
    """Every loss form of the step, weighted by the object mask or a plain
    mean: the two ranks' shares sum to the joined loss, and their summed
    gradients are the joined gradient."""
    gen = torch.Generator().manual_seed(2)
    mask = halves_mask()
    n, o = mask.shape
    scores = torch.randn(n, o, generator=gen)
    logits = torch.randn(n, o, 6, generator=gen)
    labels = torch.randint(0, 6, (n, o), generator=gen)
    maps = [[torch.randn(n * o, 2, 4, 4, generator=gen),
             torch.randn(n * o, 1, 2, 2, generator=gen)]]
    real = [[torch.randn(n * o, 2, 4, 4, generator=gen),
             torch.randn(n * o, 1, 2, 2, generator=gen)]]
    img = [[torch.randn(n, 3, 4, 4, generator=gen),
            torch.randn(n, 1, 3, 3, generator=gen)]]
    img_real = [[torch.randn(n, 3, 4, 4, generator=gen),
                 torch.randn(n, 1, 3, 3, generator=gen)]]
    vgg = [torch.randn(n, 4, 2, 2, generator=gen) for _ in range(5)]
    vgg_y = [torch.randn(n, 4, 2, 2, generator=gen) for _ in range(5)]

    def losses(rows, m):
        """(loss, its leaves) on image rows ``rows``."""
        obj = slice(rows.start * o, rows.stop * o)
        ls = [t[rows].clone().requires_grad_(True)
              for t in (scores, logits)]
        ms = [t[obj].clone().requires_grad_(True) for t in maps[0]]
        im = [t[rows].clone().requires_grad_(True) for t in img[0]]
        vg = [t[rows].clone().requires_grad_(True) for t in vgg]
        flat = m.reshape(-1)
        total = (L.gan_d_loss(ls[0], ls[0] * 0.5, w=m)
                 + L.mse_loss(ls[0], ls[0] * 0 + 0.3, w=m)
                 + L.masked_cross_entropy(ls[1], labels[rows], w=m)
                 + L.multiscale_gan_loss([ms], True, True, w=flat)
                 + L.feature_matching_loss(
                     [ms], [[t[obj] for t in real[0]]], w=flat)
                 + L.multiscale_gan_loss([im], False, True)
                 + L.feature_matching_loss(
                     [im], [[t[rows] for t in img_real[0]]])
                 + L.vgg_perceptual_loss(vg, [t[rows] for t in vgg_y]))
        return total, ls + ms + im + vg

    want, leaves_j = losses(slice(0, n), mask)
    want_g = torch.autograd.grad(want, leaves_j)

    def rank(comm):
        rows = slice(2 * comm.rank, 2 * comm.rank + 2)
        m = mask[rows].clone()
        with data_parallel.step_shard(comm, m):
            share, ls = losses(rows, m)
            grads = torch.autograd.grad(share, ls)
        return share.detach(), grads

    (s0, g0), (s1, g1) = run_ranks(rank)
    assert close(s0 + s1, want)
    assert len(want_g) == 11
    for i, (g, ga, gb) in enumerate(zip(want_g, g0, g1)):
        assert close(torch.cat([ga, gb]), g), i


def test_gathered_pool_query_equals_joined():
    gen = torch.Generator().manual_seed(3)
    num_classes, pool_size, rep = 4, 3, 5
    pool = create_pool(num_classes, pool_size, rep)
    objs = torch.tensor([1, 2, 1, 0, 3, 1, 1, 2, 2, 3, 1, 0])
    mask = torch.tensor([1, 1, 1, 1, 0, 1, 1, 1, 0, 1, 1, 1.0])
    for rnd in range(3):           # empty, filling, then full classes
        reprs = torch.randn(12, rep, generator=gen)
        base = torch.randint(0, 3, (num_classes,), generator=gen)
        want, joined = pool_query(pool, base, objs, reprs, mask)

        def rank(comm):
            sl = slice(6 * comm.rank, 6 * comm.rank + 6)
            return pool_query_gathered(comm, pool, base, objs[sl],
                                       reprs[sl], mask[sl])

        (w0, p0), (w1, p1) = run_ranks(rank)
        assert torch.equal(torch.cat([w0, w1]), want)
        for p in (p0, p1):
            assert torch.equal(p.vecs, joined.vecs)
            assert torch.equal(p.counts, joined.counts)
        pool = joined


def _tiny_cfg():
    cfg = tiny_config()
    return cfg.replace(
        discriminator=dataclasses.replace(cfg.discriminator,
                                          compute_dtype="float32"),
        loss=dataclasses.replace(cfg.loss, vgg_features_weight=1.0))


def _record_draws(monkeypatch):
    seen = {}
    real = step_mod.draw

    def draw(state):
        d = real(state)
        seen.setdefault(threading.get_ident(), []).append(
            [t.clone() for t in d])
        return d

    monkeypatch.setattr(step_mod, "draw", draw)
    return seen


def test_draws_do_not_depend_on_the_batch_size(monkeypatch):
    """Two states of one seed stepped on 2 and on 4 images draw the same
    use_gt coins, mask noise and pool-base uniforms (their generators
    advance alike), as the ranks of a run must."""
    cfg = _tiny_cfg()
    seen = _record_draws(monkeypatch)
    gens = []
    for n in (2, 4):
        state = create_train_state(cfg, "cpu", seed=5, load_vgg=False)
        for i in range(2):
            train_step(state, synthetic_batch(cfg, seed=i, batch_size=n))
        gens.append(state.gen.get_state())
    draws = seen[threading.get_ident()]      # 2 steps at n=2, then at n=4
    for d2, d4 in zip(draws[:2], draws[2:]):
        assert torch.equal(d2[0], d4[0]) and torch.equal(d2[1], d4[1])
    assert torch.equal(gens[0], gens[1])


def assert_moments_close(mus: dict, joined) -> None:
    """Each first moment (``{"tree.param": mu}``) within 1e-4 of its leaf's
    max plus 1e-6 of its tree's max in the joined state (the second term
    for leaves whose gradient is zero in exact arithmetic, such as a bias
    before a batch norm)."""
    for name, m, opt in joined.trees():
        want = {pn: opt.state[p]["mu"] for pn, p in m.named_parameters()}
        tree_max = max(float(v.abs().max()) for v in want.values())
        for pn, muj in want.items():
            err = float((mus[f"{name}.{pn}"] - muj).abs().max())
            assert err <= 1e-4 * float(muj.abs().max()) + 1e-6 * tree_max, \
                f"{name}.{pn}: {err}"


def _joined_and_halves(cfg, seed=5):
    batch = synthetic_batch(cfg, seed=11, batch_size=4)
    counts = batch.obj_mask.sum(1)
    assert counts[:2].sum() != counts[2:].sum(), counts
    halves = [Batch(*(a[2 * r:2 * r + 2] for a in batch)) for r in (0, 1)]
    return batch, halves


def test_two_rank_step_equals_the_joined_step(monkeypatch):
    """The whole step on two thread ranks (2 + 2 images, different object
    counts) against one step on the 4 joined images from the same state:
    losses (the sum of the shares), every Adam moment, the batch-norm
    running statistics, the pool and the draws."""
    cfg = _tiny_cfg()
    batch, halves = _joined_and_halves(cfg)
    seen = _record_draws(monkeypatch)
    joined = create_train_state(cfg, "cpu", seed=5, load_vgg=False)
    want = train_step(joined, batch)
    states = [create_train_state(cfg, "cpu", seed=5, load_vgg=False)
              for _ in range(2)]

    def rank(comm):
        state = states[comm.rank]
        state.comm = comm
        data_parallel.verify_replicated(comm, state)
        return train_step(state, halves[comm.rank])

    got = run_ranks(rank)
    for k, v in want.items():
        if k.startswith("_") or k == "use_gt":
            continue
        assert close(got[0][k] + got[1][k], v), k
    draws = list(seen.values())
    assert len(draws) == 3
    for d in draws[1:]:
        assert all(torch.equal(a, b) for a, b in zip(d[0], draws[0][0]))
    for state in states:
        assert torch.equal(state.pool.counts, joined.pool.counts)
        assert close(state.pool.vecs, joined.pool.vecs)
        mus = {f"{name}.{pn}": opt.state[p]["mu"]
               for name, m, opt in state.trees()
               for pn, p in m.named_parameters()}
        assert_moments_close(mus, joined)
        for (name, m, _), (_, mj, _) in zip(state.trees(), joined.trees()):
            for (bn, a), b in zip(m.named_buffers(), mj.buffers()):
                assert close(a, b), f"{name}.{bn}"


@pytest.mark.parametrize("world", [1, 2])
def test_stop_is_agreed_at_the_same_step_one_step_late(world):
    """One rank raises its flag at poll 3: a single process stops at that
    poll (the JAX CLI's rule); two ranks both stop at poll 4, and close()
    ends the sum still in flight on both."""
    def rank(comm):
        agreement = data_parallel.StopAgreement(comm)
        polls = []
        for i in range(8):
            stop = agreement.poll(comm.rank == world - 1 and i >= 3)
            polls.append(stop)
            if stop:
                break
        agreement.close()
        return polls

    if world == 1:
        got = [rank(data_parallel.SINGLE)]
    else:
        got = run_ranks(rank, world)
    want = [False] * (3 if world == 1 else 4) + [True]
    assert got == [want] * world


def test_replicas_that_differ_are_refused():
    cfg = _tiny_cfg()
    states = [create_train_state(cfg, "cpu", seed=s, load_vgg=False)
              for s in (5, 6)]

    def rank(comm):
        data_parallel.verify_replicated(comm, states[comm.rank])

    with pytest.raises(RuntimeError, match="differs from rank 0"):
        run_ranks(rank)


# --- two real processes (slow) ---------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(argv, world=2, timeout=600):
    """``python <argv>`` as ``world`` ranks of one gloo group on the CPU,
    with torchrun's environment; their outputs in rank order."""
    port = _free_port()
    procs = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r),
                   WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   OMP_NUM_THREADS="2")
        procs.append(subprocess.Popen(
            [sys.executable] + argv, cwd=REPO, env=env, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return outs


@pytest.mark.slow
def test_two_process_gloo_step_equals_the_joined_step(tmp_path):
    """Two gloo processes, one train step each on 2 of the 4 images,
    against the single-process step on the 4 (same tolerances)."""
    cfg = _tiny_cfg()
    batch, _ = _joined_and_halves(cfg)
    joined = create_train_state(cfg, "cpu", seed=5, load_vgg=False)
    want = train_step(joined, batch)
    _spawn([os.path.join(REPO, "tests", "_torch_dp_worker.py"),
            str(tmp_path)])
    got = [torch.load(tmp_path / f"rank{r}.pt", weights_only=True)
           for r in (0, 1)]
    for k, v in want.items():
        if not k.startswith("_") and k != "use_gt":
            assert close(got[0]["metrics"][k] + got[1]["metrics"][k], v), k
    for r in (0, 1):
        assert_moments_close(got[r]["mu"], joined)
        assert torch.equal(got[r]["pool_counts"], joined.pool.counts)


@pytest.mark.slow
def test_two_process_train_cli_writes_from_rank_0_and_both_restore(
        tmp_path):
    out = str(tmp_path / "run")
    common = ["-m", "scene_generation_tpu_torch.train", "--distributed",
              "--synthetic", "--synthetic_size", "16", "--tiny", "--cpu",
              "--print_every", "1", "--checkpoint_every", "2",
              "--num_val_samples", "8", "--output_dir", out]
    logs = _spawn(common + ["--num_iterations", "2"])
    for r, log in enumerate(logs):
        assert f"rank {r} of 2, gloo" in log, log[-2000:]
    # The same loss lines on both ranks (all-reduced shares).
    lines = [[ln for ln in log.splitlines() if ln.startswith("  [")]
             for log in logs]
    assert lines[0] == lines[1] and lines[0]
    root = os.path.join(out, "checkpoint")
    for name in ("last/state.pt", "best/state.pt", "meta.json"):
        assert os.path.exists(os.path.join(root, name)), name
    logs = _spawn(common + ["--num_iterations", "3",
                            "--restore_from_checkpoint", "1"])
    for log in logs:
        assert "restored checkpoint at t=2" in log, log[-2000:]
