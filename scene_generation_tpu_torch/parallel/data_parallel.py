"""Data parallelism across processes (the counterpart of the JAX package's
``parallel/mesh.py``).

Under GSPMD the JAX step is one function of the global batch: its batch
statistics, loss normalizers and pool see every process's rows, and XLA
inserts the gradient reductions. Here each process (rank) holds a
replica of the train state and a contiguous 1/world_size slice of every
global batch (``DataLoader(process_count=, process_index=)``), and the
step reproduces the global one explicitly:

  * loss normalizers: each rank computes its *share* of the global loss,
    its local ``sum(x * w)`` over ``max(global sum(w), 1)`` (a plain mean:
    its local sum over the global count), so the shares add up to the
    joined batch's loss; the one normalizer that depends on the data, the
    object mask's global sum, is reduced once at the start of a step
    (``step_shard``);
  * batch statistics: ``MaskedBatchNorm`` all-reduces its weighted sums
    in one differentiable call (``all_reduce_sum``), so the backward
    carries the cross-rank term and the running averages agree;
  * the appearance pool queries the gathered batch (``gather``), the same
    on every rank, so the pool stays replicated;
  * gradients are summed across ranks in one flat all-reduce an update
    (``reduce_grads``);
  * the step's draws come from the state's generator, seeded alike on
    every rank and independent of the batch size.

Everything rests on one collective, an in-place sum over ranks
(``Collectives.all_reduce_``). A single process is a group of one
(``SINGLE``, whose sum is the identity), so one code path serves both:
the one-process step is the world-1 case of the global step.
``TorchDistributed`` is torch.distributed's default group, and a test can
substitute threads. ``init_process_group`` starts that group from
torchrun's environment: NCCL when every local rank has a card of its own,
gloo otherwise (the CPU, or ranks that share a card, which NCCL refuses).
"""
from __future__ import annotations

import contextlib
import contextvars
import os
import time
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from scene_generation_tpu_torch import resolve_device


class Collectives:
    """A group of ``world_size`` ranks; this process is ``rank``. This
    class is the group of one process, whose sum is its own value."""

    rank: int = 0
    world_size: int = 1
    calls: int = 0          # all-reduces made, and their wall seconds
    seconds: float = 0.0

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks, in place; returns ``t``."""
        return t


SINGLE = Collectives()


class TorchDistributed(Collectives):
    """torch.distributed's default process group. ``calls`` and
    ``seconds`` count its all-reduces and their wall time. Under gloo a
    CUDA tensor is staged through the host (which waits for the device),
    so the clock starts after the device has caught up and measures the
    copies and the reduction alone; under NCCL it measures the launch. A
    host tensor always goes over gloo (a group of its own under NCCL), so
    reducing it never waits for the device."""

    def __init__(self):
        self.rank = dist.get_rank()
        self.world_size = dist.get_world_size()
        self.backend = dist.get_backend()
        self.host_group = (None if self.backend == "gloo"
                           else dist.new_group(backend="gloo"))
        self.calls = 0
        self.seconds = 0.0

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        staged = t.is_cuda and self.backend == "gloo"
        if staged:
            torch.cuda.synchronize(t.device)
        start = time.perf_counter()
        if staged:
            host = t.cpu()
            dist.all_reduce(host)
            t.copy_(host)
        elif t.is_cuda:
            dist.all_reduce(t)
        else:
            dist.all_reduce(t, group=self.host_group)
        self.seconds += time.perf_counter() - start
        self.calls += 1
        return t


def init_process_group(device: Optional[str] = None
                       ) -> Tuple[TorchDistributed, torch.device]:
    """Join the process group that torchrun describes (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``); returns the group and this rank's device: the CPU
    for ``device="cpu"``, else a card (and none raises). NCCL when the
    host has a card for every local rank, gloo otherwise."""
    missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                           "MASTER_PORT") if k not in os.environ]
    if missing:
        raise RuntimeError(f"--distributed needs torchrun's environment "
                           f"({', '.join(missing)} unset): run it under "
                           "torchrun --nproc_per_node N")
    world = int(os.environ["WORLD_SIZE"])
    local_rank = int(os.environ.get("LOCAL_RANK", os.environ["RANK"]))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    dev = resolve_device(device)
    backend = "gloo"
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        if cards >= local_world:
            backend = "nccl"
        dev = torch.device("cuda", local_rank % cards)
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method="env://", world_size=world,
                            rank=int(os.environ["RANK"]))
    return TorchDistributed(), dev


def gather(comm: Collectives, t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes) concatenated along dim 0 in rank
    order: each rank writes its rows into zeros and the ranks sum, which is
    exact (gloo has no all-gather of CUDA tensors; this needs none)."""
    n = t.shape[0]
    out = t.new_zeros((comm.world_size * n,) + tuple(t.shape[1:]))
    out[comm.rank * n:(comm.rank + 1) * n] = t
    return comm.all_reduce_(out)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm, t):
        ctx.comm = comm
        return comm.all_reduce_(t.clone())

    @staticmethod
    def backward(ctx, grad):
        # Every rank's loss share depends on the sum: its gradient is the
        # sum of the ranks' gradients.
        return None, ctx.comm.all_reduce_(grad.contiguous().clone())


def all_reduce_sum(comm: Collectives, t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the ranks, differentiable (the backward sums
    the ranks' gradients)."""
    return _AllReduceSum.apply(comm, t)


def reduce_grads(comm: Collectives, grads: Sequence[torch.Tensor]
                 ) -> List[torch.Tensor]:
    """The ranks' gradients summed, in one all-reduce of the flattened
    list (in float32 at least: the reduction precedes any cast to a
    storage dtype, as GSPMD's does). One rank's are returned as they are,
    without the flat copy."""
    if comm.world_size == 1:
        return list(grads)
    dtype = torch.promote_types(grads[0].dtype, torch.float32)
    flat = torch.cat([g.reshape(-1).to(dtype) for g in grads])
    comm.all_reduce_(flat)
    return [f.view_as(g) for f, g in zip(flat.split([g.numel()
                                                     for g in grads]), grads)]


def any_rank(comm: Collectives, flag: bool) -> bool:
    """True on every rank when ``flag`` is true on any (a stop that every
    rank takes at the same step, so none waits alone in a collective).
    The flag is reduced on the host: the device is not waited for."""
    return bool(comm.all_reduce_(torch.tensor([float(flag)]))[0] > 0)


def verify_replicated(comm: Collectives, state) -> None:
    """Raise unless every rank holds the same train state: each leaf's sum
    (and its sum of squares) in float64, gathered and compared with rank
    0's (the counterpart of ``replicate_state``, mesh.py:92-103; the
    replicas are built from one seed, or restored from one file)."""
    if comm.world_size == 1:
        return
    from scene_generation_tpu_torch.trainer.checkpoint import tree_leaves
    names, sums = [], []
    for path, leaf in tree_leaves(state.state_dict()):
        if isinstance(leaf, torch.Tensor):
            x = leaf.detach().to(state.device, torch.float64)
            sums += [x.sum(), (x * x).sum()]
        else:
            sums += [torch.tensor(float(leaf), dtype=torch.float64,
                                  device=state.device)] * 2
        names.append(path)
    local = torch.stack(sums)[None]
    every = gather(comm, local).cpu()
    for r in range(1, comm.world_size):
        differ = (every[r] != every[0]).nonzero()
        if len(differ):
            raise RuntimeError(f"rank {r}'s train state differs from rank "
                               f"0's at {names[int(differ[0]) // 2]}")


class Shard(NamedTuple):
    """The data-parallel context of one step on one rank; outside a step,
    the group of one process (``SINGLE``) and no object mask."""
    comm: Collectives
    # The step's object mask (this rank's rows) and its sum over every
    # rank's rows.
    weight: Optional[torch.Tensor] = None
    weight_total: Optional[torch.Tensor] = None

    def total(self, w: torch.Tensor) -> torch.Tensor:
        """The sum of the weights ``w`` over every rank's rows. In a step
        ``w`` must be the step's object mask (or a view of it), the one
        data-dependent normalizer, reduced at the step's start; outside a
        step the process holds the whole batch and this is ``w``'s sum."""
        if self.weight is None:
            return w.float().sum()
        if (w.data_ptr() != self.weight.data_ptr()
                or w.numel() != self.weight.numel()):
            raise ValueError("in a train step a masked loss must be "
                             "weighted by the step's object mask")
        return self.weight_total


_STEP: contextvars.ContextVar = contextvars.ContextVar(
    "data_parallel_step", default=Shard(SINGLE))


def current() -> Shard:
    """The step's data-parallel context (``Shard(SINGLE)`` outside one)."""
    return _STEP.get()


@contextlib.contextmanager
def step_shard(comm: Collectives, obj_mask: torch.Tensor):
    """Within it, losses, batch statistics and gradients are this rank's
    share of the global step (the whole step under ``SINGLE``)."""
    total = comm.all_reduce_(obj_mask.float().sum().reshape(1))[0]
    token = _STEP.set(Shard(comm, obj_mask, total))
    try:
        yield
    finally:
        _STEP.reset(token)
