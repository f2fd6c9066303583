"""Checkpoint save / restore with best-state promotion (port of the JAX
package's ``trainer/checkpoint.py``, without Orbax).

Layout, one directory per checkpoint name:

  <output_dir>/<checkpoint_name>/last/state.pt   the latest state
  <output_dir>/<checkpoint_name>/best/state.pt   the best state so far
  <output_dir>/<checkpoint_name>/meta.json       config, vocab, histories,
                                                 counters (``new_meta``)

``state.pt`` is ``torch.save`` of a state's ``state_dict()`` tree on the
CPU (``TrainState``'s, or ``{"g": ...}`` alone for a serving checkpoint).
Every file is written to a temporary name and moved into place with
``os.replace``, so a reader sees the old file or the new one, never half.

Saves are asynchronous: ``save()`` clones the state on its device and
returns (PyTorch's optimizers update parameters in place, so the next
step must not reach the tensors being written); one background thread
then copies the clone to the host on a side CUDA stream and writes it.
``save_meta()`` serializes the dict when called and queues its write
behind the state's, so ``meta.json``'s counters never get ahead of the
weights. ``wait()`` drains the queue and re-raises a background failure;
``close()`` then stops the thread.
"""
from __future__ import annotations

import concurrent.futures
import json
import os
from typing import Any, Callable, Dict, List, Optional

import torch

from scene_generation_tpu_torch.config import Config

META_NAME = "meta.json"
STATE_NAME = "state.pt"


def tree_map(fn: Callable, tree):
    """``fn`` over the tensors of a tree of dicts, lists and tuples; other
    leaves (ints, floats, strings) are kept as they are."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def tree_leaves(tree, prefix: str = ""):
    """(path, leaf) of every leaf, tensors and scalars alike."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_leaves(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def _state_tree(state):
    return state.state_dict() if hasattr(state, "state_dict") else state


def _to_host(tree, ready: Optional[torch.cuda.Event]):
    """The tree on the CPU. Device tensors are copied on a side stream
    that first waits for ``ready`` (the snapshot), so the copy overlaps
    the steps that follow it."""
    if ready is None:
        return tree_map(lambda t: t.cpu(), tree)
    side = torch.cuda.Stream()
    side.wait_event(ready)
    with torch.cuda.stream(side):
        return tree_map(lambda t: t.to("cpu"), tree)


def _replace_into(path: str, write: Callable[[str], None]) -> None:
    tmp = path + ".tmp"
    write(tmp)
    os.replace(tmp, path)


def _write_state(directory: str, tree) -> None:
    os.makedirs(directory, exist_ok=True)
    _replace_into(os.path.join(directory, STATE_NAME),
                  lambda tmp: torch.save(tree, tmp))


class CheckpointManager:
    """``writer=False`` (every rank of a data-parallel run but rank 0, whose
    replica is the same) makes ``save`` and ``save_meta`` no-ops: one
    writer of record (JAX ``trainer/checkpoint.py:31-77``); every rank
    restores."""

    def __init__(self, output_dir: str, checkpoint_name: str = "checkpoint",
                 use_async: bool = True, writer: bool = True):
        self.root = os.path.abspath(os.path.join(output_dir, checkpoint_name))
        os.makedirs(self.root, exist_ok=True)
        self.writer = writer
        # One worker: the writes land in the order they were queued.
        self._exec: Optional[concurrent.futures.ThreadPoolExecutor] = (
            concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="ckpt")
            if use_async and writer else None)
        self._pending: List[concurrent.futures.Future] = []

    # --- metadata sidecar ---
    @property
    def meta_path(self) -> str:
        return os.path.join(self.root, META_NAME)

    def state_path(self, best: bool = False) -> str:
        return os.path.join(self.root, "best" if best else "last",
                            STATE_NAME)

    def load_meta(self) -> Optional[Dict[str, Any]]:
        if not os.path.exists(self.meta_path):
            return None
        with open(self.meta_path) as f:
            return json.load(f)

    def save_meta(self, meta: Dict[str, Any]) -> None:
        """Serialize ``meta`` now (the caller goes on changing it) and write
        it after every state save queued before it."""
        if not self.writer:
            return
        payload = json.dumps(meta)

        def write():
            def put(tmp):
                with open(tmp, "w") as f:
                    f.write(payload)
            _replace_into(self.meta_path, put)

        if self._exec is not None:
            self._submit(write)
        else:
            self.wait()
            write()

    @staticmethod
    def new_meta(cfg: Config, vocab: Dict) -> Dict[str, Any]:
        return {
            "config": json.loads(cfg.to_json()),
            "vocab": vocab,
            "losses_ts": [],
            "losses": {},
            "d_losses": {},
            "checkpoint_ts": [],
            # The reference's "train" check_model row is a use_gt=True
            # sweep of the val loader, so the history is val_gt_*.
            "val_gt_inception": [],
            "val_inception": [],
            "best_t": [],
            "counters": {"t": 0, "epoch": 0},
        }

    # --- state ---
    def _submit(self, fn) -> None:
        # A failure of a task that has already finished surfaces at the
        # next one instead of training on past a broken checkpoint stream.
        done = [f for f in self._pending if f.done()]
        self._pending = [f for f in self._pending if not f.done()]
        for f in done:
            f.result()
        self._pending.append(self._exec.submit(fn))

    def wait(self) -> None:
        """Drain every queued write, raising the first failure."""
        pending, self._pending = self._pending, []
        for f in pending:
            f.result()

    def close(self) -> None:
        """Drain the queue and stop the background thread."""
        try:
            self.wait()
        finally:
            if self._exec is not None:
                self._exec.shutdown(wait=True)
                self._exec = None

    def save(self, state, best: bool = False) -> None:
        """Persist ``state`` (an object with ``state_dict()``, or a tree).

        Asynchronously, it returns after one copy of the state on its
        device: the copy is queued on the current stream before any later
        step's in-place update, so the background thread reads the state
        as of this call. It costs one state-sized device allocation until
        the write is done."""
        if not self.writer:
            return
        directory = os.path.dirname(self.state_path(best))
        tree = _state_tree(state)
        if self._exec is None:
            self.wait()
            _write_state(directory, _to_host(tree, None))
            return
        snap = tree_map(lambda t: t.detach().clone(), tree)
        ready = None
        if any(isinstance(t, torch.Tensor) and t.is_cuda
               for _, t in tree_leaves(snap)):
            ready = torch.cuda.Event()
            ready.record()
        self._submit(lambda: _write_state(directory, _to_host(snap, ready)))

    def restore(self, template, best: bool = False):
        """Load ``last/`` (or ``best/``) into ``template``: its
        ``load_state_dict`` when it has one (and the template is
        returned), else a tree like ``template`` on its devices. Leaves
        whose saved dtype differs from the template's are cast to the
        template's, with one warning. None when there is no state."""
        self.wait()
        path = self.state_path(best)
        if not os.path.exists(path):
            return None
        saved = torch.load(path, map_location="cpu", weights_only=True)
        target = _state_tree(template)
        tree = align_dtypes(target, saved)
        if hasattr(template, "load_state_dict"):
            template.load_state_dict(tree)
            return template
        return _to_devices(target, tree)

    def has_checkpoint(self) -> bool:
        return os.path.exists(self.state_path())

    # --- best promotion (reference trainer.py:188-197) ---
    # The reference appends the score before comparing it with the
    # history's max, so its condition can never fire after the first
    # checkpoint; this compares with the prior history, then appends.
    def maybe_promote_best(self, meta: Dict[str, Any], state, score: float,
                           metric: str = "val_inception") -> bool:
        """Save ``state`` to ``best/`` when ``score`` beats the history
        ``meta[metric]``. A change of metric restarts the history (scores
        in other units do not compare), recorded in ``meta["best_metric"]``.
        """
        if meta.get("best_metric") != metric:
            meta["best_metric"] = metric
            meta[metric] = []
        history = meta.setdefault(metric, [])
        is_best = (len(meta["best_t"]) == 0 or not history
                   or max(history) < score)
        if is_best:
            meta["best_t"].append(meta["counters"]["t"])
            self.save(state, best=True)
        history.append(score)
        return is_best


def align_dtypes(template, restored):
    """``restored`` with every tensor cast to the dtype of the template's
    tensor at the same place, warning once when any differ (a checkpoint
    written under another ``--adam_mu_dtype``, say). The trees must have
    the same structure."""
    mismatched = []

    def walk(t, r, path):
        if isinstance(t, dict):
            if set(t) != set(r):
                raise ValueError(f"checkpoint keys at '{path or '/'}' differ "
                                 f"from the state's: {sorted(set(t) ^ set(r))}")
            return {k: walk(t[k], r[k], f"{path}/{k}") for k in t}
        if isinstance(t, (list, tuple)):
            if len(t) != len(r):
                raise ValueError(f"checkpoint holds {len(r)} entries at "
                                 f"'{path}', the state {len(t)}")
            return type(t)(walk(a, b, f"{path}[{i}]")
                           for i, (a, b) in enumerate(zip(t, r)))
        if isinstance(t, torch.Tensor) and isinstance(r, torch.Tensor) \
                and r.dtype != t.dtype:
            mismatched.append(f"{path}: {r.dtype}->{t.dtype}")
            return r.to(t.dtype)
        return r

    out = walk(template, restored, "")
    if mismatched:
        print(f"[scene_generation_tpu_torch] WARNING: checkpoint dtypes "
              f"differ from the configured state on {len(mismatched)} "
              f"leaves (e.g. {mismatched[0]}); cast to the configured "
              "dtypes (--adam_mu_dtype flip between save and resume is the "
              "usual cause)")
    return out


def _to_devices(template, tree):
    if isinstance(template, dict):
        return {k: _to_devices(template[k], tree[k]) for k in template}
    if isinstance(template, (list, tuple)):
        return type(template)(_to_devices(a, b)
                              for a, b in zip(template, tree))
    if isinstance(template, torch.Tensor):
        return tree.to(template.device)
    return tree
