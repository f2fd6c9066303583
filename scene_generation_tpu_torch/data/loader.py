"""Prefetching data loader producing padded Batches (port of the JAX
package's ``data/loader.py``: the same order, batches and worker modes).

Two worker modes:

  * ``worker_type="thread"`` (default): threads suffice for cheap
    datasets (synthetic) and avoid any pickling.
  * ``worker_type="process"``: spawn-context worker processes, built
    lazily once and kept across epochs; the dataset is shipped once per
    worker through the pool initializer.

Determinism: the epoch-e order comes from ``default_rng((seed, e))`` and
every example fetch goes through ``dataset.get_example(index, epoch)``
where the dataset has it, so the batches are a pure function of (dataset
seed, epoch, index): the same for any worker count, worker type or
restart, and the same as the JAX package's loader.

Multi-process data parallelism: with ``process_count`` / ``process_index``
every process computes the same global order and loads only its
contiguous 1/process_count slice of each global batch.

A background assembler keeps a bounded queue of collated batches ahead of
the training loop; a consumer that stops early stops it too.
``device_prefetch`` then copies ``depth`` batches ahead onto the card.
"""
from __future__ import annotations

import collections
import multiprocessing
import queue
import threading
from concurrent.futures import (CancelledError, ProcessPoolExecutor,
                                ThreadPoolExecutor)
from typing import Iterator

import numpy as np
import torch

from scene_generation_tpu_torch.data.batching import Batch, collate

_worker_dataset = None


def _init_worker(dataset):
    global _worker_dataset
    _worker_dataset = dataset


def _fetch_example(dataset, task):
    index, epoch = task
    get = getattr(dataset, "get_example", None)
    if get is not None:
        return get(index, epoch)
    return dataset[index]


def _worker_get(task):
    return _fetch_example(_worker_dataset, task)


class DataLoader:
    def __init__(self, dataset, batch_size: int, max_objs: int,
                 max_triples: int, shuffle: bool = True,
                 num_workers: int = 4, drop_last: bool = True,
                 seed: int = 0, prefetch: int = 2,
                 worker_type: str = "thread",
                 process_count: int = 1, process_index: int = 0):
        assert worker_type in ("thread", "process")
        assert 0 <= process_index < process_count
        if process_count > 1:
            if batch_size % process_count:
                raise ValueError(
                    f"global batch_size {batch_size} must divide evenly "
                    f"across {process_count} processes")
            if not drop_last:
                raise ValueError(
                    "multi-process loading requires drop_last=True (a "
                    "ragged final batch cannot be split evenly)")
        self.dataset = dataset
        self.batch_size = batch_size          # GLOBAL batch size
        self.max_objs = max_objs
        self.max_triples = max_triples
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.worker_type = worker_type
        self.process_count = process_count
        self.process_index = process_index
        self.seed = seed
        self._epoch = 0
        self._skip = 0
        self._process_pool = None

    def _pool(self):
        """The spawn-context process pool, built at first use and kept
        (the spawn and the dataset pickle are paid once)."""
        if self._process_pool is None:
            self._process_pool = ProcessPoolExecutor(
                self.num_workers,
                mp_context=multiprocessing.get_context("spawn"),
                initializer=_init_worker, initargs=(self.dataset,))
        return self._process_pool

    def close(self):
        if self._process_pool is not None:
            self._process_pool.shutdown(wait=False, cancel_futures=True)
            self._process_pool = None

    def set_epoch(self, epoch: int, skip_batches: int = 0) -> None:
        """Align the next ``__iter__`` with epoch ``epoch``, starting after
        its first ``skip_batches`` batches (a resume mid-epoch)."""
        self._epoch = epoch
        self._skip = skip_batches

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Batch]:
        epoch, skip = self._epoch, self._skip
        self._epoch, self._skip = epoch + 1, 0
        order = np.arange(len(self.dataset))
        if self.shuffle:
            # Derived per (seed, epoch), not a mutated stream, so any
            # process and any restart reproduces the same global order.
            np.random.default_rng((self.seed, epoch)).shuffle(order)
        batches = [order[i:i + self.batch_size]
                   for i in range(0, len(order), self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]
        if self.process_count > 1:
            local = self.batch_size // self.process_count
            lo = self.process_index * local
            batches = [b[lo:lo + local] for b in batches]
        batches = batches[skip:]

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        # One IPC round trip per worker (not per example) in process mode.
        chunk = max(1, len(batches[0]) // self.num_workers) if batches else 1

        def produce_with(pool, fetch):
            for idxs in batches:
                if stop.is_set():
                    return
                tasks = [(int(i), epoch) for i in idxs]
                try:
                    examples = list(pool.map(fetch, tasks, chunksize=chunk))
                except (CancelledError, RuntimeError):
                    # close() shut the pool down (cancelling its work) after
                    # the consumer stopped.
                    if stop.is_set():
                        return
                    raise
                batch = collate(examples, self.max_objs, self.max_triples)
                # A put that honours stop: a blocking put would wedge this
                # thread (and the executor's exit join) when the consumer
                # stops early.
                while not stop.is_set():
                    try:
                        q.put(batch, timeout=0.25)
                        break
                    except queue.Full:
                        continue

        def produce():
            if self.worker_type == "process":
                produce_with(self._pool(), _worker_get)
            else:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    produce_with(
                        pool, lambda t: _fetch_example(self.dataset, t))
            if not stop.is_set():
                q.put(None)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    return
                yield batch
        finally:
            stop.set()


def device_prefetch(iterator, device, depth: int = 2):
    """Overlap the host-to-device copy with compute: keep ``depth``
    batches in flight on the card. Each batch is copied from pinned host
    memory with ``non_blocking=True`` on a side CUDA stream, and the
    consumer's stream waits on that copy's event before it uses the
    batch. On the CPU it yields the host batches as they are."""
    device = torch.device(device)
    if device.type != "cuda":
        yield from iterator
        return
    side = torch.cuda.Stream(device)
    buf = collections.deque()

    def put(batch):
        with torch.cuda.stream(side):
            out = Batch(*(torch.from_numpy(np.ascontiguousarray(a))
                          .pin_memory().to(device, non_blocking=True)
                          for a in batch))
            done = torch.cuda.Event()
            done.record(side)
        return out, done

    def ready(batch, done):
        cur = torch.cuda.current_stream(device)
        cur.wait_event(done)
        for t in batch:
            # Allocated on the side stream, used and freed on this one.
            t.record_stream(cur)
        return batch

    for batch in iterator:
        buf.append(put(batch))
        if len(buf) > depth:
            yield ready(*buf.popleft())
    while buf:
        yield ready(*buf.popleft())
