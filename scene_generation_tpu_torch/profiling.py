"""Named ranges on the profiler's timeline.

``span(name)`` is ``torch.profiler.record_function(name)`` while a
profiler runs on this thread, and a null context otherwise: an entered
``record_function`` costs about ten microseconds of host time even with
no profiler to record it, and the serving path enters several a batch.
A range entered before a profiler starts is not recorded."""
from __future__ import annotations

import contextlib

import torch
from torch.profiler import record_function

_NULL = contextlib.nullcontext()


def span(name: str):
    """A ``record_function`` range named ``name`` when a profiler is on."""
    if torch.autograd._profiler_enabled():
        return record_function(name)
    return _NULL
