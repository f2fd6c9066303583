"""Plain PyTorch references of the model the benchmark serves and trains.

Written from the paper's architecture (the reference trainer's
``model.py``, ``graph.py``, ``layout.py``, ``layers.py``,
``discriminators.py``, ``losses.py`` and ``trainer.py``) as functions over
a state dict whose keys name the modules as the program names them. They
import nothing of the program and take nothing it made: the benchmark makes
the weights and the inputs and hands the same to both. A caller runs them
in f32 with TF32 off (``no_tf32``).
"""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def no_tf32():
    """True f32 products on the card (cuBLAS and cuDNN), restored after."""
    flags = (torch.backends.cuda.matmul, torch.backends.cudnn)
    prev = [f.allow_tf32 for f in flags]
    for f in flags:
        f.allow_tf32 = False
    try:
        yield
    finally:
        for f, p in zip(flags, prev):
            f.allow_tf32 = p
