"""Faults planted under the timed path, to show that ``correct`` catches
them: each takes the namespace of the program's entries
(``run.program_entries()``) and returns a copy with one entry broken.

- ``unchanged_state`` (training): the step runs and reports its losses,
  then every parameter and Adam moment is put back as it was;
- ``half_batch`` (training): the step sees the first half of each batch,
  so its means are taken over the rest;
- ``altered_answer`` (serving): the first image of each batch comes back
  mirrored left to right.
"""
from __future__ import annotations

import copy
import types

import torch


def unchanged_state(program):
    real = program.train_step

    def train_step(state, batch, draws=None):
        saved = [(p, p.detach().clone()) for _, m, _ in state.trees()
                 for p in m.parameters()]
        moments = [(s, {k: v.clone() if torch.is_tensor(v) else v
                        for k, v in s.items()})
                   for _, _, opt in state.trees() for s in opt.state.values()]
        metrics = real(state, batch, draws)
        with torch.no_grad():
            for p, v in saved:
                p.copy_(v)
        for s, v in moments:
            s.update(v)
        return metrics

    out = copy.copy(program)
    out.train_step = train_step
    return out


def half_batch(program):
    real = program.train_step

    def train_step(state, batch, draws=None):
        n = batch.imgs.shape[0] // 2
        return real(state, program.Batch(*(a[:n] for a in batch)), draws)

    out = copy.copy(program)
    out.train_step = train_step
    return out


def altered_answer(program):
    real = program.InferenceModel

    class Altered(real):
        def forward_batch(self, *args, **kwargs):
            out = super().forward_batch(*args, **kwargs)
            imgs = out.imgs_pred.clone()
            imgs[0] = imgs[0].flip(1)
            return out._replace(imgs_pred=imgs)

    out = copy.copy(program)
    out.InferenceModel = Altered
    return out


FAULTS = {"unchanged_state": unchanged_state, "half_batch": half_batch,
          "altered_answer": altered_answer}


def planted(name: str, program) -> types.SimpleNamespace:
    return FAULTS[name](program)
