"""The test-mode model call replayed as a CUDA graph.

``ModelReplay`` runs a ``SceneModel``'s test-mode forward (eval mode, grad
off, on the card) as one ``torch.cuda.CUDAGraph`` per input signature, in
place of the ~600 small launches a batch that the host issues one eager
op at a time, more slowly than the card runs them. The kernels are the
same; only how they are issued changes. A signature is what the call's
inputs show: the model's device and dtype, ``use_gt_box``, and each
input's name, shape and dtype (so N, O, T and which optional inputs are
given).

- The first call of a signature runs eagerly. It is the warm-up that
  capture needs (the kernels' build and load, cuDNN's choice of
  algorithms, the allocator's first blocks), and a one-off shape never
  pays for a capture.
- The second stages its inputs in static buffers, runs the model once on
  a side stream (the warm-up that ``torch.cuda.graph`` asks for, whose
  outputs the call returns) and captures the model on that stream, in
  the profiler range ``model/capture``.
- Later calls copy their inputs into the buffers and replay the graph in
  ``model/replay``, returning clones of its outputs: a caller may hold one
  call's outputs while it makes the next.

At most ``MAX_GRAPHS`` signatures are held, the least recently used
dropped first. A call on the CPU, in train mode or with grad enabled runs
eagerly, as before. ``_cuda.MODEL_CALLS`` counts the calls by path
(``eager``, ``capture``, ``replay``). ``_cuda.LAUNCHES`` keeps counting
each hand-written kernel once a time it runs on the card: a capture's
launches are taken back (nothing ran), and each replay adds them again.

A graph reads the model's parameters and buffers at the addresses they
had at capture, and its inputs from the current stream: weights changed
in place (``load_state_dict``) are replayed, but a model whose tensors
are replaced (``model.to``) needs a new ``ModelReplay``, and calls are
made on one stream and one thread at a time.
"""
from __future__ import annotations

import collections
from typing import Dict, NamedTuple, Optional

import torch

from scene_generation_tpu_torch.models.model import ModelOutput
from scene_generation_tpu_torch.ops import _cuda
from scene_generation_tpu_torch.profiling import span

MAX_GRAPHS = 4      # captured signatures held
MAX_SEEN = 64       # signatures remembered after one eager call


class _Graph(NamedTuple):
    inputs: Dict[str, torch.Tensor]     # the static input buffers
    graph: torch.cuda.CUDAGraph
    outputs: ModelOutput                # the graph's static outputs
    launches: collections.Counter       # hand-written kernels a replay runs


class Call(NamedTuple):
    """A model call whose inputs are on the device (``ModelReplay.stage``),
    ready to ``run``."""
    path: str                           # "eager", "capture" or "replay"
    inputs: Dict[str, torch.Tensor]
    use_gt_box: bool
    key: tuple = ()                     # the signature (capture, replay)


class ModelReplay:
    """One model's captured signatures (see the module's docstring)."""

    def __init__(self, model: torch.nn.Module):
        self.model = model
        self._graphs: "collections.OrderedDict[tuple, _Graph]" = (
            collections.OrderedDict())
        self._seen: "collections.OrderedDict[tuple, None]" = (
            collections.OrderedDict())
        self._stream: Optional[torch.cuda.Stream] = None

    def stage(self, host: Dict[str, torch.Tensor],
              use_gt_box: bool) -> Call:
        """Put ``host``, the model's tensor arguments by name on the host,
        on the model's device: copied into a captured signature's static
        buffers, else onto new tensors."""
        weight = next(self.model.parameters())
        device = weight.device
        if (device.type != "cuda" or self.model.training
                or torch.is_grad_enabled()):
            return Call("eager", _to(host, device), use_gt_box)
        key = (device, weight.dtype, use_gt_box) + tuple(
            (k, tuple(v.shape), v.dtype) for k, v in sorted(host.items()))
        graph = self._graphs.get(key)
        if graph is not None:
            self._graphs.move_to_end(key)
            for k, v in host.items():
                graph.inputs[k].copy_(v)
            return Call("replay", graph.inputs, use_gt_box, key)
        if key in self._seen:
            del self._seen[key]
            return Call("capture", _to(host, device), use_gt_box, key)
        self._seen[key] = None
        if len(self._seen) > MAX_SEEN:
            self._seen.popitem(last=False)
        return Call("eager", _to(host, device), use_gt_box)

    def run(self, call: Call) -> ModelOutput:
        """The model's output for a staged call."""
        if call.path == "replay":
            with span("model/replay"):
                graph = self._graphs[call.key]
                graph.graph.replay()
                _cuda.LAUNCHES.update(graph.launches)
                out = ModelOutput(*(None if t is None else t.clone()
                                    for t in graph.outputs))
        elif call.path == "capture":
            with span("model/capture"):
                out = self._capture(call)
        else:
            out = self.model(**call.inputs, use_gt_box=call.use_gt_box)
        _cuda.MODEL_CALLS[call.path] += 1
        return out

    def _capture(self, call: Call) -> ModelOutput:
        """Run the call once on the side stream, then capture it there;
        the first run's outputs are the call's."""
        device = next(self.model.parameters()).device
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
        side, cur = self._stream, torch.cuda.current_stream(device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = self.model(**call.inputs, use_gt_box=call.use_gt_box)
        cur.wait_stream(side)
        for t in out:
            if t is not None:
                t.record_stream(cur)
        before = collections.Counter(_cuda.LAUNCHES)
        graph = torch.cuda.CUDAGraph()
        try:
            # thread_local: other threads' CUDA calls (a loader, a server's
            # handlers) stay legal while this thread captures.
            with torch.cuda.graph(graph, stream=side,
                                  capture_error_mode="thread_local"):
                static = self.model(**call.inputs,
                                    use_gt_box=call.use_gt_box)
            launches = collections.Counter(_cuda.LAUNCHES) - before
        finally:
            _cuda.LAUNCHES.clear()
            _cuda.LAUNCHES.update(before)
        self._graphs[call.key] = _Graph(call.inputs, graph, static, launches)
        if len(self._graphs) > MAX_GRAPHS:
            self._graphs.popitem(last=False)
        return out


def _to(host: Dict[str, torch.Tensor],
        device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: v.to(device) for k, v in host.items()}
