"""The readers of the program's serving ranges (``metrics/_program.py``):
on a traced CPU run of a serving cell the two host readings are positive
and within the batch's time, the two device readings are None; on a
trace without the program's ranges all four are None; and on traces
built by hand, one of them a CUDA graph's whose device work starts after
the host has left ``infer/model``, the device reading and the launch
count are what the intervals give."""
from __future__ import annotations

import types

import pytest
import torch

from port_bench import run, serve
from port_bench.spec import reader
from port_bench.tests.bench_cells import tiny_cell
from port_bench.trace import Trace

NAMES = ("serve_inputs_ms", "serve_enqueue_ms", "serve_model_busy_ms",
         "serve_launches")


@pytest.fixture(scope="module")
def traced():
    cell = tiny_cell("coco128.serve_b16")
    return serve.run(cell, 2 ** 31 + 17, 1.0, True, torch.device("cpu"),
                     0.0, run.program_entries())


def test_cpu_run(traced):
    inputs = reader("serve_inputs_ms")(traced)
    enqueue = reader("serve_enqueue_ms")(traced)
    assert inputs > 0 and enqueue > 0
    n = traced.traced_batches
    batch_ms = 1e3 * sum(traced.latencies_s[:n]) / n
    assert inputs + enqueue <= batch_ms
    assert reader("serve_model_busy_ms")(traced) is None
    assert reader("serve_launches")(traced) is None


def fake_run(host, spans=None, device=(), batches=2, t0=0, t1=1000):
    trace = Trace.__new__(Trace)
    trace.__dict__.update(
        host=sorted([(t0, t1, "bench/window")] + list(host)),
        spans=dict(spans or {}), device=sorted(device), t0=t0, t1=t1)
    return types.SimpleNamespace(kind="serve", trace=trace,
                                 traced_batches=batches)


def test_no_program_ranges_reads_nothing():
    r = fake_run([(10, 400, "bench/forward_batch"),
                  (20, 30, "cudaLaunchKernel")],
                 spans={"bench/forward_batch": [(25, 390)]},
                 device=[(25, 100, "k"), (200, 390, "k")])
    assert all(reader(name)(r) is None for name in NAMES)


def test_readings_from_intervals():
    host = [
        # Batch 1: inputs 100-150, model 150-400; batch 2: 500-520,
        # 520-700; a model range after the window's end does not count.
        (100, 150, "infer/inputs"), (150, 400, "infer/model"),
        (500, 520, "infer/inputs"), (520, 700, "infer/model"),
        (1000, 1100, "infer/model"),
        (110, 111, "cudaMemcpyAsync"), (160, 161, "cudaLaunchKernel"),
        (170, 171, "cudaLaunchKernelExC"), (180, 181, "aten::add"),
        (510, 511, "cudaMemsetAsync"), (600, 601, "cudaGraphLaunch"),
        (450, 451, "cudaLaunchKernel"),          # between batches
        (1050, 1051, "cuLaunchKernel")]          # outside the window
    # The device intervals of the ranges: the model's own holds what was
    # launched outside its nested ranges, a nested one the rest; the
    # inputs' copies and the read-back start outside the model's host
    # range, the last model range ends after the window.
    spans = {"infer/model": [(160, 170), (600, 620), (1010, 1090)],
             "model/stage": [(180, 300), (640, 800)],
             "infer/inputs": [(105, 140)], "bench/readback": [(410, 440)]}
    # Busy: 160-200 and 250-300 in batch 1's model (two overlapping
    # kernels count once); 600-650 and 780-800 in batch 2's; 320-340, the
    # copies and the read-back lie in neither.
    device = [(105, 140, "copy"), (160, 200, "k"), (170, 190, "k"),
              (250, 300, "copy"), (320, 340, "k"), (410, 440, "copy"),
              (600, 650, "k"), (780, 800, "k")]
    r = fake_run(host, spans, device)
    assert reader("serve_inputs_ms")(r) == pytest.approx(70 / 2 / 1e6)
    assert reader("serve_enqueue_ms")(r) == pytest.approx(430 / 2 / 1e6)
    assert reader("serve_model_busy_ms")(r) == pytest.approx(160 / 2 / 1e6)
    assert reader("serve_launches")(r) == 5 / 2


def test_graph_launch_after_the_host_range():
    # A graph launch returns at once: each batch's device work starts
    # after the host has left infer/model, batch 1's even after the
    # read-back's host range has begun.
    host = [
        (100, 110, "infer/inputs"), (110, 115, "infer/model"),
        (112, 113, "cudaGraphLaunch"), (120, 400, "bench/readback"),
        (121, 122, "cudaMemcpyAsync"),
        (500, 510, "infer/inputs"), (504, 505, "cudaMemcpyAsync"),
        (510, 512, "infer/model"), (511, 512, "cudaGraphLaunch"),
        (515, 800, "bench/readback"), (516, 517, "cudaMemcpyAsync")]
    spans = {"infer/model": [(130, 350), (520, 700)],
             "infer/inputs": [(505, 508)],
             "bench/readback": [(360, 380), (710, 730)]}
    device = [(130, 200, "k"), (250, 350, "k"), (360, 380, "copy"),
              (505, 508, "copy"), (520, 700, "k"), (710, 730, "copy")]
    r = fake_run(host, spans, device)
    assert reader("serve_model_busy_ms")(r) == pytest.approx(350 / 2 / 1e6)
    assert reader("serve_launches")(r) == 3 / 2
