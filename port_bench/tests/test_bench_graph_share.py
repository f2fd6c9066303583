"""The reader of ``serve_graph_share`` on traces built by hand, in
``test_bench_program_spans.py``'s form: a window whose model calls hold
no ``model/replay`` range reads 0, one whose calls all replay reads 100,
one with a replay in one of two calls 50; a run without a trace reads
None."""
from __future__ import annotations

import types

import pytest

from port_bench.spec import reader
from port_bench.tests.test_bench_program_spans import fake_run

read = reader("serve_graph_share")


def calls(replayed):
    """Host ranges of one model call a 100 ns, each ``replayed`` one with
    a ``model/replay`` range inside it."""
    host = []
    for i, rep in enumerate(replayed):
        s = 100 + 200 * i
        host += [(s, s + 20, "infer/inputs"), (s + 20, s + 100, "infer/model")]
        if rep:
            host.append((s + 30, s + 90, "model/replay"))
        else:
            host.append((s + 30, s + 90, "model/graph"))
    return host


@pytest.mark.parametrize("replayed,share", [
    ((False, False), 0.0), ((True, True), 100.0), ((False, True), 50.0)])
def test_share_of_calls_that_replay(replayed, share):
    r = fake_run(calls(replayed), batches=len(replayed))
    assert read(r) == share


def test_replay_outside_the_model_call_does_not_count():
    host = calls((False,)) + [(50, 60, "model/replay")]
    assert read(fake_run(host, batches=1)) == 0.0


def test_untraced_run_reads_nothing():
    r = types.SimpleNamespace(kind="serve", trace=None, traced_batches=0)
    assert read(r) is None
