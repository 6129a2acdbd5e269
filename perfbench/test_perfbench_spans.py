"""The per-layer metrics that read the program's own spans
(``sources.device_ms``, ``collide.device_ms``) and its per-queue ranges
(``engine.queue_idle_ms``), on synthetic span lists and traces; and the
traced stretch of a tiny CPU run turning the program's recorder on with
no change to the benchmark's code."""

from __future__ import annotations

import argparse
import json

import pytest
import torch

from perfbench import run
from perfbench.bench import files, trace
from perfbench.conftest import CELLS
from repro_torch.obs import tracing


def _span(index, name, parent, step, dev):
    return {"index": index, "name": name, "parent": parent, "step": step,
            "start_ns": index, "end_ns": index + 1, "device_ms": dev}


def _cycle_steps(n, first=0, dev=(4.0, 1.0, 50.0)):
    """``n`` steps of spans: root, push, ionize, collide (device ms
    ``dev[1:]`` and the root's ``dev[0]``)."""
    out = []
    for k in range(n):
        i = first + 4 * k
        out += [_span(i, "cycle/step", None, i, dev[0] + dev[1] + dev[2]),
                _span(i + 1, "cycle/push", i, i, dev[0]),
                _span(i + 2, "cycle/ionize", i, i, dev[1]),
                _span(i + 3, "cycle/collide", i, i, dev[2])]
    return out


def _read(name, ctx):
    return files.metric(name).read(ctx)


def _ctx(steps, tr=None):
    return {"trace": tr or {"steps": steps, "device": [], "host": []}}


def test_device_ms_metrics_read_the_last_traced_steps(monkeypatch):
    # two earlier steps whose ionize read 9 ms, then three traced steps
    recs = _cycle_steps(2, dev=(4.0, 9.0, 50.0)) + _cycle_steps(3, first=8)
    monkeypatch.setattr(tracing, "spans", lambda: recs)
    assert _read("sources.device_ms", _ctx(3)) == pytest.approx(1.0)
    assert _read("collide.device_ms", _ctx(3)) == pytest.approx(50.0)
    assert _read("sources.device_ms", _ctx(5)) == pytest.approx(
        (2 * 9.0 + 3 * 1.0) / 5)


def test_device_ms_metrics_give_nothing_without_their_spans(monkeypatch):
    monkeypatch.setattr(tracing, "spans", lambda: [])
    assert _read("sources.device_ms", _ctx(3)) is None
    no_collide = [r for r in _cycle_steps(3) if r["name"] != "cycle/collide"]
    monkeypatch.setattr(tracing, "spans", lambda: no_collide)
    assert _read("collide.device_ms", _ctx(3)) is None
    off_card = [dict(r, device_ms=None) for r in _cycle_steps(3)]
    monkeypatch.setattr(tracing, "spans", lambda: off_card)
    assert _read("sources.device_ms", _ctx(3)) is None
    # a program with no recorder (the module without ``spans``)
    monkeypatch.delattr(tracing, "spans")
    assert _read("sources.device_ms", _ctx(3)) is None
    assert _read("collide.device_ms", _ctx(3)) is None


# one step over 0..100 us: kernels 0..10, 30..40 and 90..95; the host in
# engine/queue/q0 over 5..50 (its push 12..20, then in engine/ring/q0 over
# 41..50), engine/merge over 55..80
QUEUE_EVENTS = [
    {"ph": "X", "cat": "user_annotation", "name": "bench/step", "ts": 0,
     "dur": 100},
    {"ph": "X", "cat": "user_annotation", "name": "engine/step", "ts": 1,
     "dur": 98},
    {"ph": "X", "cat": "user_annotation", "name": "engine/queue/q0",
     "ts": 5, "dur": 45},
    {"ph": "X", "cat": "user_annotation", "name": "engine/push/q0",
     "ts": 12, "dur": 8},
    {"ph": "X", "cat": "user_annotation", "name": "engine/ring/q0",
     "ts": 41, "dur": 9},
    {"ph": "X", "cat": "user_annotation", "name": "engine/merge", "ts": 55,
     "dur": 25},
    {"ph": "X", "cat": "kernel", "name": "k", "ts": 0, "dur": 10,
     "args": {"stream": 7}},
    {"ph": "X", "cat": "kernel", "name": "k", "ts": 30, "dur": 10,
     "args": {"stream": 9}},
    {"ph": "X", "cat": "kernel", "name": "k", "ts": 90, "dur": 5,
     "args": {"stream": 7}},
]


def test_queue_idle_reads_the_gaps_under_the_queue_ranges():
    tr = trace.parse(QUEUE_EVENTS, steps=1)
    # gaps 10..30 (middle 20: the queue's push), 40..90 (65: merge),
    # 95..100 (97.5: engine/step)
    assert _read("engine.queue_idle_ms", _ctx(1, tr)) == pytest.approx(0.02)
    gaps = dict(trace.breakdown(tr)["idle_gaps"])
    assert gaps["engine/push/q0"] == pytest.approx(20e-6)
    two = trace.parse(QUEUE_EVENTS, steps=2)
    assert _read("engine.queue_idle_ms", _ctx(2, two)) == pytest.approx(0.01)


def test_queue_idle_gives_nothing_without_its_ranges():
    bare = [e for e in QUEUE_EVENTS if "queue" not in e["name"]]
    assert _read("engine.queue_idle_ms",
                 _ctx(1, trace.parse(bare, steps=1))) is None
    host_only = [e for e in QUEUE_EVENTS if e["cat"] != "kernel"]
    assert _read("engine.queue_idle_ms",
                 _ctx(1, trace.parse(host_only, steps=1))) is None


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_records_the_programs_spans(tiny, cell):
    """The traced stretch of a run (a ``torch.profiler`` capture) turns the
    program's recorder on: one root span a traced step, nested spans under
    it. On the CPU no span has device time, so the device metrics give
    nothing."""
    tracing.reset()
    args = argparse.Namespace(workload=cell, seed=2_147_483_903,
                              seconds=0.2, trace=1)
    res = json.loads(json.dumps(run.run_cell(args, torch.device("cpu"),
                                             root=tiny)))
    recs = tracing.spans()
    tracing.reset()
    assert res["correct"] is True
    root = "engine/step" if "engine" in cell else "cycle/step"
    roots = [r for r in recs if r["parent"] is None]
    assert [r["name"] for r in roots] == [root] * files.workload(
        cell, tiny)["trace_steps"]
    assert len(recs) > len(roots)
    assert all(r["device_ms"] is None for r in recs)
    for name in ("sources.device_ms", "collide.device_ms",
                 "engine.queue_idle_ms"):
        assert name not in res["metrics"]
