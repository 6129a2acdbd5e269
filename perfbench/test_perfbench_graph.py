"""``engine.graph_replay_pct`` on synthetic span lists: the share of the
traced engine steps whose ``engine/step`` span holds an
``engine/graph/replay`` span; nothing without engine steps, and nothing
from a program that names no such span."""

from __future__ import annotations

import pytest

from perfbench.bench import files
from repro_torch.obs import tracing


def _span(index, name, parent, step):
    return {"index": index, "name": name, "parent": parent, "step": step,
            "start_ns": index, "end_ns": index + 1, "device_ms": None}


def _engine_steps(n, first=0, replay=True):
    """``n`` engine steps: each a root and either a replay span (a graphed
    step) or its phases' spans (an eager one)."""
    out = []
    for k in range(n):
        i = first + 3 * k
        out.append(_span(i, "engine/step", None, i))
        if replay:
            out.append(_span(i + 1, "engine/graph/replay", i, i))
        else:
            out += [_span(i + 1, "engine/ingest", i, i),
                    _span(i + 2, "engine/merge", i, i)]
    return out


def _read(recs, monkeypatch, steps=3):
    monkeypatch.setattr(tracing, "spans", lambda: recs)
    return files.metric("engine.graph_replay_pct").read(
        {"trace": {"steps": steps, "device": [], "host": []}})


def test_replayed_steps_read_100_and_eager_ones_0(monkeypatch):
    assert _read(_engine_steps(3), monkeypatch) == pytest.approx(100.0)
    assert _read(_engine_steps(3, replay=False), monkeypatch) == 0.0


def test_only_the_last_traced_steps_count(monkeypatch):
    # an eager step (the capture's), then three replays: the last 3 read
    # 100, the last 4 read 75
    recs = (_engine_steps(1, replay=False)
            + _engine_steps(3, first=3))
    assert _read(recs, monkeypatch) == pytest.approx(100.0)
    assert _read(recs, monkeypatch, steps=4) == pytest.approx(75.0)


def test_no_engine_step_reads_nothing(monkeypatch):
    cycle = [_span(0, "cycle/step", None, 0), _span(1, "cycle/push", 0, 0)]
    assert _read(cycle, monkeypatch) is None
    assert _read([], monkeypatch) is None


def test_a_program_without_the_replay_span_reads_nothing(monkeypatch):
    monkeypatch.setattr(tracing, "PORT_ONLY_SPANS", tuple(
        n for n in tracing.PORT_ONLY_SPANS if not n.startswith(
            "engine/graph/")))
    assert _read(_engine_steps(3, replay=False), monkeypatch) is None


def test_a_program_without_the_recorder_reads_nothing(monkeypatch):
    monkeypatch.delattr(tracing, "spans")
    assert files.metric("engine.graph_replay_pct").read(
        {"trace": {"steps": 3}}) is None
