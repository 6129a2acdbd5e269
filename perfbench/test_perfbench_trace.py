"""The readers of the per-layer metrics, on a small synthetic profiler
trace: the idle union, the overlap of streams, the launches, the roofline
and bytes shares, and the breakdown."""

from __future__ import annotations

import pytest

from perfbench.bench import files, peaks, trace

# two steps over 0..100 us: stream 7 runs a fused launch 10..30 and a copy
# 30..40, stream 8 a kernel 20..50 (overlapping 20..40), then idle until a
# kernel 70..80 on stream 7; the host ranges name the gaps
EVENTS = [
    {"ph": "X", "cat": "user_annotation", "name": "bench/step", "ts": 0,
     "dur": 60},
    {"ph": "X", "cat": "user_annotation", "name": "bench/step", "ts": 60,
     "dur": 40},
    {"ph": "X", "cat": "user_annotation", "name": "engine/merge", "ts": 55,
     "dur": 10},
    {"ph": "X", "cat": "kernel", "name": "void fused_push_deposit_kernel<0>",
     "ts": 10, "dur": 20, "args": {"stream": 7}},
    {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoD", "ts": 30,
     "dur": 10, "args": {"stream": 7}},
    {"ph": "X", "cat": "kernel", "name": "other", "ts": 20, "dur": 30,
     "args": {"stream": 8}},
    {"ph": "X", "cat": "kernel", "name": "other", "ts": 70, "dur": 10,
     "args": {"stream": 7}},
    {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 0, "dur": 5},
    {"ph": "i", "cat": "kernel", "name": "instant", "ts": 1},
]


@pytest.fixture
def ctx():
    tr = trace.parse(EVENTS, steps=2)
    work = {"step_bytes": 3.35e6, "fused_launch_bytes": 3.35e7 * 1e-6,
            "fused_launches": 1}
    return {"trace": tr, "step_ms": 1.0, "work": work, "peaks": peaks}


def test_union_overlap_and_window(ctx):
    tr = ctx["trace"]
    assert tr["window_us"] == 100
    assert trace.union(tr["device"]) == [(10, 50), (70, 80)]
    assert tr["busy_us"] == 50 and tr["overlap_us"] == 20


def _read(name, ctx):
    return files.metric(name).read(ctx)


def test_metric_readers(ctx):
    assert _read("device.idle_pct", ctx) == pytest.approx(50.0)
    assert _read("device.busy_ms", ctx) == pytest.approx(0.025)
    assert _read("step.launches", ctx) == 2.0
    assert _read("engine.stream_overlap_pct", ctx) == pytest.approx(40.0)
    # 3.35e6 B at 3.35e12 B/s is 1 us, over 1 ms a step
    assert _read("step.bytes_bound_pct", ctx) == pytest.approx(0.1)
    # one launch of 33.5 B: 1e-5 us over its 20 us
    assert _read("fused_cycle_roofline", ctx) == pytest.approx(
        100 * 1e-11 / 20e-6)


def test_readers_return_nothing_without_their_events(ctx):
    empty = dict(ctx, trace=trace.parse(EVENTS[:3], steps=2))
    for name in ("device.idle_pct", "device.busy_ms", "step.launches",
                 "engine.stream_overlap_pct", "step.bytes_bound_pct",
                 "fused_cycle_roofline"):
        assert _read(name, empty) is None, name


def test_breakdown_names_ops_and_gaps(ctx):
    b = trace.breakdown(ctx["trace"])
    ops = dict(b["device_ops"])
    assert ops["other"] == pytest.approx(20e-6)
    assert ops["void fused_push_deposit_kernel<0>"] == pytest.approx(10e-6)
    gaps = dict(b["idle_gaps"])
    # 0..10 and 80..100 under bench/step, 50..70 centred on engine/merge
    assert gaps["bench/step"] == pytest.approx(15e-6)
    assert gaps["engine/merge"] == pytest.approx(10e-6)
