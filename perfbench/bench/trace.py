"""A short profiled stretch of steps, and what it shows: the device's busy
intervals (kernels, copies and sets on every stream), the host ranges
open around them, and the breakdown printed with a traced run."""

from __future__ import annotations

import json
import os
import tempfile

from torch.profiler import ProfilerActivity, profile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def capture(runner, steps: int, dev) -> dict:
    """Profile ``steps`` steps of ``runner`` and read the trace. The
    Chrome trace goes to a temporary directory (under ``TMPDIR``) and is
    deleted once read."""
    from perfbench.bench.device import sync

    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    sync(dev)
    with profile(activities=acts) as prof:
        for _ in range(steps):
            runner.advance()
        sync(dev)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return parse(events, steps)


def parse(events: list[dict], steps: int) -> dict:
    """Device intervals (start us, end us, stream, name), host ranges
    (start us, end us, name) of ``user_annotation`` events, and the traced
    window: from the first ``bench/step`` range to the last device or
    benchmark event."""
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            stream = e.get("args", {}).get("stream", e.get("tid"))
            dev.append((ts, ts + dur, stream, str(e.get("name", ""))))
        elif cat == "user_annotation":
            host.append((ts, ts + dur, str(e.get("name", ""))))
    bench = [h for h in host if h[2].startswith("bench/")]
    t0 = min([h[0] for h in bench] or [d[0] for d in dev] or [0.0])
    t1 = max([h[1] for h in bench] + [d[1] for d in dev] or [t0])
    busy, overlap = busy_and_overlap(dev)
    return {"device": dev, "host": host, "steps": steps,
            "window_us": t1 - t0, "t0_us": t0, "busy_us": busy,
            "overlap_us": overlap}


def union(intervals) -> list[tuple[float, float]]:
    """The union of (start, end, ...) intervals as sorted disjoint pairs."""
    out: list[list[float]] = []
    for s, e, *_ in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_and_overlap(intervals) -> tuple[float, float]:
    """(us in which some device operation runs, us in which operations of
    two or more streams run at once)."""
    edges = sorted([(s, 1, st) for s, _, st, *_ in intervals]
                   + [(e, -1, st) for _, e, st, *_ in intervals],
                   key=lambda t: (t[0], t[1]))
    active: dict = {}
    busy = overlap = 0.0
    last = None
    for t, kind, st in edges:
        if last is not None:
            live = sum(1 for c in active.values() if c > 0)
            if live:
                busy += t - last
            if live > 1:
                overlap += t - last
        active[st] = active.get(st, 0) + kind
        last = t
    return busy, overlap


def _innermost(host, t: float) -> str:
    best = None
    for s, e, name in host:
        if s <= t <= e and (best is None or e - s < best[1] - best[0]):
            best = (s, e, name)
    return best[2] if best else "no host range"


def breakdown(tr: dict, top: int = 10) -> dict:
    """Seconds a step: the device operations that took most time, and the
    idle gaps of the device summed by the innermost host range open at
    each gap's middle."""
    steps = tr["steps"]
    ops: dict = {}
    for s, e, _, name in tr["device"]:
        key = name if len(name) <= 100 else name[:97] + "..."
        ops[key] = ops.get(key, 0.0) + (e - s) * 1e-6 / steps
    gaps: dict = {}
    prev = tr["t0_us"]
    for s, e in union(tr["device"]) + [(tr["t0_us"] + tr["window_us"],) * 2]:
        if s > prev:
            name = _innermost(tr["host"], 0.5 * (s + prev))
            gaps[name] = gaps.get(name, 0.0) + (s - prev) * 1e-6 / steps
        prev = max(prev, e)
    return {"device_ops": [[k, v] for k, v in sorted(
                ops.items(), key=lambda kv: -kv[1])[:top]],
            "idle_gaps": [[k, v] for k, v in sorted(
                gaps.items(), key=lambda kv: -kv[1])[:top]]}
