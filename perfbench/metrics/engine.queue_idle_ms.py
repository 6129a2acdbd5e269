"""Milliseconds a traced step in which the device idles while the host is
inside one of the engine's per-queue ranges (``engine/queue/q<k>`` and
the stages and host work nested in it): the device waiting on the host's
issue of the async(n) queues. Each idle gap goes to the host range open
at its middle, as ``trace.breakdown`` attributes the gaps. Nothing where
the trace holds no such range."""

import re

from perfbench.bench.trace import union

QUEUE = re.compile(r"^engine/queue/q\d+$")


def read(ctx):
    tr = ctx["trace"]
    queues = [(s, e) for s, e, name in tr["host"] if QUEUE.match(name)]
    if not queues or not tr["device"]:
        return None
    idle = 0.0
    prev = tr["t0_us"]
    for s, e in union(tr["device"]) + [(tr["t0_us"] + tr["window_us"],) * 2]:
        if s > prev:
            mid = 0.5 * (s + prev)
            if any(a <= mid <= b for a, b in queues):
                idle += s - prev
        prev = max(prev, e)
    return idle * 1e-3 / tr["steps"]
