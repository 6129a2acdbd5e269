"""The measured window: the driver's step, step after step with no
synchronise between steps, in episodes of ``episode_steps`` after each of
which the state goes back to the set-up's snapshot (a device copy, inside
the window). The generators run on, so every episode draws anew."""

from __future__ import annotations

import statistics
import time

import torch
from torch.profiler import record_function


class Runner:
    """Steps a driver through its episodes and keeps each step's
    diagnostics, by episode, for the checks after the window."""

    def __init__(self, driver, episode_steps: int):
        self.driver = driver
        self.episode_steps = int(episode_steps)
        self.pos = 0
        self.episodes: list[list[dict]] = [[]]

    def advance(self) -> None:
        with record_function("bench/step"):
            diag = self.driver.step()
        self.episodes[-1].append(diag)
        self.pos += 1
        if self.pos == self.episode_steps:
            with record_function("bench/restore"):
                self.driver.restore()
            self.pos = 0
            self.episodes.append([])

    def restart(self) -> None:
        """Back to the snapshot, forgetting the diagnostics so far."""
        self.driver.restore()
        self.pos = 0
        self.episodes = [[]]


class _Stamp:
    """A point on the issuing stream: a CUDA event on the card, the host
    clock elsewhere."""

    def __init__(self, dev):
        self.ev = (torch.cuda.Event(enable_timing=True)
                   if dev.type == "cuda" else None)
        if self.ev is not None:
            self.ev.record()
        else:
            self.t = time.perf_counter()

    def ms_to(self, other: "_Stamp") -> float:
        if self.ev is not None:
            return self.ev.elapsed_time(other.ev)
        return (other.t - self.t) * 1e3


def measure(runner: Runner, seconds: float, dev) -> dict:
    """Whole episodes issued until ``seconds`` of host clock have passed,
    then one synchronise: the clock is read only where an episode ends,
    so every run times the same mix of early and late steps. ``step_ms``
    is the window's host time over its steps; each step's own time comes
    from CUDA events recorded on the issuing stream before and after it,
    read after the window."""
    from perfbench.bench.device import sync

    stamps = []
    sync(dev)
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while True:
        a = _Stamp(dev)
        runner.advance()
        stamps.append((a, _Stamp(dev)))
        if runner.pos == 0 and time.perf_counter() >= deadline:
            break
    sync(dev)
    t1 = time.perf_counter()
    times = [a.ms_to(b) for a, b in stamps]
    return {"steps": len(times), "window_s": t1 - t0,
            "step_ms": (t1 - t0) * 1e3 / len(times),
            "step_p90_ms": p90(times), "step_times_ms": times}


def p90(values: list[float]) -> float:
    """The 90th percentile (Python's inclusive quantiles)."""
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=10, method="inclusive")[-1]
