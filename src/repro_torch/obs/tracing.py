"""Trace annotations and the span recorder of the port (the port of
``repro.obs.tracing``, extended with a recorder the reference has not).

``phase_scope(name)`` marks a phase of a step: the cycle's ``cycle/*``
phases (``core/pic.step_fn``), the engine's phases and queue stages
(``engine/<phase>``, ``engine/<phase>/q<k>``) and its halo collectives
(``halo/<op>``), with the reference's names wherever the reference has the
scope; ``PORT_ONLY_SPANS`` lists the names only the port enters. Every
scope opens an NVTX range on a CUDA build of PyTorch
(``torch.cuda.nvtx.range_push``/``range_pop``), so the phases show in
Nsight Systems as the paper's ``nvtxRangePush`` ranges did; a CPU-only
build has no NVTX.

The recorder is off unless a ``recording()`` block is open or a
``torch.profiler`` capture is recording. Off, a scope costs one flag check
besides its NVTX range. On, a scope also

* enters a ``torch.profiler.record_function`` range of the same name when
  a profiler records (a ``user_annotation`` event of its trace), and
* appends one span to a bounded in-memory list: its name, the index of its
  parent span, the step (the index of its root span, shared by every span
  of one step), host start and end in ns on the clock of the profiler's
  Chrome trace (``ts`` us x 1e3 + ``baseTimeNanoseconds``, which is
  ``time.time_ns()``: the monotonic clock plus an offset taken at each
  root span), and, where CUDA is initialised and no CUDA graph is being
  captured, a timing CUDA event recorded on the current stream at entry
  and at exit. The spans of a step captured into a graph have no events;
  a replay runs none of the step's scopes (the engine opens
  ``engine/graph/capture`` and ``engine/graph/replay`` around the two).

Recording synchronises nothing and launches no device operation.
``spans()`` reads the list, each span with ``device_ms`` (the time between
its two events on the device; ``None`` without events), once the caller
has synchronised; it leaves the list as it is, so two readers see the same
spans, and ``reset()`` clears it. ``per_step`` sums spans by name, a step.
One thread records: the spans of a step nest on the thread that runs it.

``trace_session(profile_dir)`` brackets a run with a ``torch.profiler``
capture of the host and, where there is one, the CUDA device, and writes a
Chrome trace (``*.trace.json``) into the directory (Perfetto or
chrome://tracing open it); ``trace_scope_names`` reads the range names back.

Testing hook: ``capture_scopes()`` records every ``phase_scope`` entered
while it is open, on or off. The reference records them while JAX traces
its step; the port enters them as the step runs, so one step of the port
enters the names one trace of the reference does, and the port-only names
besides.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import re
import time
from typing import Iterator

import torch
from torch.profiler import ProfilerActivity, profile, record_function

# NVTX exists only in a CUDA build of PyTorch
_NVTX = torch.version.cuda is not None

# the scopes the port enters and the reference has not; "q<k>" stands for
# a queue's index
PORT_ONLY_SPANS = (
    "cycle/step", "cycle/field", "cycle/push", "cycle/collide", "cycle/see",
    "cycle/ionize", "cycle/diag",
    "engine/step", "engine/buffers", "engine/queue/q<k>",
    "engine/slice/q<k>", "engine/births/q<k>", "engine/ring/q<k>",
    "engine/rho/q<k>", "engine/join", "engine/merge/rho", "engine/release",
    "engine/graph/capture", "engine/graph/replay",
)
_QUEUE = re.compile(r"/q\d+$")

# the most spans the recorder keeps; the oldest go first
MAX_SPANS = 1 << 15

# test hook: when a capture list is installed, phase_scope records every
# name it enters
_capture: list[str] | None = None


def port_only(name: str) -> bool:
    """Whether ``name`` is one of ``PORT_ONLY_SPANS`` (any queue index)."""
    return _QUEUE.sub("/q<k>", name) in PORT_ONLY_SPANS


@contextlib.contextmanager
def capture_scopes() -> Iterator[list[str]]:
    """Record the names of every ``phase_scope`` entered in the block; an
    enclosing block records them too."""
    global _capture
    prev, _capture = _capture, []
    try:
        yield _capture
    finally:
        if prev is not None:
            prev.extend(_capture)
        _capture = prev


class _Span:
    __slots__ = ("index", "name", "parent", "step", "start_ns", "end_ns",
                 "ev0", "ev1")


class _Recorder:
    """The spans kept, the spans open (innermost last) and the switch."""

    def __init__(self):
        self.depth = 0                 # open recording() blocks
        self.kept: collections.deque = collections.deque(maxlen=MAX_SPANS)
        self.open: list[_Span] = []
        self.count = 0                 # spans opened since import
        self.offset_ns = 0
        self.capturing = 0             # open graph_capture() blocks

    def enter(self, name: str) -> _Span:
        sp = _Span()
        sp.index = self.count
        self.count += 1
        sp.name = name
        if self.open:
            sp.parent = self.open[-1].index
            sp.step = self.open[0].index
        else:
            sp.parent = None
            sp.step = sp.index
            self.offset_ns = time.time_ns() - time.perf_counter_ns()
        sp.end_ns = sp.ev0 = sp.ev1 = None
        self.open.append(sp)
        self.kept.append(sp)
        sp.start_ns = time.perf_counter_ns() + self.offset_ns
        return sp

    def exit(self, sp: _Span) -> None:
        while self.open and self.open.pop() is not sp:
            pass
        sp.end_ns = time.perf_counter_ns() + self.offset_ns


_rec = _Recorder()


def _event(stream) -> torch.cuda.Event:
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(stream)
    return ev


class _Scope:
    __slots__ = ("name", "span", "rf", "stream")

    def __init__(self, name: str):
        self.name = name
        self.span = self.rf = self.stream = None

    # the events are recorded inside the span's record_function range, so
    # a profiler puts the recorder's host time down to the span, not to its
    # parent; the stream is looked up once a span (the lookup costs as much
    # as a record)
    def __enter__(self) -> None:
        if _capture is not None:
            _capture.append(self.name)
        profiled = torch.autograd._profiler_enabled()
        if _rec.depth or profiled:
            sp = self.span = _rec.enter(self.name)
            if profiled:
                self.rf = record_function(self.name)
                self.rf.__enter__()
            if torch.cuda.is_initialized() and not _rec.capturing:
                self.stream = torch.cuda.current_stream()
                sp.ev0 = _event(self.stream)
        if _NVTX:
            torch.cuda.nvtx.range_push(self.name)

    def __exit__(self, *exc) -> bool:
        if _NVTX:
            torch.cuda.nvtx.range_pop()
        sp = self.span
        if sp is not None:
            if self.stream is not None:
                sp.ev1 = _event(self.stream)
            if self.rf is not None:
                self.rf.__exit__(*exc)
            _rec.exit(sp)
        return False


def phase_scope(name: str) -> _Scope:
    """A scope around a phase of a step: an NVTX range, fed to the capture
    hook, and with the recorder on, a span and a ``record_function``
    range (see the module's docstring)."""
    return _Scope(name)


@contextlib.contextmanager
def recording() -> Iterator[None]:
    """Turn the recorder on in the block, with or without a profiler."""
    _rec.depth += 1
    try:
        yield
    finally:
        _rec.depth -= 1


@contextlib.contextmanager
def graph_capture() -> Iterator[None]:
    """Mark the block as a CUDA graph capture: the recorder records no
    CUDA event in it (an event recorded on a stream that is not yet part
    of the capture would run outside the graph)."""
    _rec.capturing += 1
    try:
        yield
    finally:
        _rec.capturing -= 1


def reset() -> None:
    """Forget every recorded span."""
    _rec.kept.clear()


def _device_ms(sp: _Span) -> float | None:
    if sp.ev1 is None:
        return None
    try:
        return sp.ev0.elapsed_time(sp.ev1)
    except RuntimeError:       # an event the device has not reached yet
        return None


def spans() -> list[dict]:
    """The recorded spans, oldest first, each as ``{"index", "name",
    "parent", "step", "start_ns", "end_ns", "device_ms"}``; ``end_ns`` is
    ``None`` while a span is open. Read after a synchronise: ``device_ms``
    is ``None`` where an event has not completed."""
    return [{"index": sp.index, "name": sp.name, "parent": sp.parent,
             "step": sp.step, "start_ns": sp.start_ns, "end_ns": sp.end_ns,
             "device_ms": _device_ms(sp)} for sp in list(_rec.kept)]


def per_step(records: list[dict]) -> dict[str, dict]:
    """Host ms, host self ms (less the time its child spans cover) and
    device ms of each span name, summed over the closed spans of
    ``records`` (``spans()``' dicts) and divided by their steps; device ms
    is ``None`` for a name with a span that has none. Names in order of
    first entry."""
    done = [r for r in records if r["end_ns"] is not None]
    steps = len({r["step"] for r in done}) or 1
    child_ns: dict = collections.Counter()
    for r in done:
        if r["parent"] is not None:
            child_ns[r["parent"]] += r["end_ns"] - r["start_ns"]
    out: dict = {}
    for r in done:
        row = out.setdefault(r["name"], {"calls": 0.0, "host_ms": 0.0,
                                         "host_self_ms": 0.0,
                                         "device_ms": 0.0})
        host = (r["end_ns"] - r["start_ns"]) * 1e-6
        row["calls"] += 1.0 / steps
        row["host_ms"] += host / steps
        row["host_self_ms"] += (host - child_ns[r["index"]] * 1e-6) / steps
        if row["device_ms"] is not None and r["device_ms"] is not None:
            row["device_ms"] += r["device_ms"] / steps
        else:
            row["device_ms"] = None
    return out


@contextlib.contextmanager
def trace_session(profile_dir: str | None) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace of the block into ``profile_dir``.

    ``None`` (or "") disables capture, so call sites can thread an optional
    ``--profile-dir`` straight through. The directory is created if missing;
    the trace is written when the block ends, as
    ``<dir>/<ms since the epoch>.<pid>.trace.json``. The recorder is on
    while the capture runs.
    """
    if not profile_dir:
        yield
        return
    os.makedirs(profile_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        profile_dir, f"{int(time.time() * 1e3)}.{os.getpid()}.trace.json"))


def trace_scope_names(path: str) -> set[str]:
    """The names of the ``user_annotation`` ranges (``phase_scope``'s
    ``record_function`` twins) of a Chrome trace ``trace_session`` wrote:
    the check that the annotations reach the trace."""
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    return {e["name"] for e in events
            if e.get("cat") == "user_annotation" and "name" in e}
