"""Trace annotations for the engine: the paper's Nsight ranges, in PyTorch
(the port of ``repro.obs.tracing``).

Two kinds of range, matching the two places time is spent:

* ``phase_scope(name)`` — around a phase of the engine step, a queue stage
  or a halo collective. It opens a ``torch.profiler.record_function`` range
  (a ``user_annotation`` event of a ``torch.profiler`` trace, mirrored on
  the device timeline as ``gpu_user_annotation``) and, on a CUDA build of
  PyTorch, an NVTX range (``torch.cuda.nvtx.range_push``/``range_pop``), so
  the ranges show in Nsight Systems as the paper's ``nvtxRangePush`` phase
  ranges did. Engine phases use ``engine/<phase>`` names, per-queue
  pipeline stages ``engine/<phase>/q<k>``, halo collectives ``halo/<op>``:
  the reference's names. A CPU-only build of PyTorch has no NVTX, and the
  range is skipped there: it is an annotation, not a computation.
* ``host_span(name)`` — a host-side ``record_function`` range around host
  work (a step-loop iteration, a probe).

``trace_session(profile_dir)`` brackets a run with a ``torch.profiler``
capture of the host and, where there is one, the CUDA device, and writes a
Chrome trace (``*.trace.json``) into the directory (Perfetto or
chrome://tracing open it); ``trace_scope_names`` reads the range names back.

Testing hook: ``capture_scopes()`` records every ``phase_scope`` entered
while it is open. The reference records them while JAX traces its step; the
port enters them as the step runs, so one step of the port enters the names
one trace of the reference does.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Iterator

import torch
from torch.profiler import ProfilerActivity, profile, record_function

# NVTX exists only in a CUDA build of PyTorch
_NVTX = torch.version.cuda is not None

# test hook: when a capture list is installed, phase_scope records every
# name it enters
_capture: list[str] | None = None


@contextlib.contextmanager
def capture_scopes() -> Iterator[list[str]]:
    """Record the names of every ``phase_scope`` entered in the block."""
    global _capture
    prev, _capture = _capture, []
    try:
        yield _capture
    finally:
        _capture = prev


@contextlib.contextmanager
def phase_scope(name: str) -> Iterator[None]:
    """A ``record_function`` range plus an NVTX range, fed to the capture
    hook: annotate a phase of the engine."""
    if _capture is not None:
        _capture.append(name)
    with record_function(name):
        if _NVTX:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if _NVTX:
                torch.cuda.nvtx.range_pop()


def host_span(name: str):
    """A host-side profiler range (``torch.profiler.record_function``)."""
    return record_function(name)


@contextlib.contextmanager
def trace_session(profile_dir: str | None) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace of the block into ``profile_dir``.

    ``None`` (or "") disables capture, so call sites can thread an optional
    ``--profile-dir`` straight through. The directory is created if missing;
    the trace is written when the block ends, as
    ``<dir>/<ms since the epoch>.<pid>.trace.json``.
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
    """The names of the ``user_annotation`` ranges (``phase_scope``,
    ``host_span``) of a Chrome trace ``trace_session`` wrote: the check
    that the engine's annotations reach the trace."""
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    return {e["name"] for e in events
            if e.get("cat") == "user_annotation" and "name" in e}
