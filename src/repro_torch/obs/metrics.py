"""Structured per-step metrics stream: JSONL run report + in-memory ring
(the port of ``repro.obs.metrics``, with its schema exactly).

One ``StepMetrics`` record per step:

* ``step``      — the engine step index the record describes;
* ``wall_us``   — host wall-clock of the step call (µs);
* ``counters``  — every scalar diagnostic of the step, by name: per-species
  ``<sp>/count|ke|charge|queue_skew|migrated_*|migration_overflow|
  wall_absorbed|merge_dropped``, MC-source ``n_ionized|birth_overflow|
  <sp>/emitted|emission_overflow``, collision ``coll_*``, and — with
  ``EngineConfig.metrics=True`` — ``<sp>/ring_free`` (free-slot-ring
  occupancy) and ``<sp>/pending_rows`` (in-flight arrivals/births); the
  resilience loop (``runtime/resilience.py``) adds host-side
  ``ckpt/bytes|fetch_us|write_us`` on steps that took a checkpoint;
* ``queues``    — per-species per-queue alive counts (``<sp>/queue_occ``).

Records go to a bounded in-memory ring (the auto-tuner's window) and
optionally to a JSONL file: line 1 is a header record (``kind: "header"``,
schema version, free-form ``config``), every later line one step record
(``kind: "step"``). ``validate_record`` is the schema the tests pin.

``record`` turns the step's diagnostic tensors into host numbers with one
copy to the host, which waits for the step: the one host synchronisation a
step the stream costs. The engine step itself stays free of it.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import tempfile
from typing import Any, Iterable

import numpy as np
import torch

SCHEMA_VERSION = 1


def atomic_write_json(path: str, payload: dict) -> None:
    """Serialize, then atomically replace ``path`` (temp file + rename).

    The dump targets a temp file in the same directory, so a crash or an
    unserializable payload leaves any existing ``path`` untouched, and
    ``os.replace`` is atomic on POSIX within one filesystem.
    """
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=d, prefix=os.path.basename(path) + ".",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as fh:
            json.dump(payload, fh, indent=2, sort_keys=True)
            fh.write("\n")
        os.chmod(tmp, 0o644)      # mkstemp defaults to 0600
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


@dataclasses.dataclass(frozen=True)
class StepMetrics:
    """One engine step's worth of metrics (host-side, plain Python)."""

    step: int
    wall_us: float
    counters: dict[str, float]
    queues: dict[str, list[int]]

    def to_json(self) -> dict:
        return {"schema": SCHEMA_VERSION, "kind": "step", "step": self.step,
                "wall_us": self.wall_us, "counters": self.counters,
                "queues": self.queues}


def host_values(diag: dict) -> dict[str, np.ndarray]:
    """The diag's values as host arrays in their own dtypes. Every tensor
    of the dict goes to the host in one float64 copy, which waits for the
    step that computed them (float32, integer counts and bools round-trip
    float64 exactly)."""
    tensors = {k: v for k, v in diag.items() if isinstance(v, torch.Tensor)}
    out = {k: np.asarray(v) for k, v in diag.items() if k not in tensors}
    if tensors:
        flat = torch.cat([v.detach().reshape(-1).to(torch.float64)
                          for v in tensors.values()]).cpu().numpy()
        at = 0
        for k, v in tensors.items():
            dtype = torch.empty(0, dtype=v.dtype).numpy().dtype
            out[k] = flat[at:at + v.numel()].reshape(v.shape).astype(dtype)
            at += v.numel()
    return {k: out[k] for k in diag}


def from_diag(step: int, wall_us: float, diag: dict) -> StepMetrics:
    """Convert an engine step's diag dict (tensors on any device) into a
    record.

    Scalars land in ``counters``; per-queue occupancy vectors
    (``*/queue_occ``) land in ``queues``. Waits for the diag values — call
    it where the step loop would wait anyway.
    """
    counters: dict[str, float] = {}
    queues: dict[str, list[int]] = {}
    for k, a in host_values(diag).items():
        if k.endswith("/queue_occ"):
            queues[k.rsplit("/", 1)[0]] = [int(x) for x in a]
        elif a.ndim == 0:
            counters[k] = float(a)
    return StepMetrics(step=int(step), wall_us=float(wall_us),
                       counters=counters, queues=queues)


class MetricsStream:
    """Bounded in-memory ring of ``StepMetrics`` + optional JSONL sink.

    Recording is a dict of floats appended to a deque and (if a path was
    given) one ``json.dumps`` line. Use as a context manager or call
    ``close()`` to flush the file.
    """

    def __init__(self, capacity: int = 1024, jsonl_path: str | None = None,
                 config: dict | None = None):
        self.ring: collections.deque[StepMetrics] = collections.deque(
            maxlen=max(int(capacity), 1))
        self._fh = None
        if jsonl_path:
            self._fh = open(jsonl_path, "w")
            header = {"schema": SCHEMA_VERSION, "kind": "header",
                      "config": config or {}}
            self._fh.write(json.dumps(header, sort_keys=True) + "\n")

    def record(self, diag: dict, *, wall_us: float,
               step: int | None = None,
               extra: dict | None = None) -> StepMetrics:
        """Append one step's diag (+ measured host wall time) to the stream.

        ``step`` defaults to a running index (one per ``record`` call).
        ``extra`` adds host-side counters the step cannot see — the
        resilience loop reports checkpoint overhead this way
        (``ckpt/bytes``, ``ckpt/fetch_us``, ``ckpt/write_us``).
        """
        if step is None:
            step = self.ring[-1].step + 1 if self.ring else 0
        m = from_diag(step, wall_us, diag)
        if extra:
            m = dataclasses.replace(
                m, counters={**m.counters,
                             **{k: float(v) for k, v in extra.items()}})
        self.ring.append(m)
        if self._fh is not None:
            self._fh.write(json.dumps(m.to_json(), sort_keys=True) + "\n")
        return m

    def window(self, n: int) -> list[StepMetrics]:
        """The most recent ``n`` records, oldest first."""
        if n <= 0:
            return []
        return list(self.ring)[-n:]

    def summary(self) -> dict:
        """Aggregates over the ring: median wall time, counter totals,
        worst queue skew — the digest the launcher prints."""
        if not self.ring:
            return {}
        walls = sorted(m.wall_us for m in self.ring)
        totals: dict[str, float] = {}
        for m in self.ring:
            for k, v in m.counters.items():
                if k.endswith(("_overflow", "/merge_dropped", "/emitted",
                               "/migrated_left", "/migrated_right",
                               "/wall_absorbed")) or k == "n_ionized" \
                        or k.startswith("ckpt/"):
                    totals[k] = totals.get(k, 0.0) + v
        skew = max((m.counters.get(k, 0.0) for m in self.ring
                    for k in m.counters if k.endswith("/queue_skew")),
                   default=0.0)
        return {"steps": len(self.ring),
                "wall_us_median": walls[len(walls) // 2],
                "totals": totals, "max_queue_skew": skew}

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "MetricsStream":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _is_num(x: Any) -> bool:
    return isinstance(x, (int, float)) and not isinstance(x, bool)


def validate_record(rec: Any) -> list[str]:
    """Schema check of one parsed JSONL record; returns error strings.

    An empty list means the record is valid. This IS the schema contract:
    the tests run every line of a produced stream through it, and external
    consumers can too.
    """
    errs: list[str] = []
    if not isinstance(rec, dict):
        return [f"record is {type(rec).__name__}, not an object"]
    if rec.get("schema") != SCHEMA_VERSION:
        errs.append(f"schema is {rec.get('schema')!r}, "
                    f"expected {SCHEMA_VERSION}")
    kind = rec.get("kind")
    if kind == "header":
        if not isinstance(rec.get("config"), dict):
            errs.append("header config must be an object")
        return errs
    if kind != "step":
        return errs + [f"kind is {kind!r}, expected 'header' or 'step'"]
    if not (isinstance(rec.get("step"), int) and rec["step"] >= 0):
        errs.append(f"step must be a non-negative int, got {rec.get('step')!r}")
    if not (_is_num(rec.get("wall_us")) and rec["wall_us"] >= 0):
        errs.append(f"wall_us must be a non-negative number, "
                    f"got {rec.get('wall_us')!r}")
    counters = rec.get("counters")
    if not isinstance(counters, dict):
        errs.append("counters must be an object")
    else:
        for k, v in counters.items():
            if not isinstance(k, str) or not _is_num(v):
                errs.append(f"counter {k!r}: {v!r} is not a number")
    queues = rec.get("queues")
    if not isinstance(queues, dict):
        errs.append("queues must be an object")
    else:
        for k, v in queues.items():
            if (not isinstance(v, list)
                    or not all(isinstance(x, int) for x in v)):
                errs.append(f"queues[{k!r}] must be a list of ints")
    return errs


def read_jsonl(path: str) -> tuple[dict | None, list[dict]]:
    """Parse a metrics JSONL file into (header record, step records)."""
    header, steps = None, []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            if rec.get("kind") == "header":
                header = rec
            else:
                steps.append(rec)
    return header, steps


def validate_stream(records: Iterable[Any]) -> list[str]:
    """Validate a whole parsed stream (header first, steps monotonic)."""
    errs: list[str] = []
    prev_step = -1
    for i, rec in enumerate(records):
        for e in validate_record(rec):
            errs.append(f"line {i + 1}: {e}")
        if isinstance(rec, dict) and rec.get("kind") == "header" and i != 0:
            errs.append(f"line {i + 1}: header must be the first record")
        if isinstance(rec, dict) and rec.get("kind") == "step":
            s = rec.get("step")
            if isinstance(s, int):
                if s <= prev_step:
                    errs.append(f"line {i + 1}: step {s} not increasing")
                prev_step = s
    return errs
