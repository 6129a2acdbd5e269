"""Per-phase timing and scaling metrics of the engine (the port of
``repro.distributed.perf``).

* ``phase_breakdown`` runs real steps under the span recorder
  (``obs.tracing``) and sums each label's spans (``PHASE_SPANS``): device
  time on a CUDA device, host time on the CPU. Its steps run eagerly
  (``make_engine_step(graph=False)``): a replayed graph opens no phase
  spans. The reference times cumulative probes of its step and
  differences them; the port's step has no probes.
* ``queue_stats`` is the per-queue occupancy and skew after a few steps,
  on a private copy of the state.
* ``scaling_metrics`` adds speedup and parallel efficiency to a
  {domains: probe} table; ``write_scaling_json`` writes it atomically.

Times are microseconds a step, the mean over the recorded steps.
"""

from __future__ import annotations

import collections
import copy
import itertools
import json
import os
import re
import sys
import tempfile

import torch

from repro_torch.distributed import engine as engine_mod
from repro_torch.obs import tracing

PHASE_LABELS = ("ingest", "field", "push", "collide", "migrate", "merge",
                "diag")

# the spans each label sums, "q<k>" standing for any queue index; "diag"
# is the rest of the step: these spans and the host time no span covers
PHASE_SPANS = {
    "ingest": ("engine/ingest",),
    "field": ("engine/field",),
    "push": ("engine/sources", "engine/collide_setup", "engine/buffers",
             "engine/slice/q<k>", "engine/push/q<k>"),
    "collide": ("engine/collide/q<k>",),
    "migrate": ("engine/ionize/q<k>", "engine/migrate/q<k>",
                "engine/ring/q<k>", "engine/join"),
    "merge": ("engine/merge",),
    "diag": ("engine/diag", "engine/release"),
}

# the names of the running sums through each label: the reference's
# cumulative probes
CUMULATIVE = ("ingest", "field", "push", "collide", "migrate", "merge",
              "full")

_QUEUE = re.compile(r"/q\d+$")


def _label_us(table: dict, card: bool) -> tuple[dict[str, float], float]:
    """({label: us}, total us) from a ``tracing.per_step`` table."""
    key = "device_ms" if card else "host_ms"
    ms = collections.Counter()
    for name, row in table.items():
        ms[_QUEUE.sub("/q<k>", name)] += row[key]
    total = ms["engine/step"] * 1e3
    phases = {lbl: sum(ms[n] for n in PHASE_SPANS[lbl]) * 1e3
              for lbl in PHASE_LABELS[:-1]}
    phases["diag"] = total - sum(phases.values())
    return phases, total


def phase_breakdown(ecfg, *, iters: int = 3, warmup: int = 1, seed: int = 0,
                    state=None, device="cuda") -> dict:
    """Per-phase step times from the spans of real steps.

    On a private copy of ``state`` (a new state from ``seed`` when None):
    ``warmup`` steps, then the recorder is reset and ``iters`` steps are
    recorded. Returns ``{"phases": {label: us}, "total": us, "cumulative":
    {probe: {"median", "min", "max"}}, "flags": []}``: a label's time is
    its spans' (``PHASE_SPANS``) and ``total`` is ``engine/step``'s, a
    step; ``cumulative`` holds the running sums through each label, named
    as ``CUMULATIVE``, over the recorded steps. Device time overlaps
    across the queues' streams, so on a card "diag" may come out
    negative."""
    state = (engine_mod.init_engine_state(ecfg, seed, device)
             if state is None else _copy_state(state))
    dev = state.groups[0].x.device
    card = dev.type == "cuda"
    step = engine_mod.make_engine_step(ecfg, graph=False)
    for _ in range(warmup):
        state, _ = step(state)
    tracing.reset()
    with tracing.recording():
        for _ in range(iters):
            state, _ = step(state)
    if card:
        torch.cuda.synchronize(dev)
    records = tracing.spans()
    phases, total = _label_us(tracing.per_step(records), card)
    # a step's spans are contiguous: one thread records whole steps
    runs = [list(itertools.accumulate(
        _label_us(tracing.per_step(list(recs)), card)[0].values()))
        for _, recs in itertools.groupby(records, lambda rec: rec["step"])]
    cumulative = {}
    for i, name in enumerate(CUMULATIVE):
        vals = sorted(run[i] for run in runs)
        cumulative[name] = {"median": vals[len(vals) // 2], "min": vals[0],
                            "max": vals[-1]}
    return {"phases": phases, "total": total, "cumulative": cumulative,
            "flags": []}


def _copy_state(state):
    """A private copy of an EngineState: tensors cloned, generators forked."""
    def clone(x):
        if isinstance(x, torch.Tensor):
            return x.clone()
        if isinstance(x, torch.Generator):
            g = torch.Generator(device=x.device)
            g.set_state(x.get_state())
            return g
        if isinstance(x, tuple):
            return tuple(clone(a) for a in x)
        if hasattr(x, "__dataclass_fields__"):
            return type(x)(**{k: clone(getattr(x, k))
                              for k in x.__dataclass_fields__})
        return copy.copy(x)

    return clone(state)


def queue_stats(ecfg, *, steps: int = 3, seed: int = 0, state=None,
                device="cuda") -> dict:
    """Per-queue occupancy and skew after ``steps`` steps, from the
    engine's diagnostics, on a private copy of ``state`` (the step donates
    its input)."""
    state = (engine_mod.init_engine_state(ecfg, seed, device)
             if state is None else _copy_state(state))
    step = engine_mod.make_engine_step(ecfg)
    diag = {}
    for _ in range(max(steps, 1)):
        state, diag = step(state)
    occ = {k.rsplit("/", 1)[0]: [int(x) for x in v.tolist()]
           for k, v in diag.items() if k.endswith("/queue_occ")}
    skew = {k.rsplit("/", 1)[0]: int(v)
            for k, v in diag.items() if k.endswith("/queue_skew")}
    return {"queue_occ": occ, "queue_skew": skew}


def scaling_metrics(per_domain: dict[int, dict]) -> dict:
    """Speedup and PE = T_ref / (D * T_D) for a {domains: probe} table,
    referenced to the smallest domain count present."""
    ref_d = min(per_domain)
    t_ref = per_domain[ref_d]["total"] * ref_d
    out = {}
    for dcount in sorted(per_domain):
        probe = per_domain[dcount]
        t_d = probe["total"]
        out[dcount] = {
            "phases": dict(probe["phases"]),
            "total": t_d,
            "cumulative_us": {k: dict(v)
                              for k, v in probe["cumulative"].items()},
            "probe_flags": list(probe.get("flags", ())),
            "speedup": t_ref / t_d if t_d else float("nan"),
            "parallel_efficiency": (t_ref / (dcount * t_d) if t_d
                                    else float("nan")),
        }
    return out


def write_scaling_json(path: str, payload: dict) -> None:
    """Write ``payload`` to ``path`` atomically (temp file + rename), so
    an interrupted run never leaves a truncated file."""
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=d, prefix=os.path.basename(path) + ".",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as fh:
            json.dump(payload, fh, indent=2, sort_keys=True)
            fh.write("\n")
        os.chmod(tmp, 0o644)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    print(f"# wrote {path}", file=sys.stderr)
