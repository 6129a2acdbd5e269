"""Per-phase timing and scaling metrics of the engine (the port of
``repro.distributed.perf``).

* ``phase_breakdown`` times each cumulative probe of ``engine.PHASES`` and
  differences them: T(push) - T(field) is the push phase, and so on. On a
  CUDA device each probe call is timed by CUDA events around it, after a
  warm-up; on the CPU by the host clock. Raw cumulative medians (with
  min/max) are kept under ``cumulative``; the per-phase times come from the
  monotone envelope (running max, capped at the total), and an inversion
  of the raw medians is flagged, not clamped silently.
* ``queue_stats`` is the per-queue occupancy and skew after a few steps,
  on a private copy of the state.
* ``scaling_metrics`` adds speedup and parallel efficiency to a
  {domains: probe} table; ``write_scaling_json`` writes it atomically.

Times are microseconds a step: medians of ``iters`` calls.
"""

from __future__ import annotations

import copy
import json
import os
import sys
import tempfile
import time

import torch

from repro_torch.distributed import engine as engine_mod

PHASE_LABELS = ("ingest", "field", "push", "collide", "migrate", "merge",
                "diag")


def _time_stats(fn, state, device, *, warmup: int = 1,
                iters: int = 3) -> dict[str, float]:
    """{median, min, max} time of one call in µs: CUDA events around the
    call on a card, the host clock on the CPU."""
    card = device.type == "cuda"
    for _ in range(warmup):
        fn(state)
    if card:
        torch.cuda.synchronize(device)
    times = []
    for _ in range(iters):
        if card:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn(state)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) * 1e3)
        else:
            t0 = time.perf_counter()
            fn(state)
            times.append((time.perf_counter() - t0) * 1e6)
    times.sort()
    return {"median": times[len(times) // 2], "min": times[0],
            "max": times[-1]}


def _consistent_phases(cumulative: dict[str, dict[str, float]]
                       ) -> tuple[dict[str, float], list[str]]:
    """Per-phase times from cumulative probe stats: the monotone envelope
    of the medians (running max, capped at the total), and one flag per
    raw median inversion, classed against the min/max bands."""
    checkpoints = engine_mod.PHASES[:-1]
    total = cumulative["full"]["median"]
    flags: list[str] = []
    prev_name, prev = None, None
    for name in engine_mod.PHASES:
        med = cumulative[name]["median"]
        if prev is not None and med < prev["median"]:
            noise = cumulative[name]["max"] >= prev["min"]
            flags.append(
                f"cumulative[{name}] {med:.0f}us < cumulative[{prev_name}] "
                f"{prev['median']:.0f}us "
                + ("(within min/max noise bands)" if noise
                   else "(beyond min/max noise bands)"))
        prev_name, prev = name, cumulative[name]
    phases: dict[str, float] = {}
    env_prev = 0.0
    for name, label in zip(checkpoints, PHASE_LABELS):
        env = min(max(cumulative[name]["median"], env_prev), total)
        phases[label] = env - env_prev
        env_prev = env
    phases[PHASE_LABELS[-1]] = total - env_prev
    return phases, flags


def phase_breakdown(ecfg, *, iters: int = 3, warmup: int = 1, seed: int = 0,
                    state=None, device="cuda") -> dict:
    """Per-phase step times from the cumulative probes.

    Returns ``{"phases": {label: us}, "total": us, "cumulative":
    {probe: {"median", "min", "max"}}, "flags": [str]}``. The probes do not
    donate, so the same state is fed to every probe and survives."""
    if state is None:
        state = engine_mod.init_engine_state(ecfg, seed, device)
    dev = state.groups[0].x.device
    cumulative = {}
    for upto in engine_mod.PHASES:
        fn = engine_mod.make_engine_step(ecfg, upto=upto, donate=False)
        cumulative[upto] = _time_stats(fn, state, dev, warmup=warmup,
                                       iters=iters)
    phases, flags = _consistent_phases(cumulative)
    return {"phases": phases, "total": cumulative["full"]["median"],
            "cumulative": cumulative, "flags": flags}


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
