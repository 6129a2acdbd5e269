"""The port's span recorder (``repro_torch.obs.tracing``): off, a step
records nothing and enters no ``record_function``; under a profiler, the
cycle's and the engine's spans nest as their code does and each lines up
with its ``user_annotation`` twin in the Chrome trace; ``recording()``
turns it on without a profiler; the list is bounded; ``per_step`` sums by
name; a step's results do not depend on the recorder.
"""

import collections
import dataclasses
import json
import os
import tempfile

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import _torch_parity  # noqa: F401  (one torch thread a test process)
from repro_torch.configs import pic_bit1 as configs
from repro_torch.core import pic
from repro_torch.distributed import engine
from repro_torch.obs import tracing

CYCLE_ORDER = ["cycle/step", "cycle/field", "cycle/push", "cycle/collide",
               "cycle/see", "cycle/ionize", "cycle/diag"]


def _churn(**kw):
    """Every phase of the cycle: field, the collision menu, absorbing
    walls with SEE, MC ionization."""
    return dataclasses.replace(
        configs.make_resilience_config(nc=32, n=256), **kw)


def _cycle_step(cfg=None):
    cfg = cfg or _churn()
    state = pic.init_state(cfg, 0, device="cpu")
    return lambda: pic.step_fn(state, cfg)


def _engine_step():
    ecfg = engine.EngineConfig(pic=_churn(), domains=2, async_n=2,
                               max_migration=64, max_births=64)
    state = engine.init_engine_state(ecfg, 0, device="cpu")
    step = engine.make_engine_step(ecfg, donate=False)
    return lambda: step(state)


@pytest.fixture(autouse=True)
def _fresh():
    tracing.reset()
    yield
    tracing.reset()


@pytest.mark.parametrize("make", [_cycle_step, _engine_step],
                         ids=["cycle", "engine"])
def test_off_records_nothing_and_enters_no_record_function(make,
                                                           monkeypatch):
    entered = []
    monkeypatch.setattr(tracing, "record_function",
                        lambda name: entered.append(name))
    step = make()
    with tracing.capture_scopes() as names:
        step()
    assert tracing.spans() == [] and entered == []
    assert names      # the capture hook sees the scopes all the same


def _twins(path):
    with open(path) as fh:
        doc = json.load(fh)
    base = doc.get("baseTimeNanoseconds", 0)
    out = collections.defaultdict(list)
    for e in doc["traceEvents"]:
        if e.get("cat") == "user_annotation" and e.get("ph") == "X":
            start = e["ts"] * 1e3 + base
            out[e["name"]].append((start, start + e["dur"] * 1e3))
    return {k: sorted(v) for k, v in out.items()}


def _profiled(step):
    """The spans of ``step()`` under a profiler, and the ``user_annotation``
    ranges of the Chrome trace it exports, by name."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step()
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "trace.json")
        prof.export_chrome_trace(path)
        twins = _twins(path)
    return tracing.spans(), twins


def _check_twins(recs, twins):
    """Every span has a ``user_annotation`` twin of its name whose host
    interval is the span's within 1 ms."""
    by_name = collections.defaultdict(list)
    for r in recs:
        by_name[r["name"]].append((r["start_ns"], r["end_ns"]))
    for name, ivs in by_name.items():
        assert len(twins.get(name, [])) == len(ivs), name
        for (s, e), (ts, te) in zip(sorted(ivs), twins[name]):
            assert abs(s - ts) < 1e6 and abs(e - te) < 1e6, (name, s - ts,
                                                               e - te)


def _children(recs, parent):
    return [r["name"] for r in recs if r["parent"] == parent["index"]]


def test_profiled_cycle_step_nests_and_matches_the_trace():
    recs, twins = _profiled(_cycle_step())
    assert [r["name"] for r in recs] == CYCLE_ORDER
    root = recs[0]
    assert root["parent"] is None
    assert _children(recs, root) == CYCLE_ORDER[1:]
    assert {r["step"] for r in recs} == {root["index"]}
    for r in recs:
        assert root["start_ns"] <= r["start_ns"] <= r["end_ns"] \
            <= root["end_ns"]
        assert r["device_ms"] is None          # no card
    _check_twins(recs, twins)


def test_profiled_engine_step_nests_and_matches_the_trace():
    recs, twins = _profiled(_engine_step())
    by_index = {r["index"]: r for r in recs}
    root = recs[0]
    assert root["name"] == "engine/step" and root["parent"] is None
    assert {r["step"] for r in recs} == {root["index"]}
    top = _children(recs, root)
    assert top[:4] == ["engine/ingest", "engine/field", "engine/sources",
                       "engine/collide_setup"]
    assert top[4] == "engine/buffers"
    assert top[-4:] == ["engine/join", "engine/merge", "engine/diag",
                        "engine/release"]
    queues = [r for r in recs if r["name"].startswith("engine/queue/")]
    assert [q["name"] for q in queues] == ["engine/queue/q0",
                                           "engine/queue/q1"] * 2
    for q in queues:
        k = q["name"][-2:]
        assert q["parent"] == root["index"]
        assert _children(recs, q) == [f"engine/{s}/{k}" for s in (
            "slice", "push", "collide", "ionize", "migrate", "ring")]
        ring = next(r for r in recs if r["parent"] == q["index"]
                    and r["name"].startswith("engine/ring/"))
        assert _children(recs, ring) == [f"engine/births/{k}",
                                         f"engine/see/{k}"]
    for r in recs:
        if r["parent"] is not None:
            p = by_index[r["parent"]]
            assert p["start_ns"] <= r["start_ns"] <= r["end_ns"] \
                <= p["end_ns"], r["name"]
    _check_twins(recs, twins)


@pytest.mark.parametrize("kw,step,want", [
    ({}, 0, CYCLE_ORDER),
    ({"field_solve": False}, 0,
     [n for n in CYCLE_ORDER if n != "cycle/field"]),
    ({"collisions": (), "wall_emission": (), "ionization": None}, 0,
     ["cycle/step", "cycle/field", "cycle/push", "cycle/diag"]),
    ({"diag_every": 2}, 1, CYCLE_ORDER[:-1])],
    ids=["all", "field_off", "no_sources", "diag_off_step"])
def test_cycle_phases_enter_in_order(kw, step, want):
    """The ``cycle/*`` scopes in phase order, each only where its phase
    runs."""
    cfg = _churn(**kw)
    state = dataclasses.replace(pic.init_state(cfg, 0, device="cpu"),
                                step=step)
    with tracing.capture_scopes() as names:
        pic.step_fn(state, cfg)
    assert names == want


def _engine_order(field: bool, carried: bool) -> list[str]:
    """The scopes a 2-domain async(2) step of ``_churn`` enters, in order:
    the field's halo scopes where the field is on, the carried rho's where
    it is carried."""
    pp = ["halo/ppermute"] * 2
    names = ["engine/step", "engine/ingest", "engine/field"]
    if field:
        names += (["halo/sum", *pp, "halo/smooth", *pp, "halo/poisson",
                   "halo/efield", *pp])
    names += ["engine/sources", "halo/sum", *pp, "engine/collide_setup",
              "engine/buffers"]
    for _ in range(2):
        for k in range(2):
            names += [f"engine/{s}/q{k}" for s in (
                "queue", "slice", "push", "collide", "ionize", "migrate")]
            names += [f"engine/rho/q{k}"] * carried + pp
            names += [f"engine/{s}/q{k}" for s in ("ring", "births", "see")]
    names += ["engine/join", "engine/merge"]
    names += ["engine/merge/rho"] * carried
    return names + ["engine/diag", "engine/release"]


@pytest.mark.parametrize("field", [False, True], ids=["field_off",
                                                      "field_on"])
def test_engine_phases_enter_in_order(field):
    """A field-off engine step enters the scopes it always has; with the
    field on and the rho carried, the step adds the halo field's scopes and
    ``engine/rho/q<k>`` and ``engine/merge/rho`` around the carried rho's
    deposits."""
    ecfg = engine.EngineConfig(pic=_churn(field_solve=field), domains=2,
                               async_n=2, max_migration=64, max_births=64)
    assert engine._carries_rho(ecfg) is field
    state = engine.init_engine_state(ecfg, 0, device="cpu")
    step = engine.make_engine_step(ecfg, donate=False)
    with tracing.capture_scopes() as names:
        step(state)
    assert names == _engine_order(field, field)


def test_recording_without_a_profiler(monkeypatch):
    """``recording()`` records spans and enters no ``record_function``;
    ``spans()`` leaves the list to the next reader, ``reset()`` clears it;
    each step's spans share its root's index."""
    entered = []
    monkeypatch.setattr(tracing, "record_function",
                        lambda name: entered.append(name))
    step = _cycle_step()
    with tracing.recording():
        step()
        step()
    step()
    recs = tracing.spans()
    assert entered == [] and tracing.spans() == recs
    assert [r["name"] for r in recs] == CYCLE_ORDER * 2
    roots = [r["index"] for r in recs if r["parent"] is None]
    assert [r["step"] for r in recs] == [roots[0]] * 7 + [roots[1]] * 7
    tracing.reset()
    assert tracing.spans() == []


def test_the_span_list_is_bounded():
    with tracing.recording():
        for _ in range(tracing.MAX_SPANS + 5):
            with tracing.phase_scope("x"):
                pass
    recs = tracing.spans()
    assert len(recs) == tracing.MAX_SPANS
    assert recs[-1]["index"] - recs[0]["index"] == tracing.MAX_SPANS - 1


def _rec(index, name, parent, step, start, end, dev=None):
    return {"index": index, "name": name, "parent": parent, "step": step,
            "start_ns": start * 10**6, "end_ns": end * 10**6,
            "device_ms": dev}


def test_per_step_sums_self_and_device_time_by_name():
    recs = [_rec(0, "s", None, 0, 0, 10, 9.0),
            _rec(1, "a", 0, 0, 1, 4, 2.0), _rec(2, "a", 0, 0, 5, 7, 1.0),
            _rec(3, "s", None, 3, 10, 16, 5.0),
            _rec(4, "a", 3, 3, 11, 15, None),
            _rec(5, "open", 3, 3, 15, 0)]
    recs[5]["end_ns"] = None
    got = tracing.per_step(recs)
    assert list(got) == ["s", "a"]
    assert got["s"] == pytest.approx({"calls": 1.0, "host_ms": 8.0,
                                      "host_self_ms": 3.5, "device_ms": 7.0})
    assert got["a"]["calls"] == 1.5
    assert got["a"]["host_ms"] == pytest.approx(4.5)
    assert got["a"]["host_self_ms"] == pytest.approx(4.5)
    assert got["a"]["device_ms"] is None
    assert tracing.per_step([]) == {}


def test_results_do_not_depend_on_the_recorder():
    cfg = _churn()
    outs = []
    for on in (False, True):
        state = pic.init_state(cfg, 0, device="cpu")
        with tracing.recording() if on else tracing.capture_scopes():
            for _ in range(2):
                state, diag = pic.step_fn(state, cfg)
        outs.append((state, diag))
    (a, da), (b, db) = outs
    for sa, sb in zip(a.species, b.species):
        for f in ("x", "v", "w", "alive"):
            assert torch.equal(getattr(sa, f), getattr(sb, f))
    assert torch.equal(a.rho, b.rho)
    assert all(torch.equal(da[k], db[k]) for k in da)
