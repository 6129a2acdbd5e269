"""The port's observability layer (``repro_torch.obs``) against the
reference's (``repro.obs``): the metrics stream's schema, held by the
reference's own ``validate_record``/``validate_stream``; the scope names
one engine step enters, equal to those the reference's trace enters for
the same config; the ranges reaching a ``torch.profiler`` trace; the
metrics toggle bitwise at (D, async_n) in {1, 2, 4}^2; the phase
breakdown read from the spans and the probes' state safety; atomic
artifact writes.
"""

import collections
import dataclasses
import json
import os
import re
import tempfile

import jax
import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (one torch thread a test process)
from repro.configs import pic_bit1 as ref_configs
from repro.distributed import engine as ref_engine
from repro.distributed import perf as ref_perf
from repro.launch.mesh import make_debug_mesh
from repro.obs import metrics as ref_metrics
from repro.obs import tracing as ref_tracing
from repro_torch.configs import pic_bit1 as configs
from repro_torch.core import pic
from repro_torch.distributed import engine, perf
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import tracing


def _cfg(nc=32, n=512, cap=2048, ionization=True):
    """``tests/test_obs.py``'s (e-, D+, D) ionization triple."""
    sp = (
        pic.SpeciesConfig("e", -1.0, 1.0, cap, n, vth=1.0),
        pic.SpeciesConfig("D+", 1.0, 3672.0, cap, n, vth=0.02),
        pic.SpeciesConfig("D", 0.0, 3672.0, cap, n, vth=0.05),
    )
    ion = dict(ionization=(2, 0, 1), ionization_rate=3e-3,
               ionization_vth_e=1.0) if ionization else {}
    return pic.PICConfig(nc=nc, dx=1.0, dt=0.2, species=sp,
                         field_solve=False, boundary="periodic",
                         strategy="fused", **ion)


def _fake_diag(step_seed=0):
    """A diag-shaped dict of tensors like the engine emits."""
    return {
        "e/count": torch.tensor(512 + step_seed, dtype=torch.int32),
        "e/queue_occ": torch.tensor([128, 130, 126, 128 + step_seed],
                                    dtype=torch.int32),
        "e/queue_skew": torch.tensor(4 + step_seed, dtype=torch.int32),
        "e/ke": torch.tensor(1.25, dtype=torch.float64),
        "e/migration_overflow": torch.tensor(0, dtype=torch.int32),
        "n_ionized": np.int32(3),
    }


# ------------------------------------------------------------ metrics stream


def test_metrics_stream_schema_roundtrip():
    """Every record the port's stream writes validates against both
    packages' schema (header first, steps strictly increasing, typed
    fields)."""
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "metrics.jsonl")
        with obs_metrics.MetricsStream(capacity=8, jsonl_path=path,
                                       config={"async_n": 4}) as stream:
            for i in range(5):
                rec = stream.record(_fake_diag(i), wall_us=1000.0 + i)
                assert rec.step == i
                assert rec.queues["e"] == [128, 130, 126, 128 + i]
                assert rec.counters["e/ke"] == 1.25
        header, steps = obs_metrics.read_jsonl(path)
        assert header is not None and header["config"] == {"async_n": 4}
        assert len(steps) == 5
        for validate in (obs_metrics.validate_stream,
                         ref_metrics.validate_stream):
            assert validate([header] + steps) == []
        assert ref_metrics.read_jsonl(path) == (header, steps)
    summary = stream.summary()
    assert summary["steps"] == 5
    assert summary["max_queue_skew"] == 8.0          # 4 + last seed
    assert summary["totals"]["n_ionized"] == 15.0    # 3 per step


def test_metrics_ring_is_bounded():
    stream = obs_metrics.MetricsStream(capacity=3)
    for i in range(10):
        stream.record(_fake_diag(), wall_us=1.0, step=i)
    assert [m.step for m in stream.window(99)] == [7, 8, 9]
    assert stream.window(2)[-1].step == 9
    assert stream.window(0) == []


def test_host_values_keep_dtypes_in_one_copy():
    diag = _fake_diag(2)
    host = obs_metrics.host_values(diag)
    assert list(host) == list(diag)
    for k, v in diag.items():
        want = np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)
        assert host[k].dtype == want.dtype and np.array_equal(host[k], want)


_GOOD = {"schema": 1, "kind": "step", "step": 0, "wall_us": 10.0,
         "counters": {"a": 1.0}, "queues": {"e": [1, 2]}}


@pytest.mark.parametrize("rec", [
    _GOOD, dict(_GOOD, schema=99), dict(_GOOD, step=-1),
    dict(_GOOD, wall_us="fast"), dict(_GOOD, counters={"a": "nope"}),
    dict(_GOOD, queues={"e": [1.5]}), dict(_GOOD, kind="mystery"),
    "not a record", {"schema": 1, "kind": "header", "config": {}},
    {"schema": 1, "kind": "header", "config": "x"}],
    ids=["good", "schema", "step", "wall", "counter", "queue", "kind",
         "string", "header", "bad_header"])
def test_validate_record_equals_the_reference(rec):
    got = obs_metrics.validate_record(rec)
    assert got == ref_metrics.validate_record(rec)
    assert bool(got) == (rec is not _GOOD and rec != {
        "schema": 1, "kind": "header", "config": {}})


def test_validate_stream_equals_the_reference():
    hdr = {"schema": 1, "kind": "header", "config": {}}
    for stream in ([hdr, _GOOD, dict(_GOOD, step=0)], [_GOOD, hdr],
                   [hdr, _GOOD, dict(_GOOD, step=1)]):
        assert (obs_metrics.validate_stream(stream)
                == ref_metrics.validate_stream(stream))
    assert obs_metrics.validate_stream([hdr, _GOOD,
                                        dict(_GOOD, step=1)]) == []
    good = obs_metrics.StepMetrics(0, 10.0, {"a": 1.0}, {"e": [1, 2]})
    assert good.to_json() == ref_metrics.StepMetrics(
        0, 10.0, {"a": 1.0}, {"e": [1, 2]}).to_json()


def test_atomic_write_preserves_existing_on_failure():
    """An unserializable payload must leave the previous artifact intact."""
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "BENCH_test.json")
        obs_metrics.atomic_write_json(path, {"good": 1})
        with pytest.raises(TypeError):
            obs_metrics.atomic_write_json(path, {"bad": object()})
        with open(path) as fh:
            assert json.load(fh) == {"good": 1}
        assert os.listdir(td) == ["BENCH_test.json"]   # no tmp litter


def test_engine_stream_passes_the_reference_validate_stream():
    """Four engine steps with ``metrics=True`` streamed to JSONL: the
    reference's ``validate_stream`` accepts the file, and the ring and
    pending counters are in every record."""
    ecfg = engine.EngineConfig(pic=_cfg(), domains=2, async_n=2,
                               max_migration=64, max_births=64,
                               metrics=True)
    state = engine.init_engine_state(ecfg, 0, device="cpu")
    step = engine.make_engine_step(ecfg)
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "m.jsonl")
        with obs_metrics.MetricsStream(jsonl_path=path,
                                       config={"domains": 2}) as stream:
            for _ in range(4):
                state, diag = step(state)
                stream.record(diag, wall_us=1.0)
        header, steps = ref_metrics.read_jsonl(path)
    assert ref_metrics.validate_stream([header] + steps) == []
    for rec in steps:
        for sp in ("e", "D+", "D"):
            assert f"{sp}/ring_free" in rec["counters"]
            assert f"{sp}/pending_rows" in rec["counters"]
            assert len(rec["queues"][sp]) == 2
    assert steps[-1]["counters"]["e/count"] == int(diag["e/count"])


# ---------------------------------------------------------- trace annotations


def _ref_config(name):
    if name == "resilience":
        return ref_configs.make_resilience_config(nc=32, n=256)
    import sys
    sys.path.insert(0, os.path.dirname(__file__))
    from test_obs import _cfg as ref_cfg
    cfg = ref_cfg(ionization=name != "field")
    return dataclasses.replace(cfg, field_solve=name != "ionize")


def _port_config(name):
    if name == "resilience":
        return configs.make_resilience_config(nc=32, n=256)
    return dataclasses.replace(_cfg(ionization=name != "field"),
                               field_solve=name != "ionize")


@pytest.mark.parametrize("an", [1, 2])
@pytest.mark.parametrize("name", ["field", "ionize", "field_ionize",
                                  "resilience"])
def test_engine_phase_scopes_equal_the_reference(name, an):
    """One step of the port enters the scope names that one trace of the
    reference's step enters (its ``capture_scopes`` around
    ``jax.make_jaxpr``) for the same config at D = 1, each as many times:
    every phase, queue stage (push, collide, ionize, migrate, see) and halo
    collective, once the port-only names (``tracing.PORT_ONLY_SPANS``) are
    dropped. Without SEE the order is the reference's too; with it, the
    port copies a queue's packs to the neighbours before the queue's SEE
    (which waits for the ring chain), the reference after it."""
    rcfg = _ref_config(name)
    mesh = make_debug_mesh(data=1, model=1)
    recfg = ref_engine.EngineConfig(pic=rcfg, axis_names=("data",),
                                    async_n=an, max_migration=64,
                                    max_births=64)
    rstate = ref_engine.init_engine_state(recfg, mesh, 0)
    rstep = ref_engine.make_engine_step(recfg, mesh, donate=False)
    with ref_tracing.capture_scopes() as want:
        jax.make_jaxpr(rstep)(rstate)
    ecfg = engine.EngineConfig(pic=_port_config(name), domains=1,
                               async_n=an, max_migration=64, max_births=64)
    state = engine.init_engine_state(ecfg, 0, device="cpu")
    step = engine.make_engine_step(ecfg)
    with tracing.capture_scopes() as entered:
        step(state)
    got = [n for n in entered if not tracing.port_only(n)]
    assert collections.Counter(got) == collections.Counter(want)
    if name != "resilience":
        assert got == want
    else:
        assert any(s.startswith("engine/see/") for s in got)
    for k in range(an):
        assert f"engine/push/q{k}" in got and f"engine/migrate/q{k}" in got


def test_trace_session_writes_the_engine_ranges():
    """A ``trace_session`` around two engine steps writes a Chrome trace
    whose ``user_annotation`` ranges are the scopes the steps entered (and
    one around them); a None profile dir is a no-op."""
    with tracing.trace_session(None):
        pass
    ecfg = engine.EngineConfig(pic=dataclasses.replace(_cfg(),
                                                       field_solve=True),
                               domains=2, async_n=2, max_migration=64,
                               max_births=64)
    state = engine.init_engine_state(ecfg, 0, device="cpu")
    step = engine.make_engine_step(ecfg)
    with tempfile.TemporaryDirectory() as td:
        profile_dir = os.path.join(td, "trace")
        with tracing.capture_scopes() as seen:
            with tracing.trace_session(profile_dir):
                with tracing.phase_scope("test/host_work"):
                    for _ in range(2):
                        state, _ = step(state)
        files = [os.path.join(profile_dir, f)
                 for f in os.listdir(profile_dir)]
        assert len(files) == 1 and files[0].endswith(".trace.json")
        names = tracing.trace_scope_names(files[0])
    assert set(seen) | {"test/host_work"} <= names
    for want in ("engine/ingest", "engine/field", "engine/push/q0",
                 "engine/push/q1", "engine/migrate/q1", "engine/merge",
                 "engine/diag", "halo/sum", "halo/poisson", "halo/efield",
                 "halo/ppermute"):
        assert want in names, want


def test_port_only_span_names_are_pinned():
    """The names the port enters and the reference has not: the cycle's
    phases, the engine's host work between the reference's scopes and
    its CUDA graph's capture and replay, any queue index standing for
    ``q<k>``; no reference name is one."""
    assert tracing.PORT_ONLY_SPANS == (
        "cycle/step", "cycle/field", "cycle/push", "cycle/collide",
        "cycle/see", "cycle/ionize", "cycle/diag",
        "engine/step", "engine/buffers", "engine/queue/q<k>",
        "engine/slice/q<k>", "engine/births/q<k>", "engine/ring/q<k>",
        "engine/rho/q<k>", "engine/join", "engine/merge/rho",
        "engine/release", "engine/graph/capture", "engine/graph/replay")
    assert tracing.port_only("engine/queue/q12")
    assert tracing.port_only("engine/rho/q3")
    assert tracing.port_only("engine/ring/q0")
    assert not tracing.port_only("engine/queue")
    for name in ("engine/push/q0", "engine/see/q3", "engine/ingest",
                 "engine/merge", "engine/diag", "halo/ppermute",
                 "engine/collide_setup"):
        assert not tracing.port_only(name), name


# ------------------------------------------------------ metrics-toggle parity


@pytest.mark.parametrize("n_q", [1, 2, 4])
@pytest.mark.parametrize("d", [1, 2, 4])
def test_metrics_toggle_bitwise_parity(d, n_q):
    """EngineConfig.metrics is diagnostics-only: final state and the shared
    diag keys are bitwise identical with the toggle on and off."""
    outs = {}
    for flag in (False, True):
        ecfg = engine.EngineConfig(pic=_cfg(), domains=d, async_n=n_q,
                                   max_migration=64, max_births=64,
                                   metrics=flag)
        state = engine.init_engine_state(ecfg, 0, device="cpu")
        step = engine.make_engine_step(ecfg)
        for _ in range(3):
            state, diag = step(state)
        outs[flag] = (engine.to_numpy(state), diag)
    (s_off, d_off), (s_on, d_on) = outs[False], outs[True]
    for group in ("species", "rings", "pending"):
        for a, b in zip(s_off[group], s_on[group]):
            for f in a:
                assert np.array_equal(a[f], b[f]), (d, n_q, group, f)
    for k, v in d_off.items():
        assert torch.equal(v, d_on[k]), (d, n_q, k)
    extra = set(d_on) - set(d_off)
    assert any(k.endswith("/ring_free") for k in extra), (d, n_q)
    assert any(k.endswith("/pending_rows") for k in extra), (d, n_q)


# ----------------------------------------------------------- phase breakdown


def _stats(med, lo=None, hi=None):
    return {"median": float(med), "min": float(lo if lo is not None else med),
            "max": float(hi if hi is not None else med)}


def _breakdown_config(name):
    """D 2 x async(2) with ionization and the field, or D 1 x async(2) with
    the collision menu and SEE walls."""
    if name == "ionize_field":
        return engine.EngineConfig(
            pic=dataclasses.replace(_cfg(), field_solve=True), domains=2,
            async_n=2, max_migration=64, max_births=64)
    cfg = dataclasses.replace(
        _cfg(ionization=False), boundary="absorb", wall_emission=((0, 0),),
        emission_yield=0.7, emission_vth=0.5,
        collisions=configs.make_collision_menu(
            rate_elastic=5e-2, rate_cx=5e-2, rate_coulomb=5e-2))
    return engine.EngineConfig(pic=cfg, domains=1, async_n=2,
                               max_migration=64)


_QUEUE = re.compile(r"/q\d+$")


@pytest.mark.parametrize("name", ["ionize_field", "collide_see"])
def test_phase_breakdown_reads_the_spans(name):
    """On the CPU, each label of ``phase_breakdown`` is the host time of
    its spans (``perf.PHASE_SPANS``), summed by ``tracing.per_step`` over
    the steps it recorded, ``total`` is ``engine/step``'s and "diag" the
    rest; every span directly under the step or under a queue's container
    falls in exactly one label, and no label counts a nested span."""
    ecfg = _breakdown_config(name)
    state = engine.init_engine_state(ecfg, 0, device="cpu")
    probe = perf.phase_breakdown(ecfg, iters=2, warmup=1, state=state)
    recs = tracing.spans()                     # the recorded steps, kept
    assert len({r["step"] for r in recs}) == 2
    table = tracing.per_step(recs)

    def us(pattern):
        return 1e3 * sum(row["host_ms"] for n, row in table.items()
                         if _QUEUE.sub("/q<k>", n) == pattern)

    for lbl in perf.PHASE_LABELS[:-1]:
        want = sum(us(n) for n in perf.PHASE_SPANS[lbl])
        assert probe["phases"][lbl] == pytest.approx(want, rel=1e-9), lbl
    assert probe["total"] == pytest.approx(us("engine/step"), rel=1e-9)
    assert probe["phases"]["diag"] == pytest.approx(
        probe["total"] - sum(probe["phases"][lbl]
                             for lbl in perf.PHASE_LABELS[:-1]), rel=1e-9)
    assert probe["phases"]["diag"] >= us("engine/diag") + us(
        "engine/release")
    assert probe["flags"] == []
    assert tuple(probe["cumulative"]) == perf.CUMULATIVE
    full = probe["cumulative"]["full"]
    assert full["min"] <= probe["total"] <= full["max"]

    def is_queue(r):
        return _QUEUE.sub("/q<k>", r["name"]) == "engine/queue/q<k>"

    containers = {r["index"] for r in recs
                  if r["parent"] is None or is_queue(r)}
    listed = collections.Counter(n for spans in perf.PHASE_SPANS.values()
                                 for n in spans)
    assert max(listed.values()) == 1
    seen = set()
    for r in recs:
        span = _QUEUE.sub("/q<k>", r["name"])
        if r["parent"] in containers and not is_queue(r):
            assert span in listed, span
            seen.add(span)
        elif r["parent"] is not None:
            assert span not in listed, span
    assert {"engine/push/q<k>", "engine/migrate/q<k>", "engine/merge",
            "engine/diag"} <= seen
    if name == "collide_see":
        assert "engine/collide/q<k>" in seen and probe["phases"]["collide"] > 0
    else:
        assert "engine/ionize/q<k>" in seen


def test_scaling_metrics_equal_the_reference():
    probe = {"phases": {lbl: 10.0 for lbl in perf.PHASE_LABELS},
             "total": 70.0, "cumulative": {"full": _stats(70)},
             "flags": ["x"]}
    probe2 = {"phases": {lbl: 5.0 for lbl in perf.PHASE_LABELS},
              "total": 35.0, "cumulative": {"full": _stats(35)}, "flags": []}
    out = perf.scaling_metrics({1: probe, 2: probe2})
    assert out == ref_perf.scaling_metrics({1: probe, 2: probe2})
    assert out[2]["speedup"] == 2.0 and out[1]["probe_flags"] == ["x"]


def test_queue_stats_keeps_caller_state_alive():
    """The probe steps a private copy: the caller's state is unchanged."""
    ecfg = engine.EngineConfig(pic=_cfg(ionization=False), domains=1,
                               async_n=2, max_migration=64)
    state = engine.init_engine_state(ecfg, 0, device="cpu")
    before = engine.to_numpy(state)
    stats = perf.queue_stats(ecfg, steps=2, state=state)
    assert stats["queue_occ"]
    after = engine.to_numpy(state)
    for group in ("species", "rings", "pending"):
        for a, b in zip(before[group], after[group]):
            for f in a:
                assert np.array_equal(a[f], b[f]), (group, f)
    assert all(len(v) == 2 for v in stats["queue_occ"].values())
