"""The field-on engine cell's check on the CPU at the tiny size: the
configuration's quasi-neutral load, whole runs whose timed path breaks the
halo field phase or the carried charge's merge, and the cell's per-layer
metrics on synthetic spans. The port within the limits, the bfloat16
control and the generic broken paths are ``test_perfbench_check.py``'s."""

from __future__ import annotations

import argparse
import json

import pytest
import torch

from perfbench import run
from perfbench.bench import files

CELL = "bit1-s33-engine-d4q4-e100.ionize-field"
CONFIG = "bit1-s33-engine-d4q4-e100"
CPU = torch.device("cpu")


def _run(pb, seed=2_147_483_929) -> dict:
    args = argparse.Namespace(workload=CELL, seed=seed, seconds=0.2,
                              trace=0)
    return json.loads(json.dumps(run.run_cell(args, CPU, root=pb)))


def test_the_driver_loads_each_domains_ions_at_its_electrons(tiny):
    cfg = files.config(CONFIG, tiny)
    drv = files.driver(cfg["driver"], tiny).Driver(
        cfg, files.workload(CELL, tiny), CPU, 7)
    drv.setup()
    ele, ion, neu = drv.s0
    assert torch.equal(ion["x"], ele["x"]) and ion["x"].shape[0] == 4
    assert not torch.equal(neu["x"], ele["x"])
    # the carried charge starts from the loaded rows: zero to rounding
    assert float(drv.e0.rho.abs().max()) < 1e-4
    sp = drv.e0.species
    assert torch.equal(sp[1].x, sp[0].x)


def test_a_field_phase_without_the_halo_sum_is_not_correct(tiny,
                                                           monkeypatch):
    """The timed path's field leaves each shared edge node with one
    domain's half of its charge: the rows' velocities leave the reference's
    global solve."""
    from repro_torch.distributed import halo

    def no_sum(rho_local, *, dx, eps0, smoothing_passes):
        rho = halo.smooth_halo(rho_local, smoothing_passes)
        phi = halo.solve_poisson_halo(rho.double(), dx, eps0)
        return halo.efield_halo(phi, dx).to(rho_local.dtype)

    monkeypatch.setattr(halo, "field_phase", no_sum)
    res = _run(tiny)
    assert res["correct"] is False
    checks = res["checks"]
    assert checks["v_err"]["value"] > checks["v_err"]["limit"], checks


def test_a_merge_without_the_merged_rows_charge_is_not_correct(
        tiny, monkeypatch):
    """The timed path's merge leaves the arrivals' and births' charge out
    of the carried rho."""
    from repro_torch.distributed import engine

    merge = engine._merge

    def merge_without_charge(plan, w):
        before = list(w.rho_acc)
        merge(plan, w)
        w.rho_out = torch.stack(before)

    monkeypatch.setattr(engine, "_merge", merge_without_charge)
    res = _run(tiny)
    assert res["correct"] is False
    checks = res["checks"]
    assert checks["rho_err"]["value"] > checks["rho_err"]["limit"], checks


def test_engine_field_and_rho_device_ms_read_their_spans(monkeypatch):
    from repro_torch.obs import tracing

    def span(i, name, parent, step, dev):
        return {"index": i, "name": name, "parent": parent, "step": step,
                "start_ns": i, "end_ns": i + 1, "device_ms": dev}

    recs = []
    for k in range(3):
        i = 8 * k
        recs += [span(i, "engine/step", None, i, 120.0),
                 span(i + 1, "engine/field", i, i, 1.0 + k),
                 span(i + 2, "engine/migrate/q0", i, i, 2.0),
                 span(i + 3, "engine/rho/q0", i + 2, i, 0.25),
                 span(i + 4, "engine/rho/q1", i + 2, i, 0.5 + k),
                 span(i + 5, "engine/merge", i, i, 3.0),
                 span(i + 6, "engine/merge/rho", i + 5, i, 1.0),
                 span(i + 7, "cycle/field", None, i + 7, 9.0)]
    monkeypatch.setattr(tracing, "spans", lambda: recs)
    ctx = {"trace": {"steps": 2, "device": [], "host": []}}
    field = files.metric("engine.field_device_ms").read
    rho = files.metric("engine.rho_device_ms").read
    assert field(ctx) == pytest.approx(2.5)
    # the last two steps: q0 0.25, q1 0.5 + k, the merge's 1.0
    assert rho(ctx) == pytest.approx((2.75 + 3.75) / 2)
    # a program without the carried-rho spans (the field-off step, or a
    # parent that never opened them) gives nothing
    no_rho = [r for r in recs if "rho" not in r["name"]]
    monkeypatch.setattr(tracing, "spans", lambda: no_rho)
    assert rho(ctx) is None and field(ctx) == pytest.approx(2.5)
    monkeypatch.setattr(tracing, "spans", lambda: [])
    assert rho(ctx) is None and field(ctx) is None
