"""The field-on cycle cell's check on the CPU at the tiny size: the
configuration's quasi-neutral load, the program's cycle with the field and
ionization on against the plain reference, whole runs whose timed path
loses the push's charge or half of a born pair, and the births' charge
span and its metric. The port within the limits, the bfloat16 control
and the generic broken paths are ``test_perfbench_check.py``'s."""

from __future__ import annotations

import argparse
import dataclasses
import json

import pytest
import torch

from perfbench import run
from perfbench.bench import files, program, state
from perfbench.reference import pic_ref

CELL = "bit1-s33-e100.ionize-field"
CONFIG = "bit1-s33-e100"
CPU = torch.device("cpu")


def _driver(pb, seed=7, driver=None):
    cfg = files.config(CONFIG, pb)
    drv = files.driver(driver or cfg["driver"], pb).Driver(
        cfg, files.workload(CELL, pb), CPU, seed)
    drv.setup()
    return drv


def _run(pb, seed=2_147_483_929) -> dict:
    args = argparse.Namespace(workload=CELL, seed=seed, seconds=0.2,
                              trace=0)
    return json.loads(json.dumps(run.run_cell(args, CPU, root=pb)))


def _rows_rho(drv) -> torch.Tensor:
    sps = [pic_ref.Species(a["x"], a["v"], a["w"], a["alive"])
           for a in drv.s0]
    return pic_ref.charge_density(sps, drv.specs, drv.cfg["nc"],
                                  drv.cfg["dx"], torch.float64)


def test_the_driver_loads_each_ion_at_its_electron(tiny):
    drv = _driver(tiny)
    ele, ion, neu = drv.s0
    assert torch.equal(ion["x"], ele["x"])
    assert not torch.equal(neu["x"], ele["x"])
    # the carried charge of the snapshot is the loaded rows' charge: zero
    # to rounding, where the same seed's rows drawn apart leave a charge
    # noise of whole particles
    rows = _rows_rho(drv)
    assert float((drv.rho0.double() - rows).abs().max()) < 1e-5
    assert float(drv.rho0.abs().max()) < 1e-5
    apart = _driver(tiny, driver="cycle")
    assert float(apart.rho0.abs().max()) > 1.0
    assert float((apart.rho0.double() - _rows_rho(apart)).abs().max()) \
        < 1e-4
    # the timed path starts from that charge
    assert torch.equal(drv.state.rho, drv.rho0)


@pytest.mark.parametrize("seed", [3, 2_147_483_929, 4_294_967_311])
def test_the_cycle_with_field_and_births_agrees_with_the_reference(
        tiny, seed):
    """The program's ``check_steps`` steps, field and ionization on,
    against ``pic_ref.cycle_step`` from the same rows and draws: within
    the cell's limits, births in every run of steps, the same count as
    the reference's."""
    drv = _driver(tiny, seed)
    limits = files.workload(CELL, tiny)["limits"]
    nums = drv.check()
    for name, value in nums.items():
        assert value <= limits[name], (name, value)
    assert nums["row_miss"] == 0 and nums["count_err"] == 0
    gen = state.generator(seed, state.SALT_CHECK, CPU)
    draws = [drv._draws(gen) for _ in range(3)]
    prog = drv._program_steps(draws)
    ref = drv._reference_steps(draws, torch.float32)
    born = [p["events"]["n_ionized"] for p in prog]
    assert sum(born) > 0
    assert born == [r["events"]["n_ionized"] for r in ref]


def test_a_carried_rho_without_the_push_deposit_is_not_correct(
        tiny, monkeypatch):
    """The timed path's push carries no charge to the next field solve:
    only the births' charge is left in the carried rho."""
    from repro_torch.core import pic

    push_all = pic._push_all

    def without_deposit(*a, **kw):
        species, hits, diag, rho = push_all(*a, **kw)
        return species, hits, diag, torch.zeros_like(rho)

    monkeypatch.setattr(pic, "_push_all", without_deposit)
    res = _run(tiny)
    assert res["correct"] is False
    checks = res["checks"]
    assert checks["rho_err"]["value"] > checks["rho_err"]["limit"], checks


def test_a_birth_without_its_ion_is_not_correct(tiny, monkeypatch):
    """The timed path's ionization lands each born electron and kills its
    neutral, but drops the ion of the pair."""
    from repro_torch.core import collisions

    ionize = collisions.ionize

    def without_ion(gen, neu, ele, ion, *a, **kw):
        before = ion.alive.clone()
        neu, ele, ion, d, births = ionize(gen, neu, ele, ion, *a, **kw)
        return neu, ele, dataclasses.replace(ion, alive=before), d, births

    monkeypatch.setattr(collisions, "ionize", without_ion)
    res = _run(tiny)
    assert res["correct"] is False
    checks = res["checks"]
    assert checks["pairs_err"]["value"] > 0, checks
    assert checks["count_err"]["value"] > 0, checks


def _span(i, name, parent, step, dev):
    return {"index": i, "name": name, "parent": parent, "step": step,
            "start_ns": i, "end_ns": i + 1, "device_ms": dev}


def test_births_rho_device_ms_reads_its_span(monkeypatch):
    from repro_torch.obs import tracing

    recs = []
    for k in range(3):
        i = 5 * k
        recs += [_span(i, "cycle/step", None, i, 12.0),
                 _span(i + 1, "cycle/field", i, i, 2.0),
                 _span(i + 2, "cycle/push", i, i, 4.0),
                 _span(i + 3, "cycle/ionize", i, i, 3.0),
                 _span(i + 4, "cycle/ionize/rho", i + 3, i, 0.5 + k)]
    monkeypatch.setattr(tracing, "spans", lambda: recs)
    ctx = {"trace": {"steps": 2, "device": [], "host": []}}
    read = files.metric("births_rho.device_ms").read
    assert read(ctx) == pytest.approx((1.5 + 2.5) / 2)
    # the ionize phase's own metric does not count the span twice
    assert files.metric("sources.device_ms").read(ctx) == pytest.approx(3.0)
    # a step that carries no rho, or a program without the span
    no_rho = [r for r in recs if r["name"] != "cycle/ionize/rho"]
    monkeypatch.setattr(tracing, "spans", lambda: no_rho)
    assert read(ctx) is None
    monkeypatch.setattr(tracing, "spans", lambda: [])
    assert read(ctx) is None


@pytest.mark.parametrize("field", [True, False], ids=["carried", "field_off"])
def test_the_births_rho_span_is_entered_only_where_rho_is_carried(
        tiny, field):
    """One step of the cell's program configuration enters
    ``cycle/ionize/rho`` inside ``cycle/ionize``; with the field off (the
    ``bit1-s33.ionize`` cell's traffic) nothing carries a rho and the span
    is not recorded."""
    from repro_torch.core import pic
    from repro_torch.obs import tracing

    traffic = dict(files.workload(CELL, tiny), field_solve=field)
    pcfg = program.pic_config(files.config(CONFIG, tiny), traffic)
    st = pic.init_state(pcfg, 0, device="cpu")
    tracing.reset()
    with tracing.recording():
        pic.step_fn(st, pcfg)
    recs = tracing.spans()
    tracing.reset()
    names = [r["name"] for r in recs]
    assert "cycle/ionize" in names
    assert ("cycle/ionize/rho" in names) is field
    if field:
        by_index = {r["index"]: r for r in recs}
        rho = recs[names.index("cycle/ionize/rho")]
        assert by_index[rho["parent"]]["name"] == "cycle/ionize"
