"""The check that decides ``correct``, on the CPU at a tiny size: the
program's path against the plain reference with the same draws, the
bfloat16 control, and whole runs with the timed path broken underneath."""

from __future__ import annotations

import argparse
import dataclasses
import json

import pytest
import torch

from perfbench import run
from perfbench.bench import files
from perfbench.conftest import CELLS

CPU = torch.device("cpu")


def _driver(pb, cell, seed=3):
    bench = files.benchmark(pb)
    entry = run.cell_entry(bench, cell)
    cfg = files.config(entry["config"], pb)
    wl = files.workload(cell, pb)
    drv = files.driver(cfg["driver"], pb).Driver(cfg, wl, CPU, seed)
    drv.setup()
    return drv, wl


def _run(pb, cell, seed=2_147_483_901, trace=0) -> dict:
    args = argparse.Namespace(workload=cell, seed=seed, seconds=0.2,
                              trace=trace)
    return json.loads(json.dumps(run.run_cell(args, CPU, root=pb)))


@pytest.mark.parametrize("cell", CELLS)
def test_port_matches_the_reference_within_the_limits(tiny, cell):
    drv, wl = _driver(tiny, cell)
    nums = drv.check()
    for name, value in nums.items():
        assert value <= wl["limits"][name], (name, value)
    assert nums["row_miss"] == 0 and nums["count_err"] == 0


@pytest.mark.parametrize("cell", CELLS)
def test_bfloat16_control_fails_the_check(tiny, cell):
    drv, wl = _driver(tiny, cell)
    nums = drv.check(control=True)
    over = [k for k, v in nums.items() if v > wl["limits"][k]]
    assert over, nums


@pytest.mark.parametrize("cell", CELLS)
def test_a_whole_run_is_correct(tiny, cell):
    res = _run(tiny, cell)
    assert res["correct"] is True
    assert res["attempted"] > 0 and res["failed"] == 0
    bench = files.benchmark(tiny)
    assert set(res["metrics"]) == {
        m["name"] for m in files.cell_metrics(bench, cell, "end_to_end")}
    assert list(res)[-1] == "checks"


def _unchanged(make):
    def make_broken(cfg):
        step = make(cfg)

        def broken(state, *a, **kw):
            _, diag = step(_copy(state), *a, **kw)
            return state, diag
        return broken
    return make_broken


def _copy(state):
    """A state the step may donate without touching ``state``."""
    if hasattr(state, "groups"):
        return dataclasses.replace(
            state, groups=tuple(dataclasses.replace(
                g, **{f.name: getattr(g, f.name).clone()
                      for f in dataclasses.fields(g)})
                for g in state.groups))
    return state


def _altered(make):
    """One particle's position moved by half a cell where it is produced."""
    def make_broken(cfg):
        step = make(cfg)

        def broken(state, *a, **kw):
            out, diag = step(state, *a, **kw)
            x = out.groups[0].x if hasattr(out, "groups") else \
                out.species[0].x
            first = int(torch.nonzero(
                (out.groups[0].alive if hasattr(out, "groups")
                 else out.species[0].alive).reshape(-1))[0])
            x.view(-1)[first] += 0.5
            return out, diag
        return broken
    return make_broken


@pytest.mark.parametrize("fault", [_unchanged, _altered],
                         ids=["state_unchanged", "answer_altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(tiny, cell, fault, monkeypatch):
    from repro_torch.core import pic
    from repro_torch.distributed import engine

    monkeypatch.setattr(pic, "make_step", fault(pic.make_step))
    monkeypatch.setattr(engine, "make_engine_step",
                        fault(engine.make_engine_step))
    assert _run(tiny, cell)["correct"] is False


ENGINE_CELLS = [c for c in CELLS if "engine" in c]


@pytest.mark.parametrize("cell", ENGINE_CELLS)
def test_a_leaver_held_past_the_migration_budget_is_not_correct(
        tiny, cell, monkeypatch):
    """The engine reports a leaver that it kept, clamped, in its old slab:
    the run is not correct, whatever the rows show."""
    from repro_torch.distributed import engine

    make = engine.make_engine_step

    def make_broken(cfg):
        step = make(cfg)

        def broken(state, *a, **kw):
            out, diag = step(state, *a, **kw)
            key = next(k for k in diag if k.endswith("/migration_overflow"))
            diag[key] = diag[key] + 1
            return out, diag
        return broken

    monkeypatch.setattr(engine, "make_engine_step", make_broken)
    res = _run(tiny, cell)
    assert res["correct"] is False
    assert res["checks"]["overflow"]["value"] > 0
