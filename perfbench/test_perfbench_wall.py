"""The wall cell's check on the CPU, at 256 cells and 4,096 slots a
species: the port's steps against ``reference/wall_ref.py`` with the same
draws, the bfloat16 control, and whole runs whose timed path drops a
secondary or counts an absorption twice; and the cell's per-layer metrics
on synthetic traces and spans."""

from __future__ import annotations

import argparse
import json

import pytest
import torch

from perfbench import run
from perfbench.bench import files

CELL = "bit1-s33-wall.see"
CPU = torch.device("cpu")


@pytest.fixture
def wall(tiny):
    """The tiny copy with the wall configuration at 256 cells, 2,560 of
    4,096 slots a species alive."""
    path = tiny / "configs" / "bit1-s33-wall.json"
    cfg = json.loads(path.read_text())
    cfg["nc"] = 256
    for s in cfg["species"]:
        s["n_init"], s["capacity"] = 2560, 4096
    path.write_text(json.dumps(cfg))
    return tiny


def _driver(pb, seed):
    cfg = files.config("bit1-s33-wall", pb)
    wl = files.workload(CELL, pb)
    drv = files.driver(cfg["driver"], pb).Driver(cfg, wl, CPU, seed)
    drv.setup()
    return drv, wl


def _run(pb, seed=2_147_483_923) -> dict:
    args = argparse.Namespace(workload=CELL, seed=seed, seconds=0.2,
                              trace=0)
    return json.loads(json.dumps(run.run_cell(args, CPU, root=pb)))


@pytest.mark.parametrize("seed", [5, 2_147_483_659])
def test_port_matches_the_wall_reference(wall, seed):
    drv, wl = _driver(wall, seed)
    nums = drv.check()
    for name, value in nums.items():
        assert value <= wl["limits"][name], (name, value)
    for name in ("row_miss", "count_err", "absorbed_err", "emitted_err"):
        assert nums[name] == 0, (name, nums)
    # the steps exercise both walls and the emission
    gen = torch.Generator().manual_seed(seed)
    steps = drv._program_steps([drv._draws(gen) for _ in range(3)])
    ev = [s["events"] for s in steps]
    assert sum(e["e/absorbed_left"] for e in ev) > 0
    assert sum(e["e/absorbed_right"] for e in ev) > 0
    assert sum(e["e/emitted"] for e in ev) > 0


def test_bfloat16_control_fails_the_wall_check(wall):
    drv, wl = _driver(wall, 5)
    nums = drv.check(control=True)
    assert [k for k, v in nums.items() if v > wl["limits"][k]], nums


def test_a_whole_wall_run_is_correct(wall):
    res = _run(wall)
    assert res["correct"] is True and res["failed"] == 0
    assert res["checks"]["wall_err"]["value"] == 0
    assert res["checks"]["overflow"]["value"] == 0


def test_a_dropped_secondary_is_not_correct(wall, monkeypatch):
    """The timed path counts a secondary as emitted and leaves its slot
    dead: the window's wall accounting fails."""
    from repro_torch.core import boundaries

    inject = boundaries.inject_masked

    def dropping(buf, x, v, w, mask):
        out, dropped, ok = inject(buf, x, v, w, mask)
        fresh = out.alive & ~buf.alive
        if bool(fresh.any()):
            out.alive[int(torch.nonzero(fresh)[0])] = False
        return out, dropped, ok

    monkeypatch.setattr(boundaries, "inject_masked", dropping)
    res = _run(wall)
    assert res["correct"] is False
    assert res["checks"]["wall_err"]["value"] > 0


def test_an_absorption_counted_twice_is_not_correct(wall, monkeypatch):
    """The timed path reports each left-wall absorption of the electrons
    twice: the window's wall accounting fails."""
    from repro_torch.core import pic

    make = pic.make_step

    def make_broken(cfg):
        step = make(cfg)

        def broken(state, *a, **kw):
            out, diag = step(state, *a, **kw)
            diag["e/absorbed_left"] = 2 * diag["e/absorbed_left"]
            return out, diag
        return broken

    monkeypatch.setattr(pic, "make_step", make_broken)
    res = _run(wall)
    assert res["correct"] is False
    assert res["checks"]["wall_err"]["value"] > 0


DEPOSIT = ("void (anonymous namespace)::deposit_kernel(float const*, float "
           "const*, PairAcc, long long, Grid)")
FUSED = ("void (anonymous namespace)::fused_push_deposit_kernel<1, false, "
         "true>(float const*, float const*, float const*)")


def test_deposit_roofline_counts_the_landed_rows():
    """Least bytes: 8 B a landed secondary and 4 B a node a launch, over
    the standalone deposit's launches alone (not the fused kernel's, whose
    name holds ``deposit_kernel``, nor the pair finish)."""
    from perfbench.bench import peaks

    tr = {"steps": 2, "device": [
        (0.0, 50.0, 7, DEPOSIT), (100.0, 150.0, 7, DEPOSIT),
        (0.0, 900.0, 7, FUSED),
        (160.0, 170.0, 7, "void (anonymous namespace)::pair_finish_kernel"
                          "<float2>(float2 const*, float*, int)")]}
    ctx = {"trace": tr, "peaks": peaks,
           "work": {"deposit_rows": 3.0, "deposit_nodes": 102_401}}
    read = files.metric("deposit_roofline").read
    least_s = (8 * 3.0 * 2 + 4 * 102_401 * 2) / peaks.HBM_BYTES_PER_S
    assert read(ctx) == pytest.approx(100.0 * least_s / 100e-6)
    assert read(dict(ctx, work={"step_bytes": 1.0})) is None
    assert read(dict(ctx, trace={"steps": 2, "device": tr["device"][2:]})) \
        is None


def test_field_and_see_device_ms_read_their_spans(monkeypatch):
    from repro_torch.obs import tracing

    def span(i, name, parent, step, dev):
        return {"index": i, "name": name, "parent": parent, "step": step,
                "start_ns": i, "end_ns": i + 1, "device_ms": dev}

    recs = []
    for k in range(3):
        i = 4 * k
        recs += [span(i, "cycle/step", None, i, 13.0),
                 span(i + 1, "cycle/field", i, i, 1.0 + k),
                 span(i + 2, "cycle/push", i, i, 4.0),
                 span(i + 3, "cycle/see", i, i, 7.0)]
    monkeypatch.setattr(tracing, "spans", lambda: recs)
    ctx = {"trace": {"steps": 2, "device": [], "host": []}}
    assert files.metric("field.device_ms").read(ctx) == pytest.approx(2.5)
    assert files.metric("see.device_ms").read(ctx) == pytest.approx(7.0)
    no_see = [r for r in recs if r["name"] != "cycle/see"]
    monkeypatch.setattr(tracing, "spans", lambda: no_see)
    assert files.metric("see.device_ms").read(ctx) is None
