"""The wall deployment (``configs/pic_bit1.make_wall_config`` and its
quasi-neutral load ``wall_state``): the §3.3 plasma between grounded
absorbing walls with the field on and secondary electron emission.

Its numbers are the benchmark configuration's
(``perfbench/configs/bit1-s33-wall.json``), and its normalisation puts
omega_pe * dt near 0.2, well inside the leapfrog's limit of 2. At a cut
size the port's step follows the reference's from the same state with the
same draws: counts, alive masks and the wall and emission counters exact;
x to rtol = atol = 2e-5; v to 1e-4 of max|v| (E differs by the deposit's
summation order and the precision of the field solve: float64 in the port,
float32 in the reference); the carried rho to rtol = atol = 1e-3, as in
``test_torch_pic.py``.
"""

from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from _torch_parity import n, port_state, step_draws
from repro.core import pic as ref_pic
from repro_torch.configs import pic_bit1 as configs
from repro_torch.core import pic
from repro_torch.launch import pic_run

ROOT = Path(__file__).resolve().parents[1]
BENCH_CONFIG = ROOT / "perfbench" / "configs" / "bit1-s33-wall.json"
NC, N = 256, 4096
STEPS = 5


def omega_pe_dt(cfg) -> float:
    e = cfg.species[0]
    density = e.n_init * e.weight / (cfg.nc * cfg.dx)
    return math.sqrt(density * e.charge ** 2 / (cfg.eps0 * e.mass)) * cfg.dt


def test_the_preset_is_the_benchmark_configuration():
    cfg = configs.make_wall_config()
    want = json.loads(BENCH_CONFIG.read_text())
    for key in ("nc", "dx", "dt", "eps0", "smoothing_passes", "boundary",
                "strategy", "emission_yield", "emission_vth",
                "emission_weight"):
        assert getattr(cfg, key) == want[key], key
    assert [list(p) for p in cfg.wall_emission] == want["wall_emission"]
    assert cfg.field_solve and cfg.ionization is None and not cfg.collisions
    assert [(s.name, s.charge, s.mass, s.vth, s.n_init, s.capacity,
             s.weight) for s in cfg.species] == [
        (s["name"], s["charge"], s["mass"], s["vth"], s["n_init"],
         s["capacity"], s["weight"]) for s in want["species"]]
    assert cfg.species[0].capacity == configs.CAPACITY
    assert pic._carries_rho(cfg) and pic._stackable(cfg)


def test_the_normalisation_is_well_inside_the_leapfrog_limit():
    cfg = configs.make_wall_config()
    assert omega_pe_dt(cfg) == pytest.approx(
        math.sqrt(102.4 / 100.0) * 0.2, rel=1e-12)
    assert omega_pe_dt(cfg) < 0.25
    # the Debye length is about a cell
    e = cfg.species[0]
    assert e.vth * cfg.dt / omega_pe_dt(cfg) == pytest.approx(0.988,
                                                             abs=1e-3)


def test_the_wall_state_loads_the_ions_at_the_electrons():
    cfg = configs.make_wall_config(nc=NC, n=N)
    st = configs.wall_state(cfg, 3, device="cpu")
    free = pic.init_state(cfg, 3, device="cpu")
    ele, ion = st.species[0], st.species[1]
    assert torch.equal(ion.x, ele.x) and torch.equal(ion.alive, ele.alive)
    assert torch.equal(ion.v, free.species[1].v)
    assert torch.equal(st.species[2].x, free.species[2].x)
    # the paired charges cancel to the deposit's rounding
    assert float(st.rho.abs().max()) < 1e-4 < float(free.rho.abs().max())
    assert torch.equal(st.rho, pic.compute_rho(cfg, st.species))


def _ref_config(cfg):
    """The reference's PICConfig with the port's fields."""
    d = dataclasses.asdict(cfg)
    d["species"] = tuple(ref_pic.SpeciesConfig(**s) for s in d["species"])
    return ref_pic.PICConfig(**d)


def test_the_wall_step_matches_the_reference():
    cfg = configs.make_wall_config(nc=NC, n=N)
    rcfg = _ref_config(cfg)
    jstate = ref_pic.init_state(rcfg, 0)
    pstate = port_state(cfg, jstate)
    jstep = jax.jit(lambda s: ref_pic.step_fn(s, rcfg))
    absorbed = emitted = 0
    for _ in range(STEPS):
        draws = step_draws(cfg, jstate.key)
        jstate, jd = jstep(jstate)
        pstate, pd = pic.step_fn(pstate, cfg, draws=draws)
        assert set(pd) == set(jd)
        for k in jd:
            if k.endswith(("count", "emitted", "emission_dropped",
                           "absorbed_left", "absorbed_right")):
                assert int(n(pd[k])) == int(n(jd[k])), k
        absorbed += int(n(pd["e/absorbed_left"])) + int(
            n(pd["e/absorbed_right"]))
        emitted += int(n(pd["e/emitted"]))
        for jb, pb in zip(jstate.species, pstate.species):
            np.testing.assert_array_equal(n(pb.alive), n(jb.alive))
            np.testing.assert_allclose(n(pb.x), n(jb.x), rtol=2e-5,
                                       atol=2e-5)
            jv = n(jb.v)
            assert (np.abs(n(pb.v) - jv) <= 1e-4 * np.abs(jv).max()).all()
            np.testing.assert_allclose(n(pb.w), n(jb.w), rtol=2e-5,
                                       atol=2e-5)
        np.testing.assert_allclose(n(pstate.rho), n(jstate.rho), rtol=1e-3,
                                   atol=1e-3)
    assert absorbed > 0 and emitted > 0, (absorbed, emitted)
    n_e = int(pstate.species[0].count())
    assert n_e - N == emitted - absorbed


def test_pic_run_runs_the_wall_scenario(capsys):
    pic_run.main(["--device", "cpu", "--scenario", "wall", "--steps", "3",
                  "--nc", str(NC), "--particles", str(N), "--strategy",
                  "fused", "--phases"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("3 steps, 1 domain(s), ")
    spans = [ln.split(":")[0].strip() for ln in lines
             if ln.startswith("  cycle/")]
    assert {"cycle/field", "cycle/push", "cycle/see"} <= set(spans)
    assert "cycle/ionize" not in spans
    walls = next(ln for ln in lines if ln.startswith("wall counters (total)"))
    counts = json.loads(walls.split(": ", 1)[1].replace("'", '"'))
    assert {"e/absorbed_left", "e/absorbed_right", "e/emitted",
            "e/emission_dropped"} <= set(counts)
    final = json.loads(lines[1].split(": ", 1)[1].replace("'", '"'))
    assert final["e/count"] - N == counts["e/emitted"] - (
        counts["e/absorbed_left"] + counts["e/absorbed_right"])
