"""The periodic §3.3 plasma with the field on (``configs/pic_bit1
.make_field_config``) and its quasi-neutral loads: one domain's
(``wall_state``) and the engine's (``field_engine_state``), and the
launcher's ``--scenario field`` on both paths.

Its numbers are the benchmark configuration's
(``perfbench/configs/bit1-s33-engine-d4q4-e100.json``): the published
test at ``WALL_EPS0``, omega_pe * dt 0.2024.
"""

from __future__ import annotations

import json
import re
from pathlib import Path

import pytest
import torch

import _torch_parity  # noqa: F401  (one torch thread a test process)
from repro_torch.configs import pic_bit1 as configs
from repro_torch.core import pic
from repro_torch.distributed import engine
from repro_torch.launch import pic_run

ROOT = Path(__file__).resolve().parents[1]
BENCH_CONFIG = ROOT / "perfbench" / "configs" / "bit1-s33-engine-d4q4-e100.json"
NC, N = 256, 5120          # 8,192 slots a species: 4 domains x 4 queues


def test_the_preset_is_the_benchmark_configuration():
    cfg = configs.make_field_config()
    want = json.loads(BENCH_CONFIG.read_text())
    for key in ("nc", "dx", "dt", "eps0", "smoothing_passes", "boundary",
                "strategy", "ionization_vth_e"):
        assert getattr(cfg, key) == want[key], key
    assert cfg.eps0 == configs.WALL_EPS0
    assert cfg.field_solve and cfg.ionization == (2, 0, 1)
    assert cfg.ionization_rate == 1e-4 and not cfg.collisions
    assert [(s.name, s.charge, s.mass, s.vth, s.n_init, s.capacity,
             s.weight) for s in cfg.species] == [
        (s["name"], s["charge"], s["mass"], s["vth"], s["n_init"],
         s["capacity"], s["weight"]) for s in want["species"]]
    assert want["load_at"] == [[1, 0]]
    assert pic._carries_rho(cfg)


def _engine_config(domains=4, async_n=4):
    return configs.make_engine_config(
        configs.make_field_config(nc=NC, n=N), domains=domains,
        async_n=async_n, max_migration=256, max_births=256)


@pytest.mark.parametrize("seed", [0, 2_147_483_659])
def test_the_engine_state_loads_each_domains_ions_at_its_electrons(seed):
    ecfg = _engine_config()
    st = configs.field_engine_state(ecfg, seed, device="cpu")
    free = engine.init_engine_state(ecfg, seed, device="cpu")
    ele, ion, neu = st.species
    assert ele.x.shape == (4, ecfg.local_cap(ecfg.pic.species[0]))
    for r in range(4):
        assert torch.equal(ion.x[r], ele.x[r])
        assert torch.equal(ion.alive[r], ele.alive[r])
        # a domain's rows stay in its own slab
        live = ele.x[r][ele.alive[r]]
        assert float(live.min()) >= 0.0 and float(live.max()) < NC / 4
    # the per-domain draw is init_engine_state's, the ions' x aside
    assert torch.equal(ele.x, free.species[0].x)
    assert torch.equal(ion.v, free.species[1].v)
    assert torch.equal(neu.x, free.species[2].x)
    assert torch.equal(ion.x, free.species[0].x)
    # the carried rho is deposited from the loaded rows: zero to rounding,
    # where the free draw's charge noise is of order one
    assert st.rho.shape == (4, NC // 4 + 1)
    assert float(st.rho.abs().max()) < 1e-4 < float(free.rho.abs().max())
    # the generators are where the draw left them
    for g, h in zip(st.gens, free.gens):
        assert torch.equal(g.get_state(), h.get_state())


def test_a_quasi_neutral_load_needs_paired_buffers():
    ecfg = _engine_config()
    sp = engine.init_engine_state(ecfg, 0, device="cpu").species
    short = sp[1].__class__(x=sp[1].x[:, :-4], v=sp[1].v[:, :-4],
                            w=sp[1].w[:, :-4], alive=sp[1].alive[:, :-4])
    with pytest.raises(ValueError, match="quasi-neutral"):
        configs.quasi_neutral((sp[0], short, sp[2]))


def _populations(line: str) -> list[int]:
    return [int(c) for c in re.findall(r"\d+", line.split(":", 1)[1])]


@pytest.mark.parametrize("argv,spans", [
    ([], {"cycle/field", "cycle/push", "cycle/ionize"}),
    (["--domains", "4", "--async-n", "4"],
     {"engine/field", "halo/poisson", "engine/rho/q3", "engine/merge/rho"})],
    ids=["cycle", "engine_d4q4"])
def test_pic_run_runs_the_field_scenario(capsys, argv, spans):
    pic_run.main(["--device", "cpu", "--scenario", "field", "--steps", "3",
                  "--nc", str(NC), "--particles", str(N), "--strategy",
                  "fused", "--phases", *argv])
    lines = capsys.readouterr().out.strip().splitlines()
    head = next(i for i, ln in enumerate(lines) if ln.startswith("3 steps"))
    domains = 4 if argv else 1
    assert lines[head].startswith(f"3 steps, {domains} domain(s), ")
    got = {ln.split(":")[0].strip() for ln in lines if ln.startswith("  ")}
    assert spans <= got
    e, i, n = _populations(lines[head + 1])
    # exact pair accounting of the ionization on a periodic domain
    assert e - N == i - N == N - n >= 0


def test_pic_run_field_refuses_the_walls_and_the_ensemble():
    for extra in (["--see-yield", "0.5"], ["--ensemble", "2"]):
        with pytest.raises(SystemExit):
            pic_run.main(["--device", "cpu", "--scenario", "field",
                          "--steps", "1", *extra])
