"""The slice as a whole: the port's PIC cycle against the reference's,
started from the same state and fed the same random draws.

The reference's state crosses over with ``state_from_numpy``; each step the
draws the reference takes from its key are handed to the port. Counts,
alive masks and the MC-source diagnostics are exact. Positions and
velocities: rtol = atol = 2e-5 per step of arithmetic that differs only in
rounding (x compared modulo the period); with the field solve on, E
differs by the deposit's summation order and by the precision of the field
solve (float64 in the port, float32 in the reference), so v there is held
to 1e-4 of max|v|. The carried rho matches a fresh deposit of the
carried state to rtol = atol = 1e-3.
"""

import ast
import dataclasses

import jax
import numpy as np
import pytest

from _torch_parity import n, periodic_dist, port_state, step_draws
from repro.configs import pic_bit1 as ref_cfgs
from repro.core import pic as ref_pic
from repro_torch.configs import pic_bit1 as port_cfgs
from repro_torch.core import pic
from repro_torch.launch import pic_run

STEPS = 5
NC, N = 256, 2048


def _configs(name):
    """(reference config, port config) at the test size."""
    out = []
    for cfgs in (ref_cfgs, port_cfgs):
        strategy, field, see = {
            "fused": ("fused", False, False),
            "fused_field": ("fused", True, False),
            "unified": ("unified", False, False),
            "explicit_field": ("explicit", True, False),
            "see_fused_field": ("fused", True, True),
            "fused_field_subcycled": ("fused", True, False),
            "explicit_subcycled": ("explicit", False, False),
        }[name]
        if see:
            cfg = cfgs.make_see_config(nc=NC, n=N, strategy=strategy)
        else:
            cfg = cfgs.make_bench_config(nc=NC, n=N, strategy=strategy)
        if name.endswith("subcycled"):
            # the heavy species push every other step with dt*2
            cfg = dataclasses.replace(cfg, species=[
                dataclasses.replace(sc, stride=1 if sc.name == "e" else 2)
                for sc in cfg.species])
        out.append(dataclasses.replace(cfg, ionization_rate=5e-2,
                                       field_solve=field))
    return out


def _run_both(name, seed=0):
    rcfg, cfg = _configs(name)
    jstate = ref_pic.init_state(rcfg, seed)
    pstate = port_state(cfg, jstate)
    jstep = jax.jit(lambda s: ref_pic.step_fn(s, rcfg))
    history = []
    for _ in range(STEPS):
        draws = step_draws(cfg, jstate.key)
        jstate, jd = jstep(jstate)
        pstate, pd = pic.step_fn(pstate, cfg, draws=draws)
        history.append((jstate, jd, pstate, pd))
    return rcfg, cfg, history


@pytest.mark.parametrize("name", ["fused", "fused_field", "unified",
                                  "explicit_field", "see_fused_field",
                                  "fused_field_subcycled",
                                  "explicit_subcycled"])
def test_cycle_matches_reference(name):
    rcfg, cfg, history = _run_both(name)
    ionized = 0
    for jstate, jd, pstate, pd in history:
        assert set(pd) == set(jd)
        for k in jd:
            if k.endswith(("count", "n_ionized", "birth_overflow",
                           "ionize_dropped", "emitted", "emission_dropped",
                           "absorbed_left", "absorbed_right")):
                assert int(n(pd[k])) == int(n(jd[k])), k
        ionized += int(n(pd["n_ionized"]))
        for jb, pb in zip(jstate.species, pstate.species):
            np.testing.assert_array_equal(n(pb.alive), n(jb.alive))
            if cfg.boundary == "periodic":
                assert periodic_dist(n(pb.x), n(jb.x), cfg.length).max() \
                    <= 2e-5 * cfg.length
            else:
                np.testing.assert_allclose(n(pb.x), n(jb.x), rtol=2e-5,
                                           atol=2e-5)
            jv = n(jb.v)
            band = (1e-4 * np.abs(jv).max() if cfg.field_solve
                    else 2e-5 * (1.0 + np.abs(jv)))
            assert (np.abs(n(pb.v) - jv) <= band).all()
            np.testing.assert_allclose(n(pb.w), n(jb.w), rtol=2e-5,
                                       atol=2e-5)
        assert pstate.step == int(jstate.step)
        if pic._carries_rho(cfg):
            np.testing.assert_allclose(n(pstate.rho), n(jstate.rho),
                                       rtol=1e-3, atol=1e-3)
            np.testing.assert_allclose(
                n(pstate.rho), n(pic.compute_rho(cfg, pstate.species)),
                rtol=1e-3, atol=1e-3)
        else:
            assert pstate.rho is None
    assert ionized > 0, "no pair was born: the test exercises nothing"

    # exact pair / emission accounting against the initial populations
    final = history[-1][2]
    n_e, n_i, n_d = (int(b.count()) for b in final.species)
    emitted = sum(int(n(h[3].get("e/emitted", 0))) for h in history)
    absorbed = sum(int(n(h[3]["e/absorbed_left"]))
                   + int(n(h[3]["e/absorbed_right"])) for h in history)
    assert n_e - N == ionized + emitted - absorbed
    assert n_i - N == ionized - sum(
        int(n(h[3]["D+/absorbed_left"])) + int(n(h[3]["D+/absorbed_right"]))
        for h in history)
    if cfg.boundary == "periodic":
        assert n_d == N - ionized and n_i - N == ionized
    if name.startswith("see"):
        assert emitted > 0 and absorbed > 0


def test_run_stacks_diagnostics_and_warm_starts_rho():
    _, cfg = _configs("fused_field")
    cfg = dataclasses.replace(cfg, diag_every=2)
    state = pic.init_state(cfg, 3, device="cpu")
    state = dataclasses.replace(state, rho=None)
    final, diags = pic.run(cfg, 4, state=state)
    assert final.step == 4 and final.rho is not None
    counts = n(diags["e/count"])
    assert counts.shape == (4,) and counts[1] == 0 and counts[3] == 0
    assert counts[0] > 0 and counts[2] > 0
    assert np.isfinite(n(diags["field_energy"])).all()


def test_collision_menu_is_refused_until_ported():
    _, cfg = _configs("unified")
    from repro_torch.core.collisions import CollisionConfig
    cfg = dataclasses.replace(
        cfg, collisions=(CollisionConfig("elastic", 0, 2, 1e-3),))
    state = pic.init_state(cfg, 0, device="cpu")
    with pytest.raises(NotImplementedError, match="collision"):
        pic.step_fn(state, cfg)


def test_cuda_entry_points_raise_without_a_card(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, cfg = _configs("fused")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pic.init_state(cfg, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pic.run(cfg, 1)


def test_pic_run_prints_the_reference_summary(capsys):
    pic_run.main(["--device", "cpu", "--steps", "2", "--nc", "256",
                  "--particles", "2048", "--strategy", "fused"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("2 steps, 1 domain(s), async_n=1, "
                               "rebalance_every=0, strategy=fused: ")
    assert lines[0].endswith(" ms/step)")
    assert lines[1].startswith("final populations: ")
    counts = ast.literal_eval(lines[1].split(": ", 1)[1])
    assert set(counts) == {"e/count", "D+/count", "D/count"}
    born = counts["e/count"] - 2048
    assert born == counts["D+/count"] - 2048 == 2048 - counts["D/count"]
