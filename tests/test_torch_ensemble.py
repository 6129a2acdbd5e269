"""The port's ensemble engine (``repro_torch.serve.ensemble``) against its
own solo step and against the reference's ensemble.

* **member = solo run, bitwise** — the port loops its members through
  ``pic.step_fn`` (no vmap), so a member stepped beside others is the same
  computation as the member stepped alone: every leaf, the generator state
  and the diagnostics' rows equal bit for bit (stronger than the
  reference's exact-events contract, ``tests/test_ensemble.py``);
* **member = reference member** — on the reference member's draws, each
  member within ``tests/test_torch_pic.py``'s bands of the reference's
  vmapped member (counts, masks and event counters exact);
* **parked slots** — launch nothing, keep their tensors bit for bit and
  report zero diagnostics; with no slot active the step still returns
  every key of ``pic.diag_spec``;
* validation of width and strategy, as the reference's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import n, port_state, step_draws
from repro.configs import pic_bit1 as ref_cfgs
from repro.core import params as ref_params
from repro.serve import ensemble as ref_ens
from repro_torch.configs import pic_bit1 as port_cfgs
from repro_torch.core import pic
from repro_torch.core.params import runtime_params
from repro_torch.serve import ensemble


def _cfg(cfgs=port_cfgs, strategy="fused", n=256, field=False):
    cfg = cfgs.make_resilience_config(nc=64, n=n, strategy=strategy,
                                      field_solve=field)
    return dataclasses.replace(cfg, b_field=(0.0, 0.0, 0.02),
                               ionization_rate=5e-2)


def _same_state(a, b, ctx=""):
    for i, (x, y) in enumerate(zip(a.species, b.species)):
        for f in ("x", "v", "w", "alive"):
            assert torch.equal(getattr(x, f), getattr(y, f)), (ctx, i, f)
    assert (a.rho is None) == (b.rho is None)
    assert a.rho is None or torch.equal(a.rho, b.rho), ctx
    assert a.step == b.step, ctx
    assert torch.equal(a.gen.get_state(), b.gen.get_state()), ctx


def _two_members(cfg, steps):
    rp0 = runtime_params(cfg, dt=0.4, ionization_rate=2e-2, device="cpu")
    rp1 = runtime_params(cfg, dt=0.6, emission_yield=0.3, device="cpu")
    es = ensemble.init_ensemble(cfg, 3, device="cpu")
    mk = ensemble.make_member_init(cfg, device="cpu")
    ins = ensemble.make_member_insert(cfg)
    es = ins(es, mk(10), rp0, 0)
    es = ins(es, mk(3), rp1, 2)
    step = ensemble.make_ensemble_step(cfg)
    diags = []
    for _ in range(steps):
        es, d = step(es)
        diags.append(d)
    return es, diags, (rp0, rp1)


@pytest.mark.parametrize("strategy,field", [("fused", False),
                                            ("fused", True),
                                            ("unified", False)])
def test_member_equals_solo_run_bitwise(strategy, field):
    cfg = _cfg(strategy=strategy, field=field)
    es, ediags, (rp0, rp1) = _two_members(cfg, 4)
    for slot, seed, rp in ((0, 10, rp0), (2, 3, rp1)):
        solo = pic.init_state(cfg, seed, device="cpu")
        for k in range(4):
            solo, d = pic.step_fn(solo, cfg, rp)
            assert set(d) == set(ediags[k])
            for key, v in d.items():
                assert torch.equal(ediags[k][key][slot], v), (slot, k, key)
        _same_state(ensemble.member_view(es, slot), solo, f"slot {slot}")
    # the two parameter points are different physics
    assert not torch.equal(es.pic[0].species[0].x, es.pic[2].species[0].x)


def test_parked_slot_frozen_bitwise_with_zero_diag():
    cfg = _cfg(n=128)
    rp = runtime_params(cfg, device="cpu")
    es = ensemble.init_ensemble(cfg, 2, device="cpu")
    mk = ensemble.make_member_init(cfg, device="cpu")
    ins = ensemble.make_member_insert(cfg)
    rel = ensemble.make_member_release(cfg)
    es = ins(es, mk(0), rp, 0)
    es = ins(es, mk(1), rp, 1)
    es = rel(es, 1)
    parked = es.pic[1]
    before = [getattr(b, f).clone() for b in parked.species
              for f in ("x", "v", "w", "alive")]
    gen_before = parked.gen.get_state().clone()
    step = ensemble.make_ensemble_step(cfg)
    for _ in range(3):
        es, diag = step(es)
    assert es.pic[1] is parked
    after = [getattr(b, f) for b in parked.species
             for f in ("x", "v", "w", "alive")]
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert torch.equal(parked.gen.get_state(), gen_before)
    assert parked.step == 0
    for k, v in diag.items():
        assert v.shape[0] == 2
        assert not v[1].any(), f"parked slot reported diag {k}"
    assert es.pic[0].step == 3
    assert es.active.tolist() == [True, False]


def test_no_active_slot_reports_every_key_and_runs_nothing(monkeypatch):
    cfg = _cfg(n=128)
    es = ensemble.init_ensemble(cfg, 3, device="cpu")

    def no_step(*a, **k):
        raise AssertionError("a parked slot was stepped")

    monkeypatch.setattr(pic, "step_fn", no_step)
    es, diag = ensemble.make_ensemble_step(cfg)(es)
    spec = pic.diag_spec(cfg)
    assert list(diag) == list(spec)
    for k, v in diag.items():
        assert v.shape == (3,) and v.dtype == spec[k] and not v.any(), k
    assert all(p.step == 0 for p in es.pic)


@pytest.mark.parametrize("name", ["bench_fused", "bench_field", "see",
                                  "collision", "resilience_unified",
                                  "resilience_field"])
def test_diag_spec_is_the_step_diag(name):
    """The keys, order, shapes and dtypes ``diag_spec`` promises are what
    ``step_fn`` returns."""
    kind = name.split("_")[0]
    if kind == "bench":
        cfg = dataclasses.replace(
            port_cfgs.make_bench_config(nc=64, n=256, strategy="fused"),
            field_solve=name.endswith("field"))
    elif kind == "see":
        cfg = port_cfgs.make_see_config(nc=64, n=256, strategy="fused")
    elif kind == "collision":
        cfg = port_cfgs.make_collision_config(nc=64, n=256)
    else:
        cfg = _cfg(strategy="unified" if name.endswith("unified")
                   else "fused", n=128, field=name.endswith("field"))
    state = pic.init_state(cfg, 0, device="cpu")
    _, d = pic.step_fn(state, cfg)
    spec = pic.diag_spec(cfg)
    assert list(d) == list(spec)
    for k, v in d.items():
        assert v.shape == () and v.dtype == spec[k], k


def test_step_without_donation_leaves_the_input():
    cfg = _cfg(n=128)
    rp = runtime_params(cfg, device="cpu")
    es = ensemble.init_ensemble(cfg, 1, device="cpu")
    es = ensemble.make_member_insert(cfg)(
        es, ensemble.make_member_init(cfg, device="cpu")(4), rp, 0)
    member = es.pic[0]
    gen0 = member.gen.get_state().clone()
    out, _ = ensemble.make_ensemble_step(cfg, donate=False)(es)
    assert es.pic[0] is member and member.step == 0
    assert torch.equal(member.gen.get_state(), gen0)
    assert out.pic[0].step == 1 and out is not es
    again, _ = ensemble.make_ensemble_step(cfg, donate=False)(es)
    _same_state(again.pic[0], out.pic[0], "replay")


def test_members_match_the_reference_ensemble():
    """Two members at different points, 3 steps, each on the reference
    member's draws: counts, alive masks and the diagnostics' event
    counters exact, floats within the cycle's bands."""
    rcfg, cfg = _cfg(ref_cfgs), _cfg()
    points = ({"dt": 0.4, "ionization_rate": 2e-2},
              {"dt": 0.6, "emission_yield": 0.3,
               "collision_rates": (1e-2, 2e-2, 5e-3)})
    res = ref_ens.init_ensemble(rcfg, 2)
    rmk = ref_ens.make_member_init(rcfg)
    rins = ref_ens.make_member_insert(rcfg)
    es = ensemble.init_ensemble(cfg, 2, device="cpu")
    ins = ensemble.make_member_insert(cfg)
    for slot, (seed, pt) in enumerate(zip((10, 3), points)):
        pt = dict(pt)
        rates = pt.pop("collision_rates", None)
        member = rmk(jnp.int32(seed))
        es = ins(es, port_state(cfg, member),
                 runtime_params(cfg, collision_rates=rates, device="cpu",
                                **pt), slot)
        res = rins(res, member, ref_params.runtime_params(
            rcfg, collision_rates=rates, **pt), jnp.int32(slot))
    rstep = ref_ens.make_ensemble_step(rcfg, donate=False)
    step = ensemble.make_ensemble_step(cfg)
    events = 0
    for k in range(3):
        draws = {s: step_draws(cfg, res.pic.key[s]) for s in range(2)}
        res, rd = rstep(res)
        es, pd = step(es, draws)
        assert set(pd) == set(rd)
        for key, v in rd.items():
            if np.asarray(v).dtype.kind in "iu":
                np.testing.assert_array_equal(n(pd[key]), np.asarray(v),
                                              err_msg=str((k, key)))
                events += int(np.asarray(v).sum())
        for s in range(2):
            jm = ref_ens.member_view(res, s)
            pm = ensemble.member_view(es, s)
            for jb, pb in zip(jm.species, pm.species):
                np.testing.assert_array_equal(n(pb.alive), n(jb.alive))
                np.testing.assert_allclose(n(pb.x), n(jb.x), rtol=2e-5,
                                           atol=2e-5)
                jv = n(jb.v)
                assert (np.abs(n(pb.v) - jv) <= 2e-5 * (1 + np.abs(jv))
                        ).all(), (k, s)
                np.testing.assert_allclose(n(pb.w), n(jb.w), rtol=2e-5,
                                           atol=2e-5)
    assert events > 0


@pytest.mark.parametrize("strategy", ["async_batched", "explicit"])
def test_strategy_validation_matches_reference(strategy):
    with pytest.raises(NotImplementedError, match=strategy):
        ref_ens.init_ensemble(_cfg(ref_cfgs, strategy=strategy, n=128), 2)
    cfg = _cfg(strategy=strategy, n=128)
    for make in (lambda: ensemble.init_ensemble(cfg, 2, device="cpu"),
                 lambda: ensemble.make_ensemble_step(cfg),
                 lambda: ensemble.make_member_init(cfg, device="cpu"),
                 lambda: ensemble.make_member_insert(cfg),
                 lambda: ensemble.make_member_release(cfg)):
        with pytest.raises(NotImplementedError, match=strategy):
            make()


@pytest.mark.parametrize("width", [0, -1])
def test_width_validation(width):
    with pytest.raises(ValueError, match="width"):
        ensemble.init_ensemble(_cfg(n=128), width, device="cpu")


def test_entry_points_run_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        ensemble.init_ensemble(_cfg(n=128), 2)
