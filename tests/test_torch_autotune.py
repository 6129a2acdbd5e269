"""The port's online auto-tuner (``repro_torch.obs.autotune``) against the
reference's: the pure control law ``decide`` gives the reference's answer
on a table of windows; ``engine.retarget_state`` carries a live state
across a knob change exactly (pending flushed, identity when the layout
stays); the closed loop lowers the measured queue skew on the SEE churn
workload.
"""

import dataclasses

import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (one torch thread a test process)
from repro.configs import pic_bit1 as ref_configs
from repro.obs import autotune as ref_autotune
from repro.obs.metrics import StepMetrics as RefStepMetrics
from repro_torch.configs.pic_bit1 import make_engine_config, make_see_config
from repro_torch.distributed import engine
from repro_torch.obs import autotune
from repro_torch.obs.metrics import StepMetrics


def _knobs(**kw):
    kw.setdefault("nc", 32)
    kw.setdefault("n", 512)
    return dict(async_n=kw.pop("async_n", 4),
                max_migration=kw.pop("max_migration", 1024),
                max_births=kw.pop("max_births", 1024),
                rebalance_skew=kw.pop("rebalance_skew", 0),
                rebalance_every=kw.pop("rebalance_every", 0),
                strategy="fused", **kw)


def _ecfg(**kw):
    return make_engine_config(**_knobs(**kw))


def _both(counters, queues=None, n=4):
    """The same window as the port's and the reference's records."""
    return tuple([cls(step=i, wall_us=1000.0, counters=dict(counters),
                      queues=dict(queues or {})) for i in range(n)]
                 for cls in (StepMetrics, RefStepMetrics))


_SKEWED = {"e": [400, 100, 100, 100]}        # mean 175, skew 300
_CALM = {"e": [200, 199, 201, 200]}

# (knobs, counters, queues, policy kwargs): the control law's branches
DECISIONS = {
    "empty": ({}, None, None, {}),
    "migration_overflow": ({"max_migration": 1024},
                           {"e/migration_overflow": 3.0,
                            "e/migrated_left": 1024.0}, None, {}),
    "migration_capped": ({"max_migration": 65536},
                         {"e/migration_overflow": 3.0,
                          "e/migrated_left": 1024.0}, None, {}),
    "birth_overflow": ({"max_births": 512},
                       {"birth_overflow": 2.0, "n_ionized": 100.0}, None,
                       {}),
    "emission_overflow": ({"max_births": 512},
                          {"e/emission_overflow": 1.0, "e/emitted": 9.0},
                          None, {}),
    "calm_shrinks": ({"max_migration": 1024, "max_births": 1024},
                     {"e/migration_overflow": 0.0, "e/migrated_left": 10.0,
                      "e/migrated_right": 12.0, "n_ionized": 5.0,
                      "birth_overflow": 0.0}, None, {"min_budget": 64}),
    "busy_keeps": ({"max_migration": 1024},
                   {"e/migration_overflow": 0.0, "e/migrated_left": 700.0},
                   None, {}),
    "floor": ({"max_migration": 64, "max_births": 64},
              {"e/migration_overflow": 0.0, "e/migrated_left": 10.0,
               "n_ionized": 5.0, "birth_overflow": 0.0}, None,
              {"min_budget": 64}),
    "skew_arms": ({}, {"e/queue_skew": 300.0, "e/migrated_left": 500.0},
                  _SKEWED, {"window": 6, "skew_frac": 0.25}),
    "skew_backstop": ({"rebalance_skew": 43},
                      {"e/queue_skew": 300.0, "e/migrated_left": 500.0},
                      _SKEWED, {"window": 6, "skew_frac": 0.25}),
    "balanced": ({}, {"e/queue_skew": 2.0, "e/migrated_left": 500.0},
                 _CALM, {"window": 6, "skew_frac": 0.25}),
    "async_2": ({"async_n": 2, "max_migration": 100},
                {"e/migration_overflow": 1.0}, None, {}),
}


@pytest.mark.parametrize("case", list(DECISIONS))
def test_decide_equals_the_reference(case):
    knobs, counters, queues, pol = DECISIONS[case]
    port_win, ref_win = ([], []) if counters is None else _both(counters,
                                                                queues)
    got = autotune.decide(_ecfg(**knobs), port_win,
                          autotune.TunerPolicy(**pol))
    want = ref_autotune.decide(
        ref_configs.make_engine_config(**_knobs(**knobs)), ref_win,
        ref_autotune.TunerPolicy(**pol))
    assert got == want
    for k in ("max_migration", "max_births"):
        if k in got:
            assert got[k] % _ecfg(**knobs).async_n == 0


def test_decide_rules_fire():
    """The table's cases are not vacuous: each rule changes a knob."""
    def decide(case):
        knobs, counters, queues, pol = DECISIONS[case]
        win = [] if counters is None else _both(counters, queues)[0]
        return autotune.decide(_ecfg(**knobs), win,
                               autotune.TunerPolicy(**pol))

    assert decide("empty") == {}
    assert decide("migration_overflow")["max_migration"] == 2048
    assert "max_migration" not in decide("migration_capped")
    assert decide("birth_overflow")["max_births"] == 1024
    assert decide("calm_shrinks") == {"max_migration": 512,
                                      "max_births": 512}
    assert decide("skew_arms")["rebalance_skew"] == int(0.25 * 175)
    assert decide("skew_backstop")["rebalance_every"] == 6
    assert "rebalance_skew" not in decide("balanced")


# ---------------------------------------------------------- state carry-over


def _totals(state):
    alive = sum(int(b.alive.sum()) for b in state.species)
    pend = sum(int(p.alive.sum()) for p in state.pending)
    return alive, pend


def test_retarget_state_flushes_pending_exactly():
    """A budget retune mid-run conserves every particle, the in-flight
    pending rows included; the rings account for every dead slot and the
    carried state steps on under the new config with the same counts and
    charge as the old config's next step."""
    ecfg = _ecfg(async_n=2, max_migration=64, max_births=64, domains=2)
    state = engine.init_engine_state(ecfg, 0, device="cpu")
    step = engine.make_engine_step(ecfg, donate=False)
    for _ in range(3):
        state, diag = step(state)
    alive0, pend0 = _totals(state)
    assert pend0 > 0, "workload produced no in-flight rows; test is vacuous"
    new = dataclasses.replace(ecfg, max_migration=128, max_births=256)
    state2 = engine.retarget_state(ecfg, new, state)
    alive1, pend1 = _totals(state2)
    assert pend1 == 0
    assert alive1 == alive0 + pend0
    assert state2.pending[0].x.shape[-1] == engine._group_pending_rows(
        new, engine._capacity_groups(new))[0]
    for rg, st in zip(state2.rings, state2.groups):
        assert torch.equal(rg.count, (~st.alive).sum(-1, dtype=torch.int32))
    assert state2.rho is state.rho
    np.testing.assert_array_equal(state2.key, state.key)
    assert state2.gens is state.gens and state2.step == state.step
    _, diag2 = engine.make_engine_step(new, donate=False)(state2)
    _, diag1 = step(state)
    for k in diag1:
        if k.endswith(("/count", "/charge")):
            assert torch.equal(diag1[k], diag2[k]), k


def test_retarget_state_identity_when_compatible():
    ecfg = _ecfg(async_n=2, max_migration=64, max_births=64)
    state = engine.init_engine_state(ecfg, 0, device="cpu")
    new = dataclasses.replace(ecfg, async_n=1, rebalance_every=3,
                              rebalance_skew=7, metrics=True,
                              cell_order=True)
    assert engine.retarget_state(ecfg, new, state) is state
    bad = dataclasses.replace(
        ecfg, pic=dataclasses.replace(ecfg.pic, dt=0.5))
    with pytest.raises(ValueError, match="physics"):
        engine.retarget_state(ecfg, bad, state)
    with pytest.raises(ValueError, match="elastic"):
        engine.retarget_state(ecfg, dataclasses.replace(ecfg, domains=2),
                              state)


# -------------------------------------------------------------- closed loop


def test_autotuner_reduces_queue_skew_on_churn():
    """On the SEE churn workload (absorbing walls + secondary emission
    drifting the per-queue occupancy apart) the tuner arms the
    skew-triggered rebalance and ends with a lower measured queue skew
    than the fixed knobs; its stream holds one record a step."""
    cfg = make_see_config(nc=64, n=2048, strategy="fused",
                          emission_yield=0.7)
    ecfg = make_engine_config(cfg, async_n=4, max_migration=256,
                              max_births=256)
    steps = 14

    def skew_of(diag):
        return max(int(v) for k, v in diag.items()
                   if k.endswith("/queue_skew"))

    state = engine.init_engine_state(ecfg, 0, device="cpu")
    step = engine.make_engine_step(ecfg)
    for _ in range(steps):
        state, diag = step(state)
    fixed_skew = skew_of(diag)

    policy = autotune.TunerPolicy(window=4, skew_frac=0.004,
                                  shrink_frac=0.0)
    tuner = autotune.AutoTuner(ecfg, policy=policy)
    assert tuner.ecfg.metrics
    state = engine.init_engine_state(tuner.ecfg, 0, device="cpu")
    for _ in range(steps):
        state, diag = tuner.run_step(state)
    tuned_skew = skew_of(diag)

    assert tuner.retunes >= 1, tuner.log
    assert tuner.ecfg.rebalance_skew > 0, tuner.log
    assert tuned_skew < fixed_skew, (tuned_skew, fixed_skew, tuner.log)
    assert [m.step for m in tuner.stream.window(99)] == list(range(steps))


def test_autotuner_budget_retune_conserves_pairs():
    """An undersized migration budget at D = 2 overflows; the tuner grows
    it, carrying the state across the retune, and the ionization pairs
    stay exact through every step."""
    from repro_torch.configs.pic_bit1 import make_bench_config
    cfg = make_bench_config(nc=64, n=2048, strategy="fused")
    ecfg = make_engine_config(cfg, domains=2, async_n=2, max_migration=8,
                              max_births=256)
    tuner = autotune.AutoTuner(ecfg, policy=autotune.TunerPolicy(window=2))
    state = engine.init_engine_state(tuner.ecfg, 0, device="cpu")
    n0 = [int(b.alive.sum()) for b in state.species]
    ionized = 0
    for _ in range(6):
        state, diag = tuner.run_step(state)
        ionized += int(diag["n_ionized"])
        counts = [int(diag[f"{sc.name}/count"]) for sc in cfg.species]
        assert counts[0] - n0[0] == counts[1] - n0[1] == ionized \
            == n0[2] - counts[2]
    assert tuner.retunes >= 1 and tuner.ecfg.max_migration > 8, tuner.log
    assert any("max_migration: 8 -> 16" in line for line in tuner.log)
