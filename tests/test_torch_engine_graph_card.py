"""The engine step replayed as a CUDA graph against the same step run
eagerly, on the card; skips without one. This file imports no JAX, so that
it runs on a machine with the card alone:
``PYTHONPATH=src python -m pytest -q tests/test_torch_engine_graph_card.py``
(``chip_smoke.py`` runs it too).

The engine cells' configuration (the §3.3 plasma, ionization on, field
off and field on) at 16,384 cells and 327,680 particles a species, over
4 domains × async(4) as the engine cells run it, and over 1 × async(1)
and 4 × async(1), where a queue is its whole domain: there the queue's
slice is the domain's row of the step's own buffers, and the merge
writes into the storage the queue was pushed from. Six steps of the graphed step function cross
an episode restore (fresh copies of the first state, so the step copies
them into its own buffers); before each, the eager step (``graph=False``)
runs on a private copy of the same input with its generators forked (or
with the same ``draws=``). Every step after the first must be a replay,
and match the eager step bit for bit: each group's rows, rings and pending
blocks and the diagnostics. The carried rho is summed by float atomics, so
two eager steps from one input differ in its last bits: it is held to the
eager step within 1e-6 of its largest node. Each step's diagnostics must
read the same after the steps that follow it."""

import dataclasses

import pytest
import torch

from repro_torch.configs import pic_bit1
from repro_torch.distributed import engine, perf
from repro_torch.obs import tracing

NC, N, STEPS, RESTORE = 16_384, 327_680, 6, 3


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this file on "
                    "the card")
    return torch.device("cuda")


def _setup(field: bool, domains: int, async_n: int, dev):
    cfg = dataclasses.replace(pic_bit1.make_field_config(NC, N),
                              ionization_rate=1e-3)
    if not field:
        cfg = dataclasses.replace(cfg, field_solve=False, eps0=1.0)
    ecfg = engine.EngineConfig(pic=cfg, domains=domains, async_n=async_n,
                               max_migration=1024, max_births=4096)
    state = (pic_bit1.field_engine_state(ecfg, 5, device=dev) if field
             else engine.init_engine_state(ecfg, 5, device=dev))
    return ecfg, state


def _draws(ecfg, gen):
    """One step's ionization draws: per domain, per queue, the uniform
    and normal arrays of the queue's neutral slice."""
    cap_q = ecfg.local_cap(ecfg.pic.species[2]) // ecfg.async_n
    dev = gen.device
    return [{"ionize": [
        {"uniform": torch.rand(cap_q, generator=gen, device=dev),
         "normal": torch.randn(cap_q, 3, generator=gen, device=dev)}
        for _ in range(ecfg.async_n)]} for _ in range(ecfg.domains)]


def _fresh(state):
    """Copies of the state's tensors, its generators as they are (an
    episode restore)."""
    return engine._with_fields(state, [t.clone() for t in
                                       engine._fields(state)], state.step)


def _rho_gap(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


@pytest.mark.card
@pytest.mark.parametrize("draws", [False, True], ids=["generators",
                                                      "draws"])
@pytest.mark.parametrize("field", [False, True], ids=["field_off",
                                                     "field_on"])
@pytest.mark.parametrize("shape", [(4, 4), (1, 1), (4, 1)],
                         ids=["d4q4", "d1q1", "d4q1"])
def test_replay_equals_the_eager_step(card, shape, field, draws):
    ecfg, s0 = _setup(field, *shape, card)
    snapshot = _fresh(s0)
    gstep = engine.make_engine_step(ecfg)
    estep = engine.make_engine_step(ecfg, graph=False)
    dgen = torch.Generator(device=card).manual_seed(11)
    state = s0
    kept = []
    with tracing.capture_scopes() as entered:
        for t in range(STEPS):
            if t == RESTORE:
                state = dataclasses.replace(_fresh(snapshot),
                                            gens=state.gens)
            dr = _draws(ecfg, dgen) if draws else None
            want, wdiag = estep(perf._copy_state(state), dr)
            state, diag = gstep(state, dr)
            torch.cuda.synchronize(card)
            assert state.step == want.step
            got_t, want_t = engine._fields(state), engine._fields(want)
            if field:                   # the carried rho, last
                assert _rho_gap(got_t.pop(), want_t.pop()) <= 1e-6, t
            for i, (a, b) in enumerate(zip(got_t, want_t)):
                assert a.dtype == b.dtype and torch.equal(a, b), (t, i)
            assert diag.keys() == wdiag.keys()
            for k in diag:
                assert torch.equal(diag[k], wdiag[k]), (t, k)
            kept.append((diag, {k: v.clone() for k, v in diag.items()}))
    torch.cuda.synchronize(card)
    for t, (diag, copy) in enumerate(kept):
        for k in diag:
            assert torch.equal(diag[k], copy[k]), (t, k)
    assert entered.count("engine/graph/replay") == STEPS - 1
    assert entered.count("engine/graph/capture") == 1
    assert sum(int(d["n_ionized"]) for d, _ in kept) > 0
