"""The engine's held-back pieces of ``particles``, ``collisions`` and
``fields`` against the reference: the free-slot ring and ``kill_packed``
(integers exactly, including a property over random interleaved traffic
like ``tests/test_slot_ring.py``), the planar helpers, ``ionize_packed`` on
the reference's draws, and ``thomas`` within float32 rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import n, t
from repro.core import collisions as ref_coll
from repro.core import fields as ref_fields
from repro.core import grid as ref_grid
from repro.core import particles as ref_p
from repro_torch.core import collisions, fields, grid, particles as p

try:                                   # gated like the reference's suites
    from hypothesis import given, settings, strategies as hyp_st
    HAVE_HYPOTHESIS = True
except ImportError:                    # pragma: no cover - optional dep
    HAVE_HYPOTHESIS = False

    def given(*a, **k):
        return lambda f: f

    settings = given

    class hyp_st:                      # type: ignore[no-redef]
        @staticmethod
        def integers(*a, **k):
            return None

needs_hypothesis = pytest.mark.skipif(
    not HAVE_HYPOTHESIS, reason="hypothesis not installed")


def _same_ring(port, ref):
    for f in ("slots", "head", "count"):
        np.testing.assert_array_equal(n(getattr(port, f)),
                                      np.asarray(getattr(ref, f)))


def _traffic(cap, seed, rounds):
    """Both rings through the same random push/claim traffic; the port's is
    batched over two copies to exercise the leading axis."""
    rng = np.random.RandomState(seed)
    alive = rng.rand(cap) < rng.rand()
    jring = ref_p.ring_init(jnp.asarray(alive))
    pring = p.ring_init(t(np.stack([alive, alive])))
    for i in range(2):
        _same_ring(p.FreeSlotRing(*(getattr(pring, f)[i] for f in
                                    ("slots", "head", "count"))), jring)
    for _ in range(rounds):
        kill_idx = np.nonzero(alive)[0][: rng.randint(0, 4)]
        idx = np.full((4,), cap)
        ok = np.zeros((4,), bool)
        idx[: len(kill_idx)] = kill_idx
        ok[: len(kill_idx)] = True
        alive[kill_idx] = False
        jring = ref_p.ring_push(jring, jnp.asarray(idx), jnp.asarray(ok))
        pring = p.ring_push(pring, t(np.stack([idx, idx])),
                            t(np.stack([ok, ok])))
        want = rng.rand(5) < rng.rand()
        budget = rng.randint(0, 6) if rng.rand() < 0.5 else None
        jring, jdest, jok = ref_p.ring_claim(
            jring, jnp.asarray(want), cap,
            None if budget is None else jnp.asarray(budget, jnp.int32))
        pring, pdest, pok = p.ring_claim(
            pring, t(np.stack([want, want])), cap,
            None if budget is None else torch.tensor([budget, budget]))
        for i in range(2):
            np.testing.assert_array_equal(n(pdest[i]), np.asarray(jdest))
            np.testing.assert_array_equal(n(pok[i]), np.asarray(jok))
            _same_ring(p.FreeSlotRing(*(getattr(pring, f)[i] for f in
                                        ("slots", "head", "count"))), jring)
        alive[np.asarray(jdest)[np.asarray(jok)]] = True
    return jring, pring


def test_ring_traffic_matches_reference_with_wraparound():
    _traffic(24, 3, 40)


@needs_hypothesis
@settings(max_examples=25, deadline=None)
@given(cap=hyp_st.integers(4, 48), seed=hyp_st.integers(0, 2 ** 16),
       rounds=hyp_st.integers(1, 24))
def test_ring_property_interleaved_leaver_birth_traffic(cap, seed, rounds):
    _traffic(cap, seed, rounds)


@pytest.mark.parametrize("cap,count", [(1, 0), (17, 5), (64, 64), (33, 0)])
def test_ring_from_counts_matches_reference(cap, count):
    _same_ring(p.ring_from_counts(torch.tensor(count), cap),
               ref_p.ring_from_counts(jnp.asarray(count, jnp.int32), cap))
    batched = p.ring_from_counts(torch.tensor([count, 0]), cap)
    _same_ring(p.FreeSlotRing(batched.slots[0], batched.head[0],
                              batched.count[0]),
               ref_p.ring_from_counts(jnp.asarray(count, jnp.int32), cap))


def test_kill_packed_matches_reference():
    rng = np.random.default_rng(0)
    cap = 50
    x = rng.random(cap).astype(np.float32)
    w = rng.random(cap).astype(np.float32)
    alive = rng.random(cap) < 0.7
    idx = np.array([3, 7, 7, 49, 50, 12], np.int32)
    ok = np.array([True, True, False, True, True, False])
    jb = ref_p.kill_packed(ref_p.SpeciesBuffer(
        x=jnp.asarray(x), v=jnp.zeros((cap, 3)), w=jnp.asarray(w),
        alive=jnp.asarray(alive)), jnp.asarray(idx), jnp.asarray(ok))
    pb = p.kill_packed(p.SpeciesBuffer(
        x=t(x), v=torch.zeros(cap, 3), w=t(w), alive=t(alive)), t(idx), t(ok))
    np.testing.assert_array_equal(n(pb.alive), np.asarray(jb.alive))
    np.testing.assert_array_equal(n(pb.w), np.asarray(jb.w))


@pytest.mark.parametrize("cap,tile_rows", [(1024, 8), (1000, 8), (300, 2)])
def test_planar_helpers_match_reference(cap, tile_rows):
    a = np.arange(cap, dtype=np.float32)
    want = np.asarray(ref_p.to_planes(jnp.asarray(a), tile_rows, -1.0))
    got = p.to_planes(t(a), tile_rows, -1.0)
    np.testing.assert_array_equal(n(got), want)
    np.testing.assert_array_equal(n(p.from_planes(got, cap)), a)
    np.testing.assert_array_equal(
        n(p.plane_pad(t(a), 96)), np.asarray(ref_p.plane_pad(jnp.asarray(a),
                                                            96)))


def test_ionize_packed_matches_reference_on_its_draws():
    rng = np.random.default_rng(1)
    cap, nc, budget = 4096, 64, 96
    x = rng.uniform(-0.5, nc + 0.5, cap).astype(np.float32)  # crossers too
    v = rng.normal(0, 0.05, (cap, 3)).astype(np.float32)
    alive = rng.random(cap) < 0.8
    w = (alive * 1.0).astype(np.float32)
    ne = rng.uniform(0.5, 2.0, nc + 1).astype(np.float32)
    params_j = ref_coll.IonizationParams(rate=0.2, vth_electron=1.0)
    key = jax.random.PRNGKey(5)
    jpack = ref_coll.ionize_packed(
        key, ref_p.SpeciesBuffer(x=jnp.asarray(x), v=jnp.asarray(v),
                                 w=jnp.asarray(w), alive=jnp.asarray(alive)),
        ref_grid.Grid1D(nc=nc, dx=1.0), params_j, 0.4, jnp.asarray(ne),
        budget)
    ku, kv = jax.random.split(key)
    draws = {"uniform": n(jax.random.uniform(ku, (cap,), np.float32)),
             "normal": n(jax.random.normal(kv, (cap, 3), np.float32))}
    ppack = collisions.ionize_packed(
        None, p.SpeciesBuffer(x=t(x), v=t(v), w=t(w), alive=t(alive)),
        grid.Grid1D(nc=nc, dx=1.0),
        collisions.IonizationParams(rate=0.2, vth_electron=1.0), 0.4, t(ne),
        budget, draws=draws)
    assert int(jpack.n_events) > budget        # the clamp engaged
    for f in ("slot", "ok", "n_events"):
        np.testing.assert_array_equal(n(getattr(ppack, f)),
                                      np.asarray(getattr(jpack, f)))
    for f in ("x", "v_electron", "v_ion", "w"):
        np.testing.assert_allclose(n(getattr(ppack, f)),
                                   np.asarray(getattr(jpack, f)),
                                   rtol=2e-6, atol=1e-7)


@pytest.mark.parametrize("nsys", [1, 16, 64])
def test_thomas_matches_reference(nsys):
    rng = np.random.default_rng(nsys)
    dl = rng.uniform(-1, 0, nsys).astype(np.float32)
    du = rng.uniform(-1, 0, nsys).astype(np.float32)
    d = (2.5 + rng.random(nsys)).astype(np.float32)
    b = rng.normal(0, 1, nsys).astype(np.float32)
    want = np.asarray(jax.jit(ref_fields.thomas)(dl, d, du, b))
    got = n(fields.thomas(t(dl), t(d), t(du), t(b)))
    # float32 rounding of an n-step recurrence, well conditioned
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    dense = np.diag(d.astype(np.float64)) + np.diag(dl[1:], -1) + np.diag(
        du[:-1], 1)
    np.testing.assert_allclose(got, np.linalg.solve(dense, b), rtol=1e-4,
                               atol=1e-5)
