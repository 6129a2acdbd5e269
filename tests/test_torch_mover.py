"""The port's mover (``repro_torch.core.mover``) against the reference's,
strategy by strategy, with the wall-hit masks and the wall diagnostics.

State tolerances: rtol = atol = 2e-5 (``tests/test_kernels.py``): the port's
fused and explicit strategies run the kernels' arithmetic, which wraps and
parks particles as the reference's kernels do (x - floor(x/L)*L,
L*(1-1e-7)), where the reference's jnp path uses mod and nextafter. Masks
and counts are exact. Wall power sums in float32, rtol 1e-5.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import n, t
from repro.core import grid as ref_grid
from repro.core import mover as ref_mover
from repro.core import particles as ref_particles
from repro_torch.core import grid, mover, particles

TOL = dict(rtol=2e-5, atol=2e-5)
NC = 64
B = (0.05, -0.1, 0.2)


def _data(cap=4096, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, NC, cap).astype(np.float32)
    v = (2.0 * rng.normal(size=(cap, 3))).astype(np.float32)
    alive = rng.random(cap) < 0.85
    w = (rng.random(cap).astype(np.float32) + 0.5) * alive
    e = rng.normal(size=NC + 1).astype(np.float32)
    return x, v, w, alive, e


def _pair(x, v, w, alive):
    return (ref_particles.SpeciesBuffer(jnp.asarray(x), jnp.asarray(v),
                                        jnp.asarray(w), jnp.asarray(alive)),
            particles.SpeciesBuffer(t(x), t(v), t(w), t(alive)))


def _check_result(got, want):
    for f in ("x", "v", "w"):
        np.testing.assert_allclose(n(getattr(got.buf, f)),
                                   n(getattr(want.buf, f)), **TOL)
    np.testing.assert_array_equal(n(got.buf.alive), n(want.buf.alive))
    np.testing.assert_array_equal(n(got.hit_left), n(want.hit_left))
    np.testing.assert_array_equal(n(got.hit_right), n(want.hit_right))
    assert set(got.diag) == set(want.diag)
    for k in got.diag:
        np.testing.assert_allclose(n(got.diag[k]), n(want.diag[k]),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("strategy", ref_mover.STRATEGIES)
@pytest.mark.parametrize("boundary", ["periodic", "absorb", "open"])
def test_strategies_match_reference(strategy, boundary):
    x, v, w, alive, e = _data()
    rb, pb = _pair(x, v, w, alive)
    g, rg = grid.Grid1D(NC, 1.0), ref_grid.Grid1D(NC, 1.0)
    kw = dict(b=B, boundary=boundary)
    got = mover.push(pb, t(e), g, -1.0, 0.1, strategy=strategy, **kw)
    want = ref_mover.push(rb, jnp.asarray(e), rg, -1.0, 0.1,
                          strategy=strategy, **kw)
    _check_result(got, want)
    if boundary == "absorb":
        assert n(got.hit_left).sum() + n(got.hit_right).sum() > 0
        # the wall power reads the weight before the push
        assert float(got.diag["power_left"]) > 0.0


def test_fused_deposit_and_carry_match_reference():
    x, v, w, alive, e = _data(seed=3)
    rb, pb = _pair(x, v, w, alive)
    g, rg = grid.Grid1D(NC, 1.0), ref_grid.Grid1D(NC, 1.0)
    carry = np.random.default_rng(9).normal(size=NC + 1).astype(np.float32)
    got = mover.push_fused(pb, t(e), g, -1.0, 0.1, b=B, boundary="absorb",
                           deposit_charge=-1.0, rho_carry=t(carry))
    want = ref_mover.push_fused(rb, jnp.asarray(e), rg, -1.0, 0.1, b=B,
                                boundary="absorb", deposit_charge=-1.0,
                                rho_carry=jnp.asarray(carry))
    _check_result(got, want)
    np.testing.assert_allclose(n(got.rho), n(want.rho), rtol=1e-3, atol=1e-3)
    assert mover.push_fused(pb, t(e), g, -1.0, 0.1).rho is None


@pytest.mark.parametrize("boundary", ["periodic", "absorb"])
@pytest.mark.parametrize("deposit", [True, False])
def test_push_stacked_matches_reference(boundary, deposit):
    data = [_data(seed=10 + s) for s in range(3)]
    st_args = [np.stack([d[i] for d in data]) for i in range(4)]
    e = data[0][4]
    qm = np.array([-1.0, 1 / 3672.0, 0.0], np.float32)
    dts = np.array([0.1, 0.1, 0.4], np.float32)
    charges = np.array([-1.0, 1.0, 0.0], np.float32)
    carry = np.random.default_rng(1).normal(size=NC + 1).astype(np.float32)
    g, rg = grid.Grid1D(NC, 1.0), ref_grid.Grid1D(NC, 1.0)
    pst = particles.StackedSpecies(*(t(a) for a in st_args))
    rst = ref_particles.StackedSpecies(*(jnp.asarray(a) for a in st_args))
    got = mover.push_stacked(
        pst, t(e), g, t(qm), t(dts), b=B, boundary=boundary,
        charges=t(charges) if deposit else None,
        rho_carry=t(carry) if deposit else None)
    want = ref_mover.push_stacked(
        rst, jnp.asarray(e), rg, jnp.asarray(qm), jnp.asarray(dts), b=B,
        boundary=boundary, charges=jnp.asarray(charges) if deposit else None,
        rho_carry=jnp.asarray(carry) if deposit else None)
    for f in ("x", "v", "w"):
        np.testing.assert_allclose(n(getattr(got[0], f)),
                                   n(getattr(want[0], f)), **TOL)
    np.testing.assert_array_equal(n(got[0].alive), n(want[0].alive))
    np.testing.assert_array_equal(n(got[1]), n(want[1]))
    np.testing.assert_array_equal(n(got[2]), n(want[2]))
    for k in want[3]:
        np.testing.assert_allclose(n(got[3][k]), n(want[3][k]), rtol=1e-5,
                                   atol=1e-5)
    if deposit:
        np.testing.assert_allclose(n(got[4]), n(want[4]), rtol=1e-3,
                                   atol=1e-3)
    else:
        assert got[4] is None and want[4] is None


@pytest.mark.parametrize("b", [B, (0.0, 0.0, 0.0)])
def test_boris_kick_matches(b):
    _, v, _, _, e = _data(cap=1000)
    ex = np.random.default_rng(4).normal(size=1000).astype(np.float32)
    got = mover.boris_kick(t(v), t(ex), -0.1, b)
    want = ref_mover.boris_kick(jnp.asarray(v), jnp.asarray(ex), -0.1, b)
    np.testing.assert_allclose(n(got), n(want), **TOL)


def test_boris_pure_b_preserves_speed():
    _, v, _, _, _ = _data(cap=1000)
    out = n(mover.boris_kick(t(v), torch.zeros(1000), 0.3, (0.0, 0.0, 2.0)))
    np.testing.assert_allclose(np.linalg.norm(out, axis=1),
                               np.linalg.norm(v, axis=1), rtol=1e-5)


@pytest.mark.parametrize("boundary", ["periodic", "absorb", "open"])
def test_apply_boundary_is_bitwise_reference(boundary):
    rng = np.random.default_rng(6)
    L = 4096.0
    x = np.concatenate([rng.uniform(-1e-3, 0, 10_000),
                        rng.uniform(-L, 2 * L, 50_000),
                        [0.0, L, -0.0, 2 * L]]).astype(np.float32)
    alive = rng.random(x.shape[0]) < 0.9
    got = mover.apply_boundary(t(x), t(alive), L, boundary)
    want = ref_mover.apply_boundary(jnp.asarray(x), jnp.asarray(alive), L,
                                    boundary)
    for g_, w_ in zip(got, want):
        np.testing.assert_array_equal(n(g_), n(w_))


def test_dead_particles_feel_no_field():
    x, v, w, alive, e = _data(cap=1024, seed=5)
    _, pb = _pair(x, v, w, np.zeros_like(alive))
    for strategy in ("explicit", "fused", "unified"):
        res = mover.push(pb, t(e), grid.Grid1D(NC, 1.0), -1.0, 0.1,
                         strategy=strategy, boundary="open")
        np.testing.assert_allclose(n(res.buf.v), v, rtol=1e-6)
        np.testing.assert_allclose(n(res.buf.x), x + v[:, 0] * 0.1,
                                   rtol=1e-5, atol=1e-5)


def test_async_batched_rejects_ragged_batches():
    x, v, w, alive, e = _data(cap=1000)
    _, pb = _pair(x, v, w, alive)
    with pytest.raises(ValueError, match="divisible"):
        mover.push_async_batched(pb, t(e), grid.Grid1D(NC, 1.0), -1.0, 0.1,
                                 num_batches=3)
    with pytest.raises(ValueError, match="unknown mover strategy"):
        mover.push(pb, t(e), grid.Grid1D(NC, 1.0), -1.0, 0.1,
                   strategy="bogus")


def test_push_result_fields_match_reference():
    assert mover.PushResult._fields == ref_mover.PushResult._fields
    assert mover.STRATEGIES == ref_mover.STRATEGIES
    assert mover.BOUNDARIES == ref_mover.BOUNDARIES
    assert ([f.name for f in dataclasses.fields(particles.SpeciesBuffer)]
            == [f.name for f in dataclasses.fields(
                ref_particles.SpeciesBuffer)])
