"""Grid deposits/gathers and the field solve of the port against the
reference (``repro.core.grid``, ``repro.core.fields``).

Deposits: rtol = atol = 1e-3 and the total-charge check (scatter order
differs). Gathers, smoother and E: rtol = atol = 2e-5 (elementwise float32
arithmetic in the same order). Poisson: the double cumulative sum adds in
another order in torch than in XLA, so phi is compared to 1e-5 of max|phi|.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import n, t
from repro.core import fields as ref_fields
from repro.core import grid as ref_grid
from repro.core import particles as ref_particles
from repro_torch.core import fields, grid
from repro_torch.core import particles

TOL = dict(rtol=2e-5, atol=2e-5)


def _data(nc=200, cap=3000, seed=0, dx=0.5):
    rng = np.random.default_rng(seed)
    L = nc * dx
    x = rng.uniform(0, L, cap).astype(np.float32)
    x[:5] = [0.0, L, np.nextafter(np.float32(L), np.float32(0)), dx, 3 * dx]
    v = rng.normal(0, 1, (cap, 3)).astype(np.float32)
    w = rng.random(cap).astype(np.float32)
    alive = rng.random(cap) < 0.8
    return x, v, w * alive, alive, L


def _bufs(x, v, w, alive):
    rb = ref_particles.SpeciesBuffer(x=jnp.asarray(x), v=jnp.asarray(v),
                                     w=jnp.asarray(w),
                                     alive=jnp.asarray(alive))
    pb = particles.SpeciesBuffer(x=t(x), v=t(v), w=t(w), alive=t(alive))
    return rb, pb


@pytest.mark.parametrize("dx", [0.5, 1.0])
def test_cic_weights_match(dx):
    x, *_ = _data(dx=dx)
    gi, gf = grid._cic_weights(grid.Grid1D(200, dx), t(x))
    ri, rf = ref_grid._cic_weights(ref_grid.Grid1D(200, dx), jnp.asarray(x))
    np.testing.assert_array_equal(n(gi), n(ri))
    np.testing.assert_array_equal(n(gf), n(rf))


@pytest.mark.parametrize("charge", [1.0, -1.0])
def test_deposit_and_density_match(charge):
    x, v, w, alive, L = _data()
    rb, pb = _bufs(x, v, w, alive)
    g, rg = grid.Grid1D(200, 0.5), ref_grid.Grid1D(200, 0.5)
    got = n(grid.deposit(g, pb, charge))
    want = n(ref_grid.deposit(rg, rb, charge))
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(got.sum() * 0.5, charge * w.sum(), rtol=1e-5)
    np.testing.assert_allclose(n(grid.deposit_density(g, pb)),
                               n(ref_grid.deposit_density(rg, rb)),
                               rtol=1e-3, atol=1e-3)


def test_windowed_and_stacked_deposits_match():
    data = [_data(seed=s) for s in range(3)]
    xs = np.stack([d[0] for d in data])
    ws = np.stack([d[2] for d in data])
    als = np.stack([d[3] for d in data])
    charges = np.array([-1.0, 1.0, 0.0], np.float32)
    g, rg = grid.Grid1D(200, 0.5), ref_grid.Grid1D(200, 0.5)
    got = n(grid.deposit_stacked(g, t(xs), t(ws), t(als), t(charges)))
    want = n(ref_grid.deposit_stacked(rg, jnp.asarray(xs), jnp.asarray(ws),
                                      jnp.asarray(als),
                                      jnp.asarray(charges)))
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)
    q = np.random.default_rng(5).normal(size=(2, 3000)).astype(np.float32)
    got = n(grid.deposit_windowed(g, t(xs[:2]), t(q)))
    want = n(ref_grid.deposit_windowed(rg, jnp.asarray(xs[:2]),
                                       jnp.asarray(q)))
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(got.sum() * 0.5, q.sum(), rtol=1e-4,
                               atol=1e-3)


@pytest.mark.parametrize("mode", ["take", "onehot"])
def test_gathers_match(mode):
    x, *_ = _data()
    e = np.random.default_rng(2).normal(size=201).astype(np.float32)
    g, rg = grid.Grid1D(200, 0.5), ref_grid.Grid1D(200, 0.5)
    fn = grid.gather if mode == "take" else grid.gather_onehot
    rfn = ref_grid.gather if mode == "take" else ref_grid.gather_onehot
    np.testing.assert_allclose(n(fn(g, t(e), t(x))),
                               n(rfn(rg, jnp.asarray(e), jnp.asarray(x))),
                               **TOL)


def test_grid_geometry_matches():
    g, rg = grid.Grid1D(64, 0.25, x0=1.0), ref_grid.Grid1D(64, 0.25, x0=1.0)
    assert (g.ng, g.length) == (rg.ng, rg.length)
    np.testing.assert_allclose(n(g.nodes("cpu")), n(rg.nodes()), **TOL)


@pytest.mark.parametrize("ng", [257, 102_401])
@pytest.mark.parametrize("bc", [(0.0, 0.0), (1.5, -0.5)])
def test_solve_poisson_matches(ng, bc):
    rho = np.random.default_rng(ng).normal(size=ng).astype(np.float32)
    got = n(fields.solve_poisson(t(rho), 0.5, 2.0, *bc))
    want = n(ref_fields.solve_poisson(jnp.asarray(rho), 0.5, 2.0, *bc))
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-5 * scale
    assert got[0] == bc[0] and got[-1] == bc[1]


@pytest.mark.parametrize("passes", [1, 3])
def test_smoother_and_efield_match(passes):
    f = np.random.default_rng(7).normal(size=513).astype(np.float32)
    got = n(fields.smooth_binomial(t(f), passes))
    want = n(ref_fields.smooth_binomial(jnp.asarray(f), passes))
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(n(fields.efield(t(f), 0.25)),
                               n(ref_fields.efield(jnp.asarray(f), 0.25)),
                               **TOL)


def test_field_chain_matches():
    """deposit -> smooth -> Poisson -> E, as the cycle's field phase."""
    x, v, w, alive, L = _data(nc=256, cap=4096, dx=1.0)
    rb, pb = _bufs(x, v, w, alive)
    g, rg = grid.Grid1D(256, 1.0), ref_grid.Grid1D(256, 1.0)
    rho = fields.smooth_binomial(grid.deposit(g, pb, -1.0))
    rrho = ref_fields.smooth_binomial(ref_grid.deposit(rg, rb, -1.0))
    e = n(fields.efield(fields.solve_poisson(rho, 1.0), 1.0))
    re = n(ref_fields.efield(ref_fields.solve_poisson(rrho, 1.0), 1.0))
    assert np.abs(e - re).max() <= 1e-4 * np.abs(re).max()
    assert torch.isfinite(torch.from_numpy(e)).all()


def test_diagnostics_match():
    from repro.core import diagnostics as ref_diag
    from repro_torch.core import diagnostics

    x, v, w, alive, L = _data()
    rb, pb = _bufs(x, v, w, alive)
    e = np.random.default_rng(3).normal(size=201).astype(np.float32)
    pairs = [
        (diagnostics.kinetic_energy(pb, 3.5),
         ref_diag.kinetic_energy(rb, 3.5)),
        (diagnostics.total_charge(pb, -1.0), ref_diag.total_charge(rb, -1.0)),
        (diagnostics.momentum(pb, 2.0), ref_diag.momentum(rb, 2.0)),
        (diagnostics.field_energy(t(e), grid.Grid1D(200, 0.5), 2.0),
         ref_diag.field_energy(jnp.asarray(e), ref_grid.Grid1D(200, 0.5),
                               2.0)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(n(got), n(want), rtol=1e-5, atol=1e-5)
