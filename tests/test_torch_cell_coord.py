"""One rounding of the cell coordinate on every path of the port.

The reference computes s = (x - x0) / dx under ``jax.jit``, and XLA turns
that division by a constant into a multiply by the float32 reciprocal; an
IEEE division rounds an ulp apart on a good share of the elements whenever
dx is no power of two. The port multiplies by ``inv_dx(dx)`` =
float32(1 / float32(dx)) on every path (the CUDA kernels take it as an
argument), so at dx = 10 / 58,111, a spacing no config uses, its cell
coordinates, cell indices and CIC weights equal the jitted reference's on
every element, and so do its other divisions by dx: the density's and the
E stencil's. The push and deposit plain versions at that spacing hold to
the reference's oracles within the bands of ``tests/test_kernels.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import n, t
from repro.core import collisions as ref_coll
from repro.core import fields as ref_fields
from repro.core import grid as ref_grid
from repro.core import mover as ref_mover
from repro.core import particles as ref_particles
from repro.kernels import ops as ref_ops
from repro.kernels import ref
from repro_torch.core import collisions, fields, grid, particles
from repro_torch.core import mover as port_mover
from repro_torch.kernels import fused_cycle, mover, ops

NC = 58_111
LENGTH = 10.0
DX = LENGTH / NC
N = 250_000
TOL = dict(rtol=2e-5, atol=2e-5)


def _x(seed=0, n_=N):
    return np.random.default_rng(seed).uniform(0.0, LENGTH, n_).astype(
        np.float32)


def test_inv_dx_is_the_float32_reciprocal_jit_multiplies_by():
    x = _x()
    s_ref = np.asarray(jax.jit(lambda a: (a - 0.0) / DX)(x))
    np.testing.assert_array_equal(s_ref, x * np.float32(mover.inv_dx(DX)))
    # the IEEE division the kernels used before rounds apart on many
    # elements: the spacing has teeth
    assert int((s_ref != x / np.float32(DX)).sum()) > N // 10


def test_cic_weights_equal_the_jitted_reference():
    x = _x(1)
    g_ref = ref_grid.Grid1D(nc=NC, dx=DX)
    i_g, f_g = jax.jit(lambda a: ref_grid._cic_weights(g_ref, a))(x)
    i_k, f_k = jax.jit(lambda a: ref._cic(a, 0.0, DX, NC))(x)
    for fn in (lambda a: grid._cic_weights(grid.Grid1D(nc=NC, dx=DX), a),
               lambda a: mover.cic(a, 0.0, DX, NC)):
        i, f = fn(t(x))
        for want_i, want_f in ((i_g, f_g), (i_k, f_k)):
            np.testing.assert_array_equal(n(i), np.asarray(want_i))
            np.testing.assert_array_equal(n(f), np.asarray(want_f))


def test_cell_indices_equal_the_jitted_reference():
    x = _x(2)
    alive = np.random.default_rng(3).random(N) < 0.9
    jbuf = ref_particles.SpeciesBuffer(
        x=jnp.asarray(x), v=jnp.zeros((N, 3)), w=jnp.ones(N),
        alive=jnp.asarray(alive))
    pbuf = particles.SpeciesBuffer(x=t(x), v=t(np.zeros((N, 3), np.float32)),
                                   w=t(np.ones(N, np.float32)),
                                   alive=t(alive))
    want = jax.jit(lambda b: ref_particles.cell_index(b, DX, NC))(jbuf)
    np.testing.assert_array_equal(n(particles.cell_index(pbuf, DX, NC)),
                                  np.asarray(want))
    want = jax.jit(lambda a, ok: ref_coll._cells(a, ok, DX, NC))(x, alive)
    np.testing.assert_array_equal(n(collisions._cells(t(x), t(alive), DX,
                                                      NC)), np.asarray(want))


def test_density_divisions_equal_the_jitted_reference():
    """One particle a cell, so every node sums two charges and the sum is
    exact on both sides: what is left to compare is the division by dx."""
    rng = np.random.default_rng(4)
    x = ((np.arange(NC) + rng.uniform(0.05, 0.95, NC)) * DX).astype(
        np.float32)
    w = rng.uniform(0.5, 2.0, NC).astype(np.float32)
    alive = np.ones(NC, bool)
    g_ref = ref_grid.Grid1D(nc=NC, dx=DX)
    jbuf = ref_particles.SpeciesBuffer(
        x=jnp.asarray(x), v=jnp.zeros((NC, 3)), w=jnp.asarray(w),
        alive=jnp.asarray(alive))
    pbuf = particles.SpeciesBuffer(x=t(x), v=t(np.zeros((NC, 3), np.float32)),
                                   w=t(w), alive=t(alive))
    g = grid.Grid1D(nc=NC, dx=DX)
    want = jax.jit(lambda b: ref_grid.deposit(g_ref, b, -1.0))(jbuf)
    np.testing.assert_array_equal(n(grid.deposit(g, pbuf, -1.0)),
                                  np.asarray(want))
    want = jax.jit(lambda b: ref_coll.cell_density(g_ref, b))(jbuf)
    np.testing.assert_array_equal(n(collisions.cell_density(g, pbuf)),
                                  np.asarray(want))


def test_efield_stencil_equals_the_jitted_reference():
    phi = np.random.default_rng(5).normal(0.0, 1.0, NC + 1).astype(np.float32)
    want = jax.jit(lambda p: ref_fields.efield(p, DX))(phi)
    np.testing.assert_array_equal(n(fields.efield(t(phi), DX)),
                                  np.asarray(want))


def _planes(a):
    return jnp.asarray(a)[None, :]


@pytest.mark.parametrize("boundary", ["periodic", "absorb", "open"])
def test_push_and_deposit_plain_hold_to_the_jitted_oracles(boundary):
    cap = 40_000
    rng = np.random.default_rng(6)
    x = rng.uniform(0.0, LENGTH, cap).astype(np.float32)
    v = rng.normal(0.0, 1.0, (cap, 3)).astype(np.float32)
    alive = rng.random(cap) < 0.9
    w = (rng.random(cap) * alive).astype(np.float32)
    e = rng.normal(0.0, 1.0, NC + 1).astype(np.float32)
    b = (0.05, -0.1, 0.2)
    kw = dict(x0=0.0, dx=DX, nc=NC, length=LENGTH, b=b, boundary=boundary)
    qm, dt, charge = -1.0, 0.05, -1.0
    oracle = jax.jit(lambda *a: ref.fused_push_deposit_ref(
        *a, qm=qm, dt=dt, charge=charge, ng_pad=NC + 1, **kw))
    rx, rvx, rvy, rvz, ra, rhl, rhr, rw, _ = oracle(
        *map(_planes, (x, v[:, 0], v[:, 1], v[:, 2],
                       alive.astype(np.float32), w, e)))
    f32 = np.float32
    xn, vn, an, hl, hr, wn, rho = ops.fused_push_deposit(
        t(x)[None], t(v)[None], t(w)[None], t(alive)[None], t(e),
        t(np.array([qm * dt], f32)), t(np.array([dt], f32)),
        t(np.array([charge], f32)), **kw)
    np.testing.assert_allclose(n(xn[0]), np.asarray(rx)[0], **TOL)
    np.testing.assert_allclose(
        n(vn[0]), np.stack([np.asarray(p)[0] for p in (rvx, rvy, rvz)], -1),
        **TOL)
    np.testing.assert_allclose(n(wn[0]), np.asarray(rw)[0], **TOL)
    for got, want in ((an, ra), (hl, rhl), (hr, rhr)):
        np.testing.assert_array_equal(n(got[0]), np.asarray(want)[0] > 0.5)
    # the deposit half on the port's own pushed positions: at this spacing
    # an ulp of x moves f by 0.006, so the oracle's rho (on its own x)
    # differs by more than the band wherever x does by an ulp
    deposit_oracle = jax.jit(lambda a, c: ref.deposit_ref(
        a, c, x0=0.0, dx=DX, nc=NC, ng_pad=NC + 1))
    want_rho = np.asarray(deposit_oracle(n(xn[0]), n(wn[0]) * charge))[0]
    want_rho = want_rho * np.float32(mover.inv_dx(DX))
    np.testing.assert_allclose(n(rho), want_rho, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(float(n(rho).sum(dtype=np.float64)),
                               float(want_rho.sum(dtype=np.float64)),
                               rtol=1e-5)
    # the mover alone, through its own plain version
    mx, _, ma, _, _ = mover.mover_push_plain(
        t(x), t(v), t(alive), t(e), qm_dt=qm * dt, dt=dt, **kw)
    np.testing.assert_allclose(n(mx), n(xn[0]), **TOL)
    np.testing.assert_array_equal(n(ma), n(an[0]))
    # the deposit alone, against the jitted oracle on the oracle's state
    q = np.asarray(rw)[0] * charge
    want = deposit_oracle(np.asarray(rx)[0], q)
    got = fused_cycle.deposit_plain(t(np.asarray(rx)[0]), t(q), x0=0.0,
                                    dx=DX, nc=NC)
    np.testing.assert_allclose(n(got), np.asarray(want)[0], rtol=1e-3,
                               atol=1e-3)


def _wall_positions(length):
    """float32 positions on and within 64 steps of -L, 0, L and 2L (the
    pushed positions a periodic wrap sees just past each wall): ulps of
    the wall, and at 0 multiples of L's ulp (an ulp of 0 is subnormal,
    which XLA on the CPU flushes to 0 and PyTorch keeps)."""
    f32 = np.float32
    step = np.spacing(f32(length))
    out = [f32(k) * step for k in range(-64, 65)]
    for wall in (-f32(length), f32(length), f32(2) * f32(length)):
        lo = hi = wall
        out.append(wall)
        for _ in range(64):
            lo = np.nextafter(lo, f32(-np.inf))
            hi = np.nextafter(hi, f32(np.inf))
            out += [lo, hi]
    return np.asarray(out, f32)


# 10 is the length of the dx = 10 / 58,111 grid; at 3.7 and 7 the float32
# reciprocal rounds L * (1 / L) off 1, so a position on a wall wraps apart
# under the two roundings of x / L
@pytest.mark.parametrize("length", [LENGTH, 3.7, 7.0])
def test_periodic_wrap_equals_the_reference_kernels(length):
    """The periodic wrap x - floor(x / L) * L at positions on and just past
    each wall (v = 0, E = 0, so the push leaves x as it is): the port's
    plain mover and fused push equal the reference's Pallas kernels
    (interpret mode) and its jitted oracle to 0 ulp; its ``apply_boundary``
    equals the reference's ``jnp.mod``."""
    x = _wall_positions(length)
    m = x.size
    nc = NC if length == LENGTH else 64
    dx = length / nc
    v = np.zeros((m, 3), np.float32)
    alive = np.ones(m, bool)
    w = np.ones(m, np.float32)
    e = np.zeros(nc + 1, np.float32)
    kw = dict(x0=0.0, dx=dx, length=length, b=(0.0, 0.0, 0.0),
              boundary="periodic")
    want = np.asarray(ref_ops.mover_push(
        jnp.asarray(x), jnp.asarray(v), jnp.asarray(alive), jnp.asarray(e),
        qm=-1.0, dt=0.05, **kw)[0])
    fused_want = np.asarray(ref_ops.fused_push_deposit(
        jnp.asarray(x), jnp.asarray(v), jnp.asarray(alive), jnp.asarray(w),
        jnp.asarray(e), qm=-1.0, dt=0.05, charge=-1.0, **kw)[0])
    oracle = np.asarray(jax.jit(lambda *a: ref.mover_push_ref(
        *a, x0=0.0, dx=dx, nc=nc, length=length, qm=-1.0, dt=0.05,
        b=(0.0, 0.0, 0.0), boundary="periodic"))(
        *map(_planes, (x, v[:, 0], v[:, 1], v[:, 2],
                       alive.astype(np.float32), e)))[0])[0]
    np.testing.assert_array_equal(fused_want, want)
    np.testing.assert_array_equal(oracle, want)
    got = mover.mover_push_plain(t(x), t(v), t(alive), t(e), qm_dt=-0.05,
                                 dt=0.05, nc=nc, **kw)[0]
    np.testing.assert_array_equal(n(got), want)
    f32 = np.float32
    got = ops.fused_push_deposit(
        t(x)[None], t(v)[None], t(w)[None], t(alive)[None], t(e),
        t(np.array([-0.05], f32)), t(np.array([0.05], f32)),
        t(np.array([-1.0], f32)), nc=nc, deposit=True, **kw)[0][0]
    np.testing.assert_array_equal(n(got), want)
    jmod = np.asarray(jax.jit(lambda a: ref_mover.apply_boundary(
        a, jnp.ones(a.shape, bool), length, "periodic")[0])(x))
    np.testing.assert_array_equal(
        n(port_mover.apply_boundary(t(x), t(alive), length, "periodic")[0]),
        jmod)
    if length != LENGTH:
        # the wrap has teeth here: an IEEE division of x / L rounds a
        # position on a wall to the other side
        ieee = x - np.floor(x / np.float32(length)) * np.float32(length)
        assert (ieee != want).any()
