"""MC sources of the port against the reference: ionization, wall emission
and the buffer edits they use.

With the reference's draws handed in, every decision (hits, ranks, slots,
counts, alive masks) is exact and the positions and velocities are copies;
floats that pass through arithmetic use rtol = atol = 2e-5. The default
torch.Generator path is checked statistically, against the analytic decay,
as ``tests/test_physics_ionization.py`` checks the reference.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import n, t
from repro.core import boundaries as ref_bnd
from repro.core import collisions as ref_coll
from repro.core import grid as ref_grid
from repro.core import particles as ref_particles
from repro_torch.core import boundaries, collisions, grid, particles, pic

TOL = dict(rtol=2e-5, atol=2e-5)


def _buf_pair(cap, n_alive, seed, L=64.0, scatter=False):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, L, cap).astype(np.float32)
    v = rng.normal(size=(cap, 3)).astype(np.float32)
    alive = np.arange(cap) < n_alive
    if scatter:
        alive = rng.permutation(alive)
    w = (rng.random(cap).astype(np.float32) + 0.5) * alive
    return (ref_particles.SpeciesBuffer(jnp.asarray(x), jnp.asarray(v),
                                        jnp.asarray(w), jnp.asarray(alive)),
            particles.SpeciesBuffer(t(x), t(v), t(w), t(alive)))


def _check_buf(got, want, exact=True):
    for f in ("x", "v", "w"):
        if exact:
            np.testing.assert_array_equal(n(getattr(got, f)),
                                          n(getattr(want, f)))
        else:
            np.testing.assert_allclose(n(getattr(got, f)),
                                       n(getattr(want, f)), **TOL)
    np.testing.assert_array_equal(n(got.alive), n(want.alive))


@pytest.mark.parametrize("rate,n_e,n_i", [(0.05, 3000, 3000),
                                          (0.5, 3900, 3950)])
def test_ionize_with_reference_draws_is_exact(rate, n_e, n_i):
    """(0.5, nearly full buffers) exercises the capacity clamp."""
    cap = 4000
    rn, pn = _buf_pair(cap, 3000, 1, scatter=True)
    re, pe = _buf_pair(cap, n_e, 2)
    ri, pi = _buf_pair(cap, n_i, 3)
    params = ref_coll.IonizationParams(rate=rate, vth_electron=1.0)
    key = jax.random.PRNGKey(5)
    ku, kv = jax.random.split(key)
    draws = {"uniform": n(jax.random.uniform(ku, (cap,), jnp.float32)),
             "normal": n(jax.random.normal(kv, (cap, 3), jnp.float32))}
    rg = ref_grid.Grid1D(64, 1.0)
    want = ref_coll.ionize(key, rn, re, ri, rg, params, 0.2)
    got = collisions.ionize(
        None, pn, pe, pi, grid.Grid1D(64, 1.0),
        collisions.IonizationParams(rate=rate, vth_electron=1.0), 0.2,
        draws=draws)
    for g_, w_ in zip(got[:3], want[:3]):
        _check_buf(g_, w_)
    assert {k: int(v) for k, v in got[3].items()} == \
        {k: int(v) for k, v in want[3].items()}
    assert int(got[3]["n_ionized"]) > 0
    if n_e > 3500:
        assert int(got[3]["birth_overflow"]) > 0
    for f in collisions.IonizationBirths._fields:
        np.testing.assert_array_equal(n(getattr(got[4], f)),
                                      n(getattr(want[4], f)))


def test_ionization_decay_matches_exponential_with_generator():
    """The reference's §3.3 physics test on the port's own random stream."""
    nc, n0, rate = 256, 16384, 2e-3
    cap = 4 * n0
    sp = (
        pic.SpeciesConfig("e", -1.0, 1.0, cap, n0, vth=1.0),
        pic.SpeciesConfig("D+", +1.0, 3672.0, cap, n0, vth=0.02),
        pic.SpeciesConfig("D", 0.0, 3672.0, cap, n0, vth=0.02),
    )
    cfg = pic.PICConfig(nc=nc, dx=1.0, dt=0.05, species=sp,
                        field_solve=False, boundary="periodic",
                        ionization=(2, 0, 1), ionization_rate=rate,
                        ionization_vth_e=1.0, strategy="fused")
    steps = 200
    _, diags = pic.run(cfg, steps, seed=42, device="cpu")
    nn = n(diags["D/count"]).astype(np.float64)
    ne = n(diags["e/count"]).astype(np.float64) / nc
    lhs = np.log(nn[-1] / nn[0])
    rhs = -np.sum(ne[:-1] * rate * cfg.dt)
    assert nn[0] - nn[-1] > 500, "test underpowered"
    assert abs(lhs - rhs) / abs(rhs) < 0.15, (lhs, rhs)
    ni = n(diags["D+/count"])
    np.testing.assert_array_equal(n(diags["e/count"]) - n0, ni - n0)
    np.testing.assert_array_equal(n0 - n(diags["D/count"]), ni - n0)
    assert int(n(diags["ionize_dropped"]).sum()) == 0


def test_wall_emission_with_reference_draws_is_exact():
    cap = 3000
    rng = np.random.default_rng(8)
    hl = rng.random(cap) < 0.05
    hr = (rng.random(cap) < 0.05) & ~hl
    rt, pt = _buf_pair(cap, 2900, 9, L=32.0)
    rp, pp = _buf_pair(cap, 2000, 10, L=32.0)
    key = jax.random.PRNGKey(3)
    ku, kv = jax.random.split(key)
    draws = {"uniform": n(jax.random.uniform(ku, (cap,))),
             "normal": n(jax.random.normal(kv, (cap, 3), jnp.float32))}
    want = ref_bnd.wall_emission(key, rp, jnp.asarray(hl), jnp.asarray(hr),
                                 rt, ref_bnd.EmissionParams(0.6, 0.5, 0.25),
                                 32.0)
    got = boundaries.wall_emission(None, pp, t(hl), t(hr), pt,
                                   boundaries.EmissionParams(0.6, 0.5, 0.25),
                                   32.0, draws=draws)
    _check_buf(got[0], want[0])
    assert {k: int(v) for k, v in got[1].items()} == \
        {k: int(v) for k, v in want[1].items()}
    assert int(got[1]["emission_dropped"]) > 0      # the buffer overflowed
    for f in boundaries.EmissionRows._fields:
        np.testing.assert_array_equal(n(getattr(got[2], f)),
                                      n(getattr(want[2], f)))


def test_emission_with_generator_points_into_the_domain():
    cap = 20_000
    hl = torch.zeros(cap, dtype=torch.bool)
    hr = torch.zeros(cap, dtype=torch.bool)
    hl[:5000] = True
    hr[5000:10_000] = True
    gen = torch.Generator().manual_seed(0)
    emit, x, v, w = boundaries.emission_candidates(
        gen, hl, hr, boundaries.EmissionParams(0.5, 1.0), 10.0,
        torch.float32)
    assert abs(int(emit.sum()) - 5000) < 300
    assert not emit[10_000:].any()
    assert (v[:5000, 0] >= 0).all() and (v[5000:10_000, 0] <= 0).all()
    assert (x[:5000] > 0).all() and (x[5000:10_000] < 10.0).all()


@pytest.mark.parametrize("max_n", [1, 7, 500, 4000])
def test_free_slots_and_inject_match_reference(max_n):
    rb, pb = _buf_pair(1000, 700, 11, scatter=True)
    np.testing.assert_array_equal(n(particles.free_slots(pb, max_n)),
                                  n(ref_particles.free_slots(rb, max_n)))
    rng = np.random.default_rng(max_n)
    m = 400
    x = rng.uniform(0, 64, m).astype(np.float32)
    v = rng.normal(size=(m, 3)).astype(np.float32)
    w = rng.random(m).astype(np.float32)
    mask = rng.random(m) < 0.9
    got = particles.inject_masked(pb, t(x), t(v), t(w), t(mask))
    want = ref_particles.inject_masked(rb, jnp.asarray(x), jnp.asarray(v),
                                       jnp.asarray(w), jnp.asarray(mask))
    _check_buf(got[0], want[0])
    assert int(got[1]) == int(want[1]) > 0
    np.testing.assert_array_equal(n(got[2]), n(want[2]))
    plain, dropped = particles.inject(pb, t(x), t(v), t(w), t(mask))
    _check_buf(plain, want[0])
    assert int(dropped) == int(want[1])
    killed = particles.kill(got[0], torch.zeros(1000, dtype=torch.bool))
    _check_buf(killed, got[0])
    mk = rng.random(1000) < 0.3
    _check_buf(particles.kill(got[0], t(mk)),
               ref_particles.kill(want[0], jnp.asarray(mk)))


def test_init_uniform_with_reference_draws_is_exact():
    key = jax.random.PRNGKey(4)
    want = ref_particles.init_uniform(key, 2048, 1500, 64.0, 0.7, drift=0.3,
                                      weight=2.0)
    kx, kv = jax.random.split(key)
    draws = {"uniform": n(jax.random.uniform(kx, (2048,), jnp.float32)),
             "normal": n(jax.random.normal(kv, (2048, 3), jnp.float32))}
    got = particles.init_uniform(torch.Generator(), 2048, 1500, 64.0, 0.7,
                                 drift=0.3, weight=2.0, draws=draws)
    _check_buf(got, want)
    st = particles.stack_species([got, got])
    assert n(st.counts()).tolist() == [1500, 1500]
    back = particles.unstack_species(st)
    _check_buf(back[1], want)
    empty = particles.make_species(16, device="cpu")
    assert int(empty.count()) == 0 and empty.capacity == 16
    with pytest.raises(ValueError, match="equal capacities"):
        particles.stack_species([got, empty])


def test_ionization_needs_a_zero_charge_neutral_to_carry_rho():
    cfg = dataclasses.replace(
        pic.PICConfig(species=(
            pic.SpeciesConfig("e", -1.0, 1.0, 64, 32, 1.0),
            pic.SpeciesConfig("D+", 1.0, 3672.0, 64, 32, 0.02),
            pic.SpeciesConfig("D", 0.0, 3672.0, 64, 32, 0.02)),
            ionization=(2, 0, 1)), strategy="fused")
    assert pic._carries_rho(cfg)
    assert not pic._carries_rho(dataclasses.replace(cfg, ionization=(1, 0, 2)))
