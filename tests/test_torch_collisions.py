"""The binary-collision menu of the port against the reference's
(``repro.core.collisions``), and the cell helpers of ``core/particles.py``.

With the reference's draws handed in (``_torch_parity.collision_draws``),
integer outputs, permutations, masks and event counters are exact and
charge-exchange velocities are bitwise copies. Elastic and Coulomb
velocities pass through cos/sin and a norm, which XLA and torch round
differently by ulps: rtol = atol = 1e-6. The torch.Generator path is held
to the physics properties that ``tests/test_collisions_physics.py`` pins on
the reference.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import collision_draws, menu_draws, n, t
from repro.core import collisions as ref_coll
from repro.core import grid as ref_grid
from repro.core import particles as ref_particles
from repro_torch.core import collisions as C
from repro_torch.core import particles
from repro_torch.core.grid import Grid1D

VTOL = dict(rtol=1e-6, atol=1e-6)


def _bufs(cap, n_alive, length, seed, vth=1.0, holes=0, shuffle=False):
    """(reference, port) buffers of the same numpy data; ``holes`` kills
    every holes-th row, ``shuffle`` scatters the live rows."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, length, cap).astype(np.float32)
    v = (vth * rng.normal(size=(cap, 3))).astype(np.float32)
    alive = np.arange(cap) < n_alive
    if shuffle:
        alive = rng.permutation(alive)
    if holes:
        alive[::holes] = False
    w = np.ones(cap, np.float32) * alive
    return (ref_particles.SpeciesBuffer(jnp.asarray(x), jnp.asarray(v),
                                        jnp.asarray(w), jnp.asarray(alive)),
            particles.SpeciesBuffer(t(x), t(v), t(w), t(alive)))


def _grids(nc, dx=1.0):
    return ref_grid.Grid1D(nc=nc, dx=dx), Grid1D(nc=nc, dx=dx)


def _same_buf(got, want, v_exact=True):
    for f in ("x", "w", "alive"):
        np.testing.assert_array_equal(n(getattr(got, f)),
                                      n(getattr(want, f)))
    if v_exact:
        np.testing.assert_array_equal(n(got.v), n(want.v))
    else:
        np.testing.assert_allclose(n(got.v), n(want.v), **VTOL)


# ------------------------------------------------------------ cell helpers


@pytest.mark.parametrize("cap,nc,seed", [(1000, 16, 0), (4097, 64, 1),
                                         (7, 3, 2)])
def test_cell_helpers_match_reference(cap, nc, seed):
    rb, pb = _bufs(cap, int(0.7 * cap), float(nc), seed, shuffle=True)
    np.testing.assert_array_equal(
        n(particles.cell_index(pb, 1.0, nc)),
        n(ref_particles.cell_index(rb, 1.0, nc)))
    np.testing.assert_array_equal(
        n(particles.counts_per_cell(pb, 1.0, nc)),
        n(ref_particles.counts_per_cell(rb, 1.0, nc)))
    _same_buf(particles.sort_by_cell(pb, 1.0, nc),
              ref_particles.sort_by_cell(rb, 1.0, nc))
    _same_buf(particles.compact(pb), ref_particles.compact(rb))
    cells = ref_coll._cells(rb.x, rb.alive, 1.0, nc)
    for got, want in zip(particles.cell_bins(t(n(cells)), nc),
                         ref_particles.cell_bins(cells, nc)):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(n(got), n(want))
    idx = np.random.default_rng(seed).integers(0, cap + 1, 50)
    _same_buf(particles.take(pb, t(idx)),
              ref_particles.take(rb, jnp.asarray(idx)))


def test_cell_density_matches_reference():
    rg, pg = _grids(32, dx=0.5)
    rb, pb = _bufs(3000, 2500, rg.length + 1.0, 3, holes=7)
    # out-of-domain rows are not eligible; random weights sum in another
    # order than XLA's scatter-add
    w = np.random.default_rng(4).random(3000).astype(np.float32)
    rb = dataclasses.replace(rb, w=jnp.asarray(w) * rb.alive)
    pb = dataclasses.replace(pb, w=t(w) * pb.alive)
    np.testing.assert_allclose(n(C.cell_density(pg, pb)),
                               n(ref_coll.cell_density(rg, rb)),
                               rtol=1e-6, atol=1e-6)
    # unit weights: exact integer counts over dx
    rb1 = dataclasses.replace(rb, w=rb.alive.astype(jnp.float32))
    pb1 = dataclasses.replace(pb, w=pb.alive.float())
    np.testing.assert_array_equal(n(C.cell_density(pg, pb1)),
                                  n(ref_coll.cell_density(rg, rb1)))


@pytest.mark.parametrize("case", ["edges", "all_dead", "n0"])
def test_cell_density_counts_only_eligible_rows(case):
    """``cell_density`` on rows at the cell edges, at x = L and just below
    0 (counted only inside [0, L)), with every row dead, and with none: a
    numpy histogram of the eligible rows by floor(x / dx)."""
    nc, dx = 16, 0.5
    g = Grid1D(nc=nc, dx=dx)
    x = np.concatenate([np.arange(nc + 1) * dx, [-1e-7, -0.0, g.length - 1e-4,
                                                g.length + 3.0]])
    x = x.astype(np.float32)
    alive = np.ones(x.shape, bool) if case == "edges" else \
        np.zeros(x.shape, bool)
    if case == "n0":
        x, alive = x[:0], alive[:0]
    buf = particles.SpeciesBuffer(x=t(x), v=t(np.zeros((len(x), 3),
                                                        np.float32)),
                                  w=t(np.ones(len(x), np.float32)),
                                  alive=t(alive))
    ok = alive & (x >= 0) & (x < g.length)
    want = np.zeros(nc, np.float32)
    np.add.at(want, np.floor(x[ok] / dx).astype(int).clip(0, nc - 1), 1.0)
    got = n(C.cell_density(g, buf))
    np.testing.assert_array_equal(got, want / np.float32(dx))
    assert got.sum() == (ok.sum() / dx)


def _sorted_keys(case):
    """(sorted int32 cell keys, nc) of one bin-starts case; ineligible rows
    are keyed nc."""
    rng = np.random.default_rng(len(case))
    nc = {"single_cell": 1, "n1": 7}.get(case, 50)
    n_rows = {"n0": 0, "n1": 1}.get(case, 3000)
    keys = rng.integers(0, nc + 1, n_rows)
    if case == "empty_cells":
        keys = np.where(rng.random(n_rows) < 0.8,
                        rng.integers(10, 20, n_rows), nc)
    if case == "all_sentinel":
        keys[:] = nc
    return t(np.sort(keys).astype(np.int32)), nc


@pytest.mark.parametrize("case", ["random", "empty_cells", "all_sentinel",
                                  "single_cell", "n1", "n0"])
def test_cell_bounds_plain_matches_cell_bins(case):
    """Starts from sorted keys (``_cell_starts``, a search of each cell in
    the keys) equal ``cell_bins``' histogram table, and their differences
    (with n after the last) its counts."""
    keys, nc = _sorted_keys(case)
    counts, starts = particles.cell_bins(keys, nc)
    got = C._cell_starts(keys, nc)
    assert got.dtype == torch.int32 and got.shape == (nc + 1,)
    assert torch.equal(got, starts)
    assert torch.equal(torch.diff(got, append=got.new_full(
        (1,), keys.shape[0])), counts)


@pytest.mark.parametrize("seed,p_hit", [(0, 0.04), (1, 0.5), (2, 1.0)])
def test_cx_rank_from_cell_starts_equals_the_hit_histogram_path(seed, p_hit):
    """``charge_exchange``'s rank of each event within its cell
    (``_hit_ranks``: the cumsum at each cell's first sorted row) equals
    the rank the hits' own bin table gave (``cell_bins`` of the hits,
    others keyed nc) on every hit row."""
    rng = np.random.default_rng(seed)
    nc, cap = 40, 5000
    ok = rng.random(cap) < 0.7
    c_i = t(np.where(ok, rng.integers(0, nc, cap), nc).astype(np.int32))
    hit = t(ok & (rng.random(cap) < p_hit))
    i_order, c_sort, hit_sort, rk = C._hit_ranks(c_i, hit, nc)
    assert torch.equal(i_order, torch.sort(c_i, stable=True).indices)
    assert torch.equal(c_sort, c_i[i_order].long())
    _, starts_h = particles.cell_bins(torch.where(hit, c_i, nc), nc)
    want = torch.cumsum(hit_sort, 0) - 1 - starts_h[c_sort]
    assert int(hit_sort.sum()) > 0
    assert torch.equal(rk[hit_sort], want[hit_sort])


@pytest.mark.parametrize("cap,nc,seed", [(2048, 16, 0), (1001, 5, 1)])
def test_cell_order_and_pairs_match_reference(cap, nc, seed):
    """Dead rows read the draw of the previous live row: ties the sort must
    break as the reference's stable argsort does."""
    rng = np.random.default_rng(seed)
    ok = rng.random(cap) < 0.8
    cell = np.where(ok, rng.integers(0, nc, cap), nc).astype(np.int32)
    key = jax.random.PRNGKey(seed)
    draws = {"shuffle": n(jax.random.uniform(key, (cap,)))}
    gen = torch.Generator()
    got = C.cell_shuffled_order(gen, t(cell), t(ok), draws)
    want = ref_coll.cell_shuffled_order(key, jnp.asarray(cell),
                                        jnp.asarray(ok))
    np.testing.assert_array_equal(n(got), n(want))
    for g, w in zip(C.pair_in_cells(gen, t(cell), t(ok), draws),
                    ref_coll.pair_in_cells(key, jnp.asarray(cell),
                                           jnp.asarray(ok))):
        np.testing.assert_array_equal(n(g), n(w))


def test_pairing_is_segment_local_and_odd_capacity_safe():
    """The reference's regression: cell 1's segment starts at an odd
    offset and still forms 2 pairs (cell 0 one), on every seed; an odd
    capacity pairs cleanly, on reference draws and on the generator."""
    cell = torch.tensor([0, 0, 0, 1, 1, 1, 1], dtype=torch.int32)
    ok = torch.ones(7, dtype=torch.bool)
    for seed in range(16):
        key = jax.random.PRNGKey(seed)
        draws = {"shuffle": n(jax.random.uniform(key, (7,)))}
        for d in (draws, None):
            ia, ib, valid = C.pair_in_cells(torch.Generator().manual_seed(
                seed), cell, ok, d)
            assert int(valid.sum()) == 3, (seed, d is None)
            heads = cell[ia[valid]]
            assert (int((heads == 0).sum()), int((heads == 1).sum())) \
                == (1, 2)
            assert torch.equal(cell[ia[valid]], cell[ib[valid]])
        want = ref_coll.pair_in_cells(key, jnp.asarray(n(cell)),
                                      jnp.asarray(n(ok)))
        for g, w in zip(C.pair_in_cells(torch.Generator(), cell, ok, draws),
                        want):
            np.testing.assert_array_equal(n(g), n(w))
    g = Grid1D(nc=2, dx=3.5)
    buf = particles.SpeciesBuffer(
        x=torch.tensor([0.1, 0.2, 0.3, 4.0, 4.5, 5.0, 6.0]),
        v=torch.randn(7, 3, generator=torch.Generator().manual_seed(0)),
        w=torch.ones(7), alive=ok)
    _, npairs = C.coulomb_intra(torch.Generator().manual_seed(1), buf,
                                C.cell_density(g, buf), g, 1e-2, 1.0)
    assert int(npairs) == 3


# ------------------------------------------- operators on reference draws


def _menu_entry(kind):
    return {"elastic": ref_coll.CollisionConfig("elastic", 0, 1, 0.0),
            "charge_exchange": ref_coll.CollisionConfig("charge_exchange", 0,
                                                        1, 0.0),
            "coulomb": ref_coll.CollisionConfig("coulomb", 0, None, 0.0)}[kind]


@pytest.mark.parametrize("seed", [0, 1])
def test_elastic_matches_reference(seed):
    rg, pg = _grids(32)
    rb, pb = _bufs(2048, 1800, rg.length, seed, holes=5, shuffle=True)
    dens = np.random.default_rng(seed).uniform(1, 20, 32).astype(np.float32)
    key = jax.random.PRNGKey(10 + seed)
    draws = collision_draws(_menu_entry("elastic"), key, [2048, 2048])
    want, nw = ref_coll.elastic_scatter(key, rb, jnp.asarray(dens), rg,
                                        0.02, 1.0)
    got, ng = C.elastic_scatter(torch.Generator(), pb, t(dens), pg, 0.02,
                                1.0, draws)
    assert int(ng) == int(nw) > 100
    _same_buf(got, want, v_exact=False)


@pytest.mark.parametrize("seed,rate", [(0, 0.05), (1, 0.5)])
def test_charge_exchange_matches_reference(seed, rate):
    """rate 0.5 starves cells of neutrals: the starved events must match
    too. The swap moves velocity rows intact: bitwise."""
    rg, pg = _grids(32)
    ri, pi = _bufs(2048, 1500, rg.length, seed, vth=0.05, holes=7)
    rn, pn = _bufs(2048, 900, rg.length, seed + 50, vth=0.02, holes=4,
                   shuffle=True)
    nn = ref_coll.cell_density(rg, rn)
    np.testing.assert_array_equal(n(C.cell_density(pg, pn)), n(nn))
    key = jax.random.PRNGKey(20 + seed)
    draws = collision_draws(_menu_entry("charge_exchange"), key,
                            [2048, 2048])
    wi, wn, nw = ref_coll.charge_exchange(key, ri, rn, nn, rg, rate, 1.0)
    gi, gn, ng = C.charge_exchange(torch.Generator(), pi, pn, t(n(nn)), pg,
                                   rate, 1.0, draws)
    assert int(ng) == int(nw) > 100
    _same_buf(gi, wi)
    _same_buf(gn, wn)


@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["ta_kick_ref", "kernel"])
def test_coulomb_matches_reference(use_kernel):
    rg, pg = _grids(16)
    rb, pb = _bufs(1024, 900, rg.length, 7, holes=9, shuffle=True)
    nd = ref_coll.cell_density(rg, rb)
    key = jax.random.PRNGKey(30)
    draws = collision_draws(_menu_entry("coulomb"), key, [1024])
    want, nw = ref_coll.coulomb_intra(key, rb, nd, rg, 5e-3, 1.0,
                                      use_kernel=use_kernel)
    got, ng = C.coulomb_intra(torch.Generator(), pb, t(n(nd)), pg, 5e-3,
                              1.0, use_kernel=use_kernel, draws=draws)
    assert int(ng) == int(nw) > 300
    _same_buf(got, want, v_exact=False)


def test_apply_menu_matches_reference():
    """The full menu over the (e-, D+, D) triple, one draws dict an entry
    in the reference's key order."""
    rg, pg = _grids(32)
    bufs = [_bufs(2048, 1600, rg.length, s, vth=v, holes=h)
            for s, v, h in ((0, 1.0, 9), (1, 0.05, 7), (2, 0.02, 4))]
    menu = (ref_coll.CollisionConfig("elastic", 0, 2, 2e-2),
            ref_coll.CollisionConfig("charge_exchange", 1, 2, 2e-2),
            ref_coll.CollisionConfig("coulomb", 0, None, 1e-2))
    pmenu = tuple(C.CollisionConfig(**dataclasses.asdict(cc))
                  for cc in menu)
    rdens = {i: ref_coll.cell_density(rg, bufs[i][0])
             for i in ref_coll.density_species(menu)}
    assert C.density_species(pmenu) == ref_coll.density_species(menu)
    assert C.involved_species(pmenu) == ref_coll.involved_species(menu)
    key = jax.random.PRNGKey(40)
    want, wd = ref_coll.apply_menu(key, {i: b[0] for i, b in
                                         enumerate(bufs)}, menu, rdens, rg,
                                   1.0)
    got, gd = C.apply_menu(torch.Generator(),
                           {i: b[1] for i, b in enumerate(bufs)}, pmenu,
                           {i: t(n(d)) for i, d in rdens.items()}, pg, 1.0,
                           draws=menu_draws(menu, key, [2048] * 3))
    assert {k: int(v) for k, v in gd.items()} == \
        {k: int(v) for k, v in wd.items()}
    assert min(int(v) for v in gd.values()) > 0
    for i in range(3):
        _same_buf(got[i], want[i], v_exact=i != 0)   # 1, 2: the CX swap


# --------------------------------------------- the torch.Generator path


def _port_buf(cap, n_alive, length, seed, vth=1.0, holes=0):
    return _bufs(cap, n_alive, length, seed, vth, holes)[1]


def _speed(v):
    return torch.sqrt((v.double() ** 2).sum(-1))


def test_elastic_keeps_speed_and_count():
    g = Grid1D(nc=64, dx=1.0)
    buf = _port_buf(2048, 2048, g.length, 0, holes=5)
    out, nev = C.elastic_scatter(torch.Generator().manual_seed(1), buf,
                                 torch.full((64,), 5.0), g, 0.5, 1.0)
    assert int(out.count()) == int(buf.count())
    assert int(nev) > 0
    np.testing.assert_allclose(n(_speed(out.v)), n(_speed(buf.v)),
                               rtol=1e-5)


def test_elastic_isotropy_chi_square():
    """Post-collision direction cosines uniform on [-1, 1] and azimuth
    uniform: chi-square over 16 bins under chi2_{0.999}(15) = 37.7."""
    g = Grid1D(nc=16, dx=1.0)
    buf = _port_buf(8192, 8192, g.length, 5)
    out, nev = C.elastic_scatter(torch.Generator().manual_seed(6), buf,
                                 torch.full((16,), 100.0), g, 1.0, 1.0)
    assert int(nev) > 8000
    v = n(out.v).astype(np.float64)
    dirs = v / np.linalg.norm(v, axis=1, keepdims=True)
    for axis in range(3):
        counts, _ = np.histogram(dirs[:, axis], bins=16, range=(-1.0, 1.0))
        expect = dirs.shape[0] / 16
        assert ((counts - expect) ** 2 / expect).sum() < 37.7, axis
    phi = np.arctan2(dirs[:, 2], dirs[:, 1])
    counts, _ = np.histogram(phi, bins=16, range=(-np.pi, np.pi))
    assert ((counts - counts.mean()) ** 2 / counts.mean()).sum() < 37.7


@pytest.mark.parametrize("kind", ["elastic", "charge_exchange"])
def test_event_count_matches_analytic_rate(kind):
    """Over a seed sweep the event fraction tracks 1 - exp(-n rate dt)
    within 4 binomial sigma (no starvation at these densities)."""
    g = Grid1D(nc=16, dx=1.0)
    dens, rate = 40.0, 5e-3
    p = 1.0 - np.exp(-dens * rate)
    hits = tot = 0
    for seed in range(6):
        gen = torch.Generator().manual_seed(90 + seed)
        sp = _port_buf(4096, 4096, g.length, seed, vth=0.05)
        nn = torch.full((16,), dens)
        if kind == "elastic":
            _, nev = C.elastic_scatter(gen, sp, nn, g, rate, 1.0)
        else:
            neut = _port_buf(4096, 4096, g.length, 50 + seed, vth=0.02)
            _, _, nev = C.charge_exchange(gen, sp, neut, nn, g, rate, 1.0)
        hits += int(nev)
        tot += 4096
    sigma = np.sqrt(tot * p * (1 - p))
    assert abs(hits - tot * p) < 4 * sigma, (hits, tot * p, sigma)


@pytest.mark.parametrize("kind", ["elastic", "coulomb"])
def test_compaction_seed_parity(kind):
    """Draws are occupancy-rank indexed: a compacted and an uncompacted
    buffer on one seed give bitwise the same surviving physics. (Coulomb's
    normal and azimuth follow the position in the cell order, which puts
    the live rows first either way.)"""
    g = Grid1D(nc=32, dx=1.0)
    buf = _port_buf(1024, 800, g.length, 3, holes=3)
    dens = torch.full((32,), 10.0)

    def run(b):
        gen = torch.Generator().manual_seed(7)
        if kind == "elastic":
            return C.elastic_scatter(gen, b, dens, g, 0.05, 1.0)
        return C.coulomb_intra(gen, b, dens, g, 5e-3, 1.0)

    out_raw, n_raw = run(buf)
    out_cmp, n_cmp = run(particles.compact(buf))
    assert int(n_raw) == int(n_cmp) > 0
    ref = particles.compact(out_raw)
    assert torch.equal(out_cmp.v, ref.v)
    assert torch.equal(out_cmp.alive, ref.alive)


def _cx_pair(seed):
    g = Grid1D(nc=32, dx=1.0)
    ions = _port_buf(2048, 1500, g.length, seed, vth=0.05, holes=7)
    neut = _port_buf(2048, 1500, g.length, seed + 1, vth=0.02, holes=4)
    return g, ions, neut


def test_cx_is_an_exact_velocity_multiset_swap_with_same_cell_partners():
    g, ions, neut = _cx_pair(4)
    nn = C.cell_density(g, neut)
    i2, n2, ns = C.charge_exchange(torch.Generator().manual_seed(9), ions,
                                   neut, nn, g, 0.2, 1.0)
    assert int(ns) > 100
    ai, an = n(ions.alive), n(neut.alive)
    before = np.concatenate([n(ions.v)[ai], n(neut.v)[an]])
    after = np.concatenate([n(i2.v)[ai], n(n2.v)[an]])
    np.testing.assert_array_equal(np.sort(before.ravel()),
                                  np.sort(after.ravel()))
    vi0, vi1, vn0 = n(ions.v), n(i2.v), n(neut.v)
    cells_i = n(C._cells(ions.x, ions.alive, g.dx, g.nc))
    cells_n = n(C._cells(neut.x, neut.alive, g.dx, g.nc))
    swapped = np.nonzero((vi0 != vi1).any(axis=1))[0]
    assert len(swapped) == int(ns)
    for s in swapped[:200]:
        donors = np.nonzero((vn0 == vi1[s]).all(axis=1))[0]
        assert len(donors) >= 1
        assert cells_i[s] in cells_n[donors], s


def test_coulomb_conserves_pair_momentum_and_energy():
    """Per pair, v1 + v2 is kept (recomputing the pairing from the same
    generator state, which draws the shuffle first); rows in no pair are
    untouched; total KE to rtol 1e-5."""
    g = Grid1D(nc=16, dx=1.0)
    sp = _port_buf(4096, 4000, g.length, 12, holes=9)
    nd = C.cell_density(g, sp)
    out, npairs = C.coulomb_intra(torch.Generator().manual_seed(21), sp, nd,
                                  g, 1e-2, 1.0)
    assert int(npairs) > 1000
    ok = C._eligible(sp.x, sp.alive, g.length)
    ia, ib, valid = C.pair_in_cells(torch.Generator().manual_seed(21),
                                    C._cells(sp.x, ok, g.dx, g.nc), ok)
    ia, ib = n(ia[valid]), n(ib[valid])
    v0, v1 = n(sp.v), n(out.v)
    np.testing.assert_allclose(v0[ia] + v0[ib], v1[ia] + v1[ib], atol=2e-6)
    assert (v0[ia] != v1[ia]).any(axis=1).sum() > 200
    unpaired = np.ones(v0.shape[0], bool)
    unpaired[np.concatenate([ia, ib])] = False
    np.testing.assert_array_equal(v0[unpaired], v1[unpaired])
    am = n(sp.alive)
    np.testing.assert_allclose((v1[am].astype(np.float64) ** 2).sum(),
                               (v0[am].astype(np.float64) ** 2).sum(),
                               rtol=1e-5)


def test_coulomb_isotropizes_anisotropic_plasma():
    g = Grid1D(nc=8, dx=1.0)
    buf = _port_buf(4096, 4096, g.length, 30)
    v = buf.v.clone()
    v[:, 1:] *= 0.1
    buf = dataclasses.replace(buf, v=v)
    nd = C.cell_density(g, buf)
    v0 = n(v).astype(np.float64)
    ratio0 = v0[:, 0].var() / (v0[:, 1].var() + v0[:, 2].var())
    gen = torch.Generator().manual_seed(30)
    for _ in range(30):
        buf, _ = C.coulomb_intra(gen, buf, nd, g, 2e-3, 1.0)
    v1 = n(buf.v).astype(np.float64)
    ratio1 = v1[:, 0].var() / (v1[:, 1].var() + v1[:, 2].var())
    assert ratio1 < 0.5 * ratio0, (ratio0, ratio1)
    np.testing.assert_allclose((v1 ** 2).sum(), (v0 ** 2).sum(), rtol=1e-4)


def test_coulomb_kernel_path_matches_ta_kick_ref_path():
    """use_kernel=True (the kernel's plain version on the CPU) draws the
    same events as ta_kick_ref and lands within rounding of it."""
    g = Grid1D(nc=16, dx=1.0)
    sp = _port_buf(1024, 900, g.length, 50)
    nd = C.cell_density(g, sp)
    outs = [C.coulomb_intra(torch.Generator().manual_seed(51), sp, nd, g,
                            5e-3, 1.0, use_kernel=k) for k in (False, True)]
    assert int(outs[0][1]) == int(outs[1][1]) > 0
    np.testing.assert_allclose(n(outs[0][0].v), n(outs[1][0].v), atol=1e-5)


# ------------------------------------------- the Coulomb pairing kernel


def _coulomb_composed(gen, sp, n_cell, grid, rate, dt, draws=None):
    """``coulomb_intra(use_kernel=True)`` as it was composed before the
    pairing kernel: ``pair_in_cells``, the deflection's plain version, a
    ``where`` and two ``index_add`` passes."""
    from repro_torch.kernels import collide as K

    ok = C._eligible(sp.x, sp.alive, grid.length)
    c = C._cells(sp.x, ok, grid.dx, grid.nc)
    ia, ib, valid = C.pair_in_cells(gen, c, ok, draws)
    m = ia.shape[0]
    u = sp.v[ia] - sp.v[ib]
    umag = torch.sqrt(torch.sum(u * u, dim=-1))
    n_at = C._at_cell(n_cell, c[ia]).to(sp.x.dtype)
    var = rate * n_at * dt / torch.clamp(umag * umag * umag, min=1e-12)
    if draws is None:
        nrm = torch.randn(m, generator=gen, dtype=sp.x.dtype)
    else:
        nrm = torch.as_tensor(draws["normal"], dtype=sp.x.dtype)
    delta = torch.sqrt(var) * nrm
    phi = C._draw(draws, "phi", gen, m, sp.x.device, 0.0, 2.0 * np.pi)
    du = torch.where(valid[:, None], K.ta_kick_plain(u, delta, phi), 0.0)
    v = sp.v.index_add(0, ia, 0.5 * du).index_add(0, ib, -0.5 * du)
    return v, valid.sum(dtype=torch.int32)


def _coulomb_case(case):
    """(buffer, grid, rate, draws) of one pairing case."""
    nc = {"even_nc": 16, "odd_nc": 17, "empty_cells": 200, "n1": 4}.get(
        case, 16)
    cap = {"empty_cells": 60, "n1": 1, "odd_nc": 3001}.get(case, 2048)
    g = Grid1D(nc=nc, dx=1.0)
    rng = np.random.default_rng(len(case))
    x = rng.uniform(0, g.length, cap).astype(np.float32)
    if case == "empty_cells":
        x = rng.uniform(0, 20.0, cap).astype(np.float32)   # cells 20+ empty
    v = rng.normal(size=(cap, 3)).astype(np.float32)
    if case == "u_along_z":
        v[:, :2] = 0.25        # every pair's u = (0, 0, +-uz)
    alive = rng.random(cap) < 0.8
    if case == "all_ineligible":
        alive[:] = False
    if case == "n1":
        alive[:] = True
    sp = particles.SpeciesBuffer(t(x), t(v), t(alive.astype(np.float32)),
                                 t(alive))
    rate = 0.0 if case == "delta_zero" else 5e-3
    if case == "rate_tensor":
        rate = torch.tensor(5e-3)
    draws = None
    if case == "draws":
        draws = {"shuffle": rng.random(cap).astype(np.float32),
                 "normal": rng.normal(size=cap).astype(np.float32),
                 "phi": (2 * np.pi * rng.random(cap)).astype(np.float32)}
    return sp, g, rate, draws


@pytest.mark.parametrize("case", [
    "even_nc", "odd_nc", "empty_cells", "all_ineligible", "n1", "u_along_z",
    "delta_zero", "rate_tensor", "draws"])
def test_coulomb_pairs_plain_equals_the_composition_it_replaced(case):
    """The kernel's plain version, through ``coulomb_intra(use_kernel=
    True)`` and called on its own, gives the composed path's velocities and
    pair count bit for bit, and draws the same generator stream."""
    from repro_torch.kernels import collide as K

    sp, g, rate, draws = _coulomb_case(case)
    nd = C.cell_density(g, sp)
    gens = [torch.Generator().manual_seed(9) for _ in range(3)]
    want_v, want_n = _coulomb_composed(gens[0], sp, nd, g, rate, 1.0, draws)
    got, got_n = C.coulomb_intra(gens[1], sp, nd, g, rate, 1.0,
                                 use_kernel=True, draws=draws)
    assert torch.equal(got.v, want_v)
    assert got_n.dtype == torch.int32 and int(got_n) == int(want_n)
    assert torch.equal(gens[0].get_state(), gens[1].get_state())

    ok = C._eligible(sp.x, sp.alive, g.length)
    c = C._cells(sp.x, ok, g.dx, g.nc)
    order = C.cell_shuffled_order(gens[2], c, ok, draws)
    nrm, phi = C._coulomb_draws(gens[2], draws, sp.x.shape[0], torch.float32,
                                sp.x.device)
    v2, n2 = K.coulomb_pairs_plain(order, c, sp.v, nd, nrm, phi, rate, 1.0)
    assert torch.equal(v2, want_v) and int(n2) == int(want_n)
    if case in ("all_ineligible", "n1"):
        assert int(want_n) == 0
    elif case == "delta_zero":
        assert int(want_n) > 0 and torch.equal(want_v, sp.v + 0.0)
    else:
        assert int(want_n) > 0 and not torch.equal(want_v, sp.v)
