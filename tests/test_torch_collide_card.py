"""The collide phase's kernels (``kernels.collide``: the Coulomb pairing
kernel and the cell density kernel) against their plain versions on the
card, and the bin starts of ``charge_exchange`` against ``cell_bins``;
skips without one. This file imports no JAX, so that it runs on a machine
with the card alone:
``PYTHONPATH=src python -m pytest -q tests/test_torch_collide_card.py``.

Pair counts are exact. Velocities compare with ``==``: a row outside a
pair keeps its value, and a -0.0 the kernel copies equals the +0.0 that
the plain version's ``index_add`` makes of it. A paired row may differ by
the order in which the two sides sum the three squares of |u|, so it is
held to 2 ulp of the row's largest component.

The cell density equals its plain version bit for bit wherever each bin
is a sum of equal weights; with random weights the float atomics of both
add in the card's order, so a bin is held to the rounding of a sum of its
count of terms. Bin starts (``collisions._cell_starts``) are integers:
exact.
"""

import pytest
import torch

from repro_torch.core import collisions as C
from repro_torch.core import particles
from repro_torch.core.grid import Grid1D
from repro_torch.kernels import collide as K
from repro_torch.kernels import ops

ROWS, CELLS = 1 << 20, 1000
RATE, DT = 1e-3, 0.2          # the §3.3 menu's Coulomb rate and dt


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py phase 2 holds the "
                    "kernel to its plain version at the §3.3 rows")
    return torch.device("cuda")


def _inputs(dev, seed):
    """(order, cell, v, n_cell, nrm, phi) of a buffer of ROWS slots, a fifth
    of them dead, over CELLS cells of the §3.3 spacing."""
    g = Grid1D(nc=CELLS, dx=1.0)
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.rand(ROWS, generator=gen, device=dev) * g.length
    v = torch.randn(ROWS, 3, generator=gen, device=dev)
    alive = torch.rand(ROWS, generator=gen, device=dev) < 0.8
    sp = particles.SpeciesBuffer(x=x, v=v, w=alive.float(), alive=alive)
    ok = C._eligible(x, alive, g.length)
    cell = C._cells(x, ok, g.dx, g.nc)
    order = C.cell_shuffled_order(gen, cell, ok)
    nrm, phi = C._coulomb_draws(gen, None, ROWS, torch.float32, dev)
    return order, cell, v, C.cell_density(g, sp), nrm, phi


def _ulps(a):
    """One float32 ulp at |a|."""
    a = a.abs()
    return torch.nextafter(a, torch.full_like(a, float("inf"))) - a


@pytest.mark.card
@pytest.mark.parametrize("scalars", ["float", "tensor"])
def test_coulomb_pairs_kernel_matches_plain(card, scalars):
    order, cell, v, n_cell, nrm, phi = _inputs(card, 3)
    want_v, want_n = K.coulomb_pairs_plain(order, cell, v, n_cell, nrm, phi,
                                           RATE, DT)
    rate, dt = RATE, DT
    if scalars == "tensor":
        rate, dt = (torch.tensor(s, device=card) for s in (RATE, DT))
    before = K.coulomb_pairs.launches
    got_v, got_n = K.coulomb_pairs(order, cell, v, n_cell, nrm, phi, rate,
                                   dt)
    assert K.coulomb_pairs.launches == before + 1
    assert got_n.dtype == torch.int32 and int(got_n) == int(want_n) > 0

    ia, ib, valid, _, _ = K.coulomb_pair_rows(order, cell, v, n_cell, nrm,
                                              RATE, DT)
    paired = torch.zeros(ROWS, dtype=torch.bool, device=card)
    paired[ia[valid]] = True
    paired[ib[valid]] = True
    assert int(paired.sum()) == 2 * int(want_n)
    assert bool((got_v[~paired] == v[~paired]).all())
    assert bool((want_v[~paired] == v[~paired]).all())
    gap = (got_v[paired] - want_v[paired]).abs()
    ulp = _ulps(want_v[paired].abs().amax(1, keepdim=True))
    assert bool((gap <= 2 * ulp).all()), float((gap / ulp).max())
    assert not torch.equal(got_v[paired], v[paired])


# ------------------------------------------------------------- cell binning

NC = 1000


def _density_rows(dev, case):
    """(x, alive, w) of one ``cell_density`` case over NC cells of dx 1."""
    gen = torch.Generator(device=dev).manual_seed(len(case))
    n = {"n0": 0}.get(case, ROWS)
    x = torch.rand(n, generator=gen, device=dev) * (NC + 2.0) - 1.0
    alive = torch.rand(n, generator=gen, device=dev) < 0.6
    if case == "edges":
        # cell edges, the walls and just inside and outside them
        edges = torch.arange(NC + 1, dtype=torch.float32, device=dev)
        x[:NC + 1] = edges
        x[NC + 1:NC + 5] = torch.tensor(
            [-0.0, -1e-7, float(NC), float(NC) - 1e-4], device=dev)
        alive[:NC + 5] = True
    if case == "all_dead":
        alive[:] = False
    w = {"w0.37": 0.37}.get(case, 1.0) * torch.ones(n, device=dev)
    if case == "random_w":
        w = torch.rand(n, generator=gen, device=dev)
    return x, alive, w


@pytest.mark.card
@pytest.mark.parametrize("case", ["w1", "w0.37", "edges", "all_dead", "n0",
                                  "random_w"])
def test_cell_density_kernel_matches_plain(card, case):
    x, alive, w = _density_rows(card, case)
    kw = dict(dx=1.0, nc=NC, length=float(NC))
    want = K.cell_density_plain(x, alive, w, **kw)
    before = K.cell_density.launches
    got = K.cell_density(x, alive, w, **kw)
    assert K.cell_density.launches == before + (x.shape[0] > 0)
    assert got.dtype == torch.float32 and got.shape == (NC,)
    if case != "random_w":
        assert torch.equal(got, want)
        if case in ("all_dead", "n0"):
            assert not bool(got.any())
        else:
            assert float(got.sum()) > 0
        return
    # each of the two sums of k positive terms lies within (k - 1) u of
    # their exact sum, u = 2^-24
    ok = alive & (x >= 0) & (x < NC)
    cell = torch.floor(x).to(torch.int64).clamp(0, NC - 1)
    count = torch.bincount(cell[ok], minlength=NC).float()
    tol = 2 * count * 2.0 ** -24 * want
    assert bool(((got - want).abs() <= tol).all())


@pytest.mark.card
@pytest.mark.parametrize("case", ["random", "empty_cells", "all_sentinel",
                                  "single_cell", "n1", "n0"])
def test_cell_starts_match_cell_bins(card, case):
    gen = torch.Generator(device=card).manual_seed(len(case))
    nc = {"single_cell": 1, "n1": 7}.get(case, NC)
    n = {"n0": 0, "n1": 1}.get(case, ROWS)
    keys = torch.randint(0, nc + 1, (n,), generator=gen, device=card)
    if case == "empty_cells":       # cells 0-9, 20 and up hold no row
        keys = torch.where(torch.rand(n, generator=gen, device=card) < 0.8,
                           keys % 10 + 10, nc)
    if case == "all_sentinel":
        keys[:] = nc
    keys = torch.sort(keys.to(torch.int32)).values
    counts, starts = particles.cell_bins(keys, nc)
    got = C._cell_starts(keys, nc)
    assert got.dtype == torch.int32 and torch.equal(got, starts)
    assert torch.equal(torch.diff(got, append=got.new_full((1,), n)), counts)
    assert torch.equal(got.cpu(), C._cell_starts(keys.cpu(), nc))


@pytest.mark.card
def test_cell_binning_makes_no_host_sync(card):
    x, alive, w = _density_rows(card, "w1")
    keys = torch.sort(C._cells(x, alive, 1.0, NC)).values
    kw = dict(dx=1.0, nc=NC, length=float(NC))
    ops.cell_density(x, alive, w, **kw)       # built before the check
    C._cell_starts(keys, NC)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        dens = ops.cell_density(x, alive, w, **kw)
        starts = C._cell_starts(keys, NC)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(dens, K.cell_density_plain(x, alive, w, **kw))
    assert torch.equal(starts, particles.cell_bins(keys, NC)[1])
