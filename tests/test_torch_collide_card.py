"""The Coulomb pairing kernel (``kernels.collide.coulomb_pairs``) against
its plain version on the card; skips without one. This file imports no
JAX, so that it runs on a machine with the card alone:
``PYTHONPATH=src python -m pytest -q tests/test_torch_collide_card.py``.

Pair counts are exact. Velocities compare with ``==``: a row outside a
pair keeps its value, and a -0.0 the kernel copies equals the +0.0 that
the plain version's ``index_add`` makes of it. A paired row may differ by
the order in which the two sides sum the three squares of |u|, so it is
held to 2 ulp of the row's largest component.
"""

import pytest
import torch

from repro_torch.core import collisions as C
from repro_torch.core import particles
from repro_torch.core.grid import Grid1D
from repro_torch.kernels import collide as K

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
