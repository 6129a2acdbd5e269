"""The port's halo field phase (``repro_torch.distributed.halo``): over
D = 4 partial slabs it equals the port's single-domain smooth -> Poisson ->
E on the assembled density (the contract of the reference's
``check_halo_field_matches_global``, same band), at D = 1 it equals the
single-domain field phase bitwise, and the copies between domains move
only edge nodes and D-scalar vectors.
"""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_parity import n
from repro_torch.configs.pic_bit1 import make_bench_config
from repro_torch.core import fields, pic
from repro_torch.distributed import halo


def _slabs(d, ncl, seed=0):
    """Global rho and per-domain slabs whose shared nodes hold partial
    deposits (0.3 on the right copy, 0.7 on the left one)."""
    rng = np.random.RandomState(seed)
    rho_g = rng.uniform(-1.0, 1.0, d * ncl + 1).astype(np.float32)
    locs = np.zeros((d, ncl + 1), np.float32)
    for r in range(d):
        sl = rho_g[r * ncl: r * ncl + ncl + 1].copy()
        if r > 0:
            sl[0] *= 0.3
        if r < d - 1:
            sl[-1] *= 0.7
        locs[r] = sl
    return rho_g, locs


@pytest.mark.parametrize("passes", [1, 2])
def test_halo_field_matches_global(passes):
    d, ncl, dx = 4, 32, 1.0
    rho_g, locs = _slabs(d, ncl)
    e_loc = n(halo.field_phase(torch.from_numpy(locs), dx=dx, eps0=1.0,
                               smoothing_passes=passes))
    cfg = dataclasses.replace(make_bench_config(nc=d * ncl, n=16),
                              dx=dx, smoothing_passes=passes)
    e_ref = n(pic.field_from_rho(cfg, torch.from_numpy(rho_g)))
    atol = 1e-4 * float(np.max(np.abs(e_ref)) + 1.0)
    for r in range(d):
        np.testing.assert_allclose(e_loc[r], e_ref[r * ncl: r * ncl + ncl + 1],
                                   rtol=1e-4, atol=atol)
    # the shared nodes carry one value on both sides
    np.testing.assert_array_equal(e_loc[:-1, -1], e_loc[1:, 0])


def test_single_domain_is_bitwise_the_global_field():
    cfg = make_bench_config(nc=256, n=16)
    rho = torch.from_numpy(np.random.RandomState(1).normal(
        0.0, 1.0, 257).astype(np.float32))
    want = pic.field_from_rho(cfg, rho)
    got = halo.field_phase(rho[None], dx=cfg.dx, eps0=cfg.eps0,
                           smoothing_passes=cfg.smoothing_passes)
    assert torch.equal(got[0], want)
    phi = fields.solve_poisson(fields.smooth_binomial(rho, 1).double(),
                               cfg.dx, cfg.eps0)
    assert torch.equal(halo.solve_poisson_halo(
        halo.smooth_halo(rho[None], 1).double(), cfg.dx, cfg.eps0)[0], phi)


@pytest.mark.parametrize("d,passes", [(4, 1), (4, 3), (2, 2)])
def test_only_edge_nodes_and_scalars_move(d, passes):
    ncl = 64
    _, locs = _slabs(d, ncl, 2)
    halo.ppermute.moved = 0
    halo.field_phase(torch.from_numpy(locs), dx=0.5, eps0=1.0,
                     smoothing_passes=passes)
    # halo sum 2, a smoothing pass 2, E 2 edge nodes a domain; the solve
    # gathers 3 scalars a domain (two block totals and f_0)
    assert halo.ppermute.moved == d * (2 + 2 * passes + 3 + 2)
    assert halo.ppermute.moved < locs.size


def test_ppermute_wraps_the_ring():
    a = torch.arange(12).reshape(4, 3)
    halo.ppermute.moved = 0
    np.testing.assert_array_equal(n(halo.ppermute(a, +1))[1], n(a)[0])
    np.testing.assert_array_equal(n(halo.ppermute(a, -1))[3], n(a)[0])
    assert halo.ppermute.moved == 24
