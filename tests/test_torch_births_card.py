"""The births kernel (``kernels.births.place_births``) against its plain
version on the card, at the §3.3 sizes (16,777,216 slots a buffer,
10,485,760 of them alive); skips without one. This file imports no JAX,
so that it runs on a machine with the card alone:
``PYTHONPATH=src python -m pytest -q tests/test_torch_births_card.py``.

Rows are copied, never computed, so everything compares bit for bit: each
field of each target, the kill buffer, ``ok`` and both counters.
"""

import pytest
import torch

from repro_torch.core import collisions, particles
from repro_torch.core.grid import Grid1D
from repro_torch.kernels import births as K
from repro_torch.kernels import ops

CAP, ALIVE = 16_777_216, 10_485_760
NC = 102_400


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py phase 2 holds the "
                    "kernel to its plain version at the §3.3 rows")
    return torch.device("cuda")


def _alive(gen, dev, free=None):
    """ALIVE live slots scattered over CAP, or all but ``free`` slots: the
    given indices, or that many scattered ones."""
    alive = torch.zeros(CAP, dtype=torch.bool, device=dev)
    if free is None:
        alive[torch.randperm(CAP, generator=gen, device=dev)[:ALIVE]] = True
        return alive
    alive[:] = True
    if isinstance(free, int):
        free = torch.randperm(CAP, generator=gen, device=dev)[:free]
    alive[free] = False
    return alive


def _rows(gen, dev, alive):
    """(x, v, w, alive) of a buffer: dead slots hold w = 0."""
    return (torch.rand(CAP, generator=gen, device=dev) * NC,
            torch.randn(CAP, 3, generator=gen, device=dev),
            torch.where(alive, torch.rand(CAP, generator=gen, device=dev)
                        + 0.5, 0.0), alive)


def _mask(gen, dev, hits):
    """About ``hits`` masked candidates of CAP, or the given rows."""
    if isinstance(hits, int):
        return torch.rand(CAP, generator=gen, device=dev) < hits / CAP
    mask = torch.zeros(CAP, dtype=torch.bool, device=dev)
    mask[hits] = True
    return mask


def _case(name, dev):
    """(mask, targets' alive, kill?) of one case."""
    gen = torch.Generator(device=dev).manual_seed(len(name))
    last = torch.tensor([CAP - 1], device=dev)
    if name == "no_hit":
        return _mask(gen, dev, 0), [_alive(gen, dev)], False
    if name == "sparse":
        return _mask(gen, dev, 1024), [_alive(gen, dev)], False
    if name == "overflow":
        return _mask(gen, dev, 1024), [_alive(gen, dev, free=300)], False
    if name == "full":
        return (_mask(gen, dev, 1024),
                [_alive(gen, dev), _alive(gen, dev, free=last[:0])], True)
    if name == "last":
        return _mask(gen, dev, last), [_alive(gen, dev, free=last)], False
    assert name == "pair"                     # ionize: two targets, a kill
    return (_mask(gen, dev, 1024), [_alive(gen, dev), _alive(gen, dev)],
            True)


def _land(fn, mask, dests, srcs, kill):
    """``fn`` on copies of the targets and the kill buffer; a source w is
    the kill buffer's w where there is one, as in ionize."""
    dests = [tuple(a.clone() for a in d) for d in dests]
    kill = None if kill is None else tuple(a.clone() for a in kill)
    srcs = [(x, v, w if kill is None else kill[1]) for x, v, w in srcs]
    return fn(mask, dests, srcs, kill), dests, kill


@pytest.mark.card
@pytest.mark.parametrize("case", ["no_hit", "sparse", "overflow", "full",
                                  "last", "pair"])
def test_place_births_kernel_matches_plain(card, case):
    mask, alive, with_kill = _case(case, card)
    gen = torch.Generator(device=card).manual_seed(7)
    dests = [_rows(gen, card, a) for a in alive]
    src = _rows(gen, card, torch.ones(CAP, dtype=torch.bool, device=card))
    srcs = [(src[0], torch.randn(CAP, 3, generator=gen, device=card),
             src[2]) for _ in dests]
    kill = (torch.ones(CAP, dtype=torch.bool, device=card),
            src[2].clone()) if with_kill else None
    before = K.place_births.launches
    got, got_d, got_k = _land(K.place_births, mask, dests, srcs, kill)
    assert K.place_births.launches == before + 1
    want, want_d, want_k = _land(K.place_births_plain, mask, dests, srcs,
                                 kill)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    for gd, wd in zip(got_d, want_d):
        for g, w in zip(gd, wd):
            assert torch.equal(g, w)
    if kill is not None:
        assert all(torch.equal(g, w) for g, w in zip(got_k, want_k))
    hits, landed = int(mask.sum()), int(got[1])
    free = min(int((~a).sum()) for a in alive)
    assert landed == min(hits, free) and int(got[2]) == hits - landed
    if case in ("sparse", "pair", "last"):
        assert landed == hits > 0
    if case in ("overflow", "full"):
        assert int(got[2]) > 0


@pytest.mark.card
def test_births_make_no_host_sync(card):
    """The births of an ionization step (the kernel and ``ionize`` with
    ``donate``) and of wall emission (``inject_masked``) read nothing on
    the host."""
    gen = torch.Generator(device=card).manual_seed(11)
    bufs = [particles.SpeciesBuffer(*_rows(gen, card, _alive(gen, card)))
            for _ in range(3)]
    grid = Grid1D(nc=NC, dx=1.0)
    params = collisions.IonizationParams(rate=1e-4, vth_electron=1.0)
    ne = torch.full((NC + 1,), 102.4, device=card)
    mask = _mask(gen, card, 1024)
    x, v, w, _ = _rows(gen, card, mask)
    collisions.ionize(gen, *(particles.copy_species(b) for b in bufs), grid,
                      params, 0.2, ne=ne, donate=True)   # built before
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = collisions.ionize(gen, *bufs, grid, params, 0.2, ne=ne,
                                donate=True)
        emitted = particles.inject_masked(bufs[0], x, v, w, mask)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert int(out[3]["n_ionized"]) > 0
    assert int(out[3]["n_ionized"]) == int(out[4].ok.sum())
    assert int(emitted[2].sum()) == int(mask.sum())
