"""Halo-exchange field phase and the copies between domains (the port of
``repro.distributed.halo``).

The engine runs its D domains in one process on one device: every node
array of the field phase is one (D, ncl + 1) tensor, row r the slab of
domain r, and the reference's collectives become copies between rows:

* ``ppermute`` (the reference's ``ppermute_tree``) moves row r to row
  r + shift, with the ring wrap the reference's permutation has;
* ``gather_scalars`` hands every domain the (D,) vector of one scalar per
  domain.

Both go through ``_move``, which counts the elements it moves in
``ppermute.moved``: a field phase moves edge nodes and D-scalar vectors
only, never a full (D, ncl + 1) slab (the reference's "no full-rho
all_gather" pin reads that count). Shared edge nodes and one-sided wall
stencils work as in the reference: the global system is Dirichlet whatever
the particle boundary, so the values arriving across the global walls are
replaced (``is_first`` / ``is_last`` are the first and last rows).

The port's single-domain ``pic.field_from_rho`` solves Poisson and E in
float64; ``field_phase`` does the same, so that at D = 1 it equals the
single-domain field bitwise.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.profiler import record_function

from repro_torch.core.fields import reciprocal


def _move(a: torch.Tensor, shift: int) -> torch.Tensor:
    """Every copy between domains: row r of ``a`` (D, ...) lands in row
    (r + shift) mod D; shift 0 hands the rows over as they are (a gather
    of per-domain values that every domain reads). Counts the elements in
    ``ppermute.moved``."""
    ppermute.moved += a.numel()
    return torch.roll(a, shift, 0) if shift else a


def ppermute(a: torch.Tensor, shift: int) -> torch.Tensor:
    """Row r of ``a`` (D, ...) to row (r + shift) mod D: the reference's
    ring ``ppermute`` over the domain axis."""
    with record_function("halo/ppermute"):
        return _move(a, shift)


ppermute.moved = 0


def send(dst, index, src) -> None:
    """Copy every tensor field of ``src`` into ``dst[index]``, a row of
    another domain's receive buffer, on the current stream: one queue's
    migration pack to a neighbour. Counts in ``ppermute.moved``."""
    with record_function("halo/ppermute"):
        for f in dataclasses.fields(src):
            a = getattr(src, f.name)
            ppermute.moved += a.numel()
            getattr(dst, f.name)[index].copy_(a)


def ppermute_tree(tree, shift: int):
    """``ppermute`` of every tensor field of a dataclass."""
    return dataclasses.replace(tree, **{
        f.name: ppermute(getattr(tree, f.name), shift)
        for f in dataclasses.fields(tree)})


def _walls(d: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    r = torch.arange(d, device=device)
    return r == 0, r == d - 1


def neighbor_vals(send_left: torch.Tensor, send_right: torch.Tensor,
                  fill=0.0) -> tuple[torch.Tensor, torch.Tensor]:
    """One halo round over (D,) values: returns (from_left, from_right).
    Each domain receives its left neighbour's ``send_right`` as
    ``from_left`` and its right neighbour's ``send_left`` as
    ``from_right``; across the global walls ``fill`` arrives instead."""
    first, last = _walls(send_left.shape[0], send_left.device)
    from_left = torch.where(first, fill, ppermute(send_right, +1))
    from_right = torch.where(last, fill, ppermute(send_left, -1))
    return from_left, from_right


def gather_scalars(x: torch.Tensor) -> torch.Tensor:
    """The (D,) vector of one scalar per domain, which every domain reads:
    the only gather of the field phase, D elements."""
    return _move(x, 0)


def halo_sum(rho: torch.Tensor) -> torch.Tensor:
    """Complete the shared edge nodes of per-domain deposits (D, ngl):
    domain r's node ncl and domain r+1's node 0 are one global node, and
    after the exchange both copies carry the full sum."""
    with record_function("halo/sum"):
        from_left, from_right = neighbor_vals(rho[:, 0], rho[:, -1])
        out = rho.clone()
        out[:, 0] = rho[:, 0] + from_left
        out[:, -1] = out[:, -1] + from_right
        return out


def smooth_halo(f: torch.Tensor, passes: int) -> torch.Tensor:
    """The (1/4, 1/2, 1/4) binomial smoother over (D, ngl) slabs, one halo
    node a side a pass; the (3/4, 1/4) one-sided stencil at the global
    walls. Equals ``fields.smooth_binomial`` on the assembled array."""
    with record_function("halo/smooth"):
        for _ in range(passes):
            hl, hr = neighbor_vals(f[:, 1], f[:, -2])
            ext = torch.cat([hl[:, None], f, hr[:, None]], 1)
            out = 0.25 * ext[:, :-2] + 0.5 * ext[:, 1:-1] + 0.25 * ext[:, 2:]
            out[0, 0] = 0.75 * f[0, 0] + 0.25 * f[0, 1]
            out[-1, -1] = 0.25 * f[-1, -2] + 0.75 * f[-1, -1]
            f = out
    return f


def _exclusive_prefix(t: torch.Tensor) -> torch.Tensor:
    """(D,) -> the sum of the earlier domains' entries, 0 for domain 0."""
    return torch.cat([t.new_zeros(1), torch.cumsum(t, 0)[:-1]])


def solve_poisson_halo(rho: torch.Tensor, dx: float, eps0: float,
                       phi_left: float = 0.0,
                       phi_right: float = 0.0) -> torch.Tensor:
    """Distributed exact solve of -phi'' = rho/eps0 (Dirichlet walls) over
    (D, ngl) slabs, in rho's dtype. Each of the two prefix sums of
    ``fields.solve_poisson`` becomes a cumsum over the owned slab plus the
    carry of the earlier domains' block totals (D scalars a pass). At
    D = 1 the carries are exact zeros and the result is the single-domain
    solve's, bitwise."""
    with record_function("halo/poisson"):
        d, ngl = rho.shape
        ncl = ngl - 1
        f = rho * (dx * dx) / eps0
        c1 = torch.cumsum(f, 1)
        off1 = _exclusive_prefix(gather_scalars(c1[:, ncl - 1]))
        s1 = off1[:, None] + c1
        f0 = gather_scalars(f[:, 0])[0]     # the global f_0, domain 0's
        inner = s1 - f0
        c2 = torch.cumsum(inner, 1)
        t2s = gather_scalars(c2[:, ncl - 1])
        off2 = _exclusive_prefix(t2s)
        s2 = off2[:, None] + c2
        s2m1 = torch.cat([off2[:, None], s2[:, :-1]], 1)
        n = d * ncl
        g0 = (phi_right - phi_left + t2s.sum()) / n
        i_glob = (torch.arange(d, device=rho.device)[:, None] * ncl
                  + torch.arange(ngl, device=rho.device)).to(rho.dtype)
        phi = phi_left + i_glob * g0 - s2m1
        phi[0, 0] = phi_left
        phi[-1, -1] = phi_right
        return phi


def efield_halo(phi: torch.Tensor, dx: float) -> torch.Tensor:
    """E = -dphi/dx over (D, ngl) slabs: centred with one phi halo node a
    side, one-sided at the global walls (``fields.efield``'s arithmetic)."""
    with record_function("halo/efield"):
        hl, hr = neighbor_vals(phi[:, 1], phi[:, -2])
        ext = torch.cat([hl[:, None], phi, hr[:, None]], 1)
        e = -(ext[:, 2:] - ext[:, :-2]) * reciprocal(2.0 * dx, phi.dtype)
        e[0, 0] = -(phi[0, 1] - phi[0, 0]) * reciprocal(dx, phi.dtype)
        e[-1, -1] = -(phi[-1, -1] - phi[-1, -2]) * reciprocal(dx, phi.dtype)
        return e


def field_phase(rho_local: torch.Tensor, *, dx: float, eps0: float,
                smoothing_passes: int) -> torch.Tensor:
    """Per-domain deposits (D, ngl) -> halo sum -> smooth -> Poisson -> E
    (D, ngl), in rho's dtype; Poisson and E in float64, as the port's
    single-domain field phase."""
    rho = halo_sum(rho_local)
    rho = smooth_halo(rho, smoothing_passes)
    phi = solve_poisson_halo(rho.double(), dx, eps0)
    return efield_halo(phi, dx).to(rho_local.dtype)
