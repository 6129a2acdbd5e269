"""The Takizuka-Abe deflection, Coulomb pairing and cell density kernels
(``csrc/collide.cu``), each with its plain PyTorch version.

``ta_kick`` replaces the TPU kernel
``src/repro/kernels/collide.py::_ta_kernel`` (launched by
``ta_kick_pallas``): from each pair's relative velocity u (M, 3),
delta = tan(theta/2) (M,) and azimuth phi (M,), the deflection du = u' - u
(M, 3) with |u + du| = |u|; u along z takes the degenerate-frame branch,
and delta = 0 gives du = 0 exactly. Bound on the H100: bytes, 32 B a row
(u 12, delta 4, phi 4, du 12): at the §3.3 electron capacity of 16,777,216
rows, 0.160 ms at 3.35 TB/s. One thread per row on the (M, 3) layout; the
TPU's (rows, 128) planes are not built. It stands alone: the main path
deflects inside ``coulomb_pairs``.

``coulomb_pairs`` is ``collisions.coulomb_intra(use_kernel=True)`` after the
cell-shuffled order (``PICConfig.collide_kernel``): it replaces the scan of
the reference's ``pair_in_cells`` (the segment starts, a ``cummax`` over
all rows, which PyTorch runs in one block) folded together with
``_ta_kernel``'s deflection, and the gathers, the ``where`` and the two
``index_add`` passes between them. Bound on the H100: bytes, 44 B a row
(order 8, cell 4, v 12, nrm 4, phi 4 read; v 12 written): 0.22 ms at
16,777,216 rows and 3.35 TB/s; the rows of v are gathered and written in
shuffled order, so each touches its own 32-byte sectors. Design: two
passes of one thread a sorted position t. The first gathers the cell key
cs[t], writes first[c] = t where a cell's segment starts (each entry by
the one position that starts it, so no scan and no atomics) and copies
the ineligible rows by slot, in order. The second makes t a head where
``pair_in_cells``' ``valid`` is (even offset t - first[cs[t]], successor
in the same cell, cell != nc); a head reads both rows, deflects them
through ``_ta_kernel``'s body and writes both rows, a partner (odd
offset) writes nothing, and the last row of an odd segment is copied: the
pairs are disjoint, so each output row is written once and no (n, 3)
intermediate exists. Pairs are counted by a block count and one
integer atomic a block. ``rate`` and ``dt`` are Python numbers or 0-d
float32 tensors on the card (``RuntimeParams``), read by the kernel, never
by the host.

The plain versions repeat the kernels' arithmetic operation by operation
(``ta_kick_plain`` multiplies by 1/(1+delta^2) where
``collisions.ta_kick_ref`` divides; the two are distinct on purpose, as the
reference keeps its kernel and its ``ta_kick_ref`` apart).
``coulomb_pairs_plain`` is the composition the kernel replaced; against it
the kernel differs only where a row outside a pair holds -0.0, which
``index_add`` turns into +0.0 and the kernel copies, and in the order of
``torch.sum`` over the three squares of |u| (see ``csrc/collide.cu``).

``cell_density`` bins the collision menu's rows by cell. It replaces no
TPU kernel: its origin is the reference's ``.at[c].add`` histogram in
``cell_density``, which the port ran as an ``index_add_`` that sends every
row it does not count to one sentinel bin nc, where the atomics serialise
on one address (~6.3 M dead slots a species at §3.3). The kernel is
``eligible``, ``cell_keys``, the ``where`` and the histogram in one pass:
a row that is dead or outside [0, length) returns before any atomic, and
an eligible row adds its weight into its cell of a zeroed (nc,) table that
sits in L2. ``eligible`` and ``cell_keys`` hold the rule that the
collision menu keys its rows by (``collisions._eligible``, ``_cells``);
the kernel restates it, and its card tests hold it to the plain version,
which calls them. Bound on the H100: bytes, ``alive`` 1 B a row and x, w
8 B an eligible row (a dead row's x and w need not be read): 0.030 ms at
the §3.3 electrons' 16,777,216 slots, 10,485,760 of them alive, at
3.35 TB/s. With equal weights (the menu's are 1: integer sums, exact below
2^24) each add takes a bin through the same sequence of values in any
order, so the kernel gives the plain version's bits; with unequal weights
the order of the float atomics is the card's, as in the ``index_add_`` it
replaces.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.mover import inv_dx

_P = ctypes.c_void_p
_F = ctypes.c_float
_ARGTYPES = [_P, _P, _P, _P, ctypes.c_longlong, _P]
_PAIR_ARGTYPES = [_P, _P, _P, _P, _P, _P, _P, _F, _P, _F, _P, _P, _P, _P,
                  ctypes.c_longlong, ctypes.c_int, _P]
_DENSITY_ARGTYPES = [_P, _P, _P, _P, _F, _F, ctypes.c_longlong, ctypes.c_int,
                     _P]


def eligible(x: torch.Tensor, alive: torch.Tensor,
             length: float) -> torch.Tensor:
    """Rows that may collide: alive and inside [0, length)."""
    return alive & (x >= 0.0) & (x < length)


def cell_keys(x: torch.Tensor, ok: torch.Tensor, dx: float,
              nc: int) -> torch.Tensor:
    """Cell key per row (int32), floor(x * inv_dx(dx)) clamped to
    [0, nc - 1]; rows not ``ok`` parked at ``nc``."""
    c = torch.floor(x * inv_dx(dx)).to(torch.int32).clamp(0, nc - 1)
    return torch.where(ok, c, nc)


def ta_kick_plain(u: torch.Tensor, delta: torch.Tensor,
                  phi: torch.Tensor) -> torch.Tensor:
    """Plain version: the kernel's arithmetic on u (M, 3), delta, phi (M,)."""
    ux, uy, uz = u[:, 0], u[:, 1], u[:, 2]
    d2 = delta * delta
    inv = 1.0 / (1.0 + d2)
    cos_t = (1.0 - d2) * inv
    sin_t = 2.0 * delta * inv
    one_m = 1.0 - cos_t
    uperp2 = ux * ux + uy * uy
    uperp = torch.sqrt(uperp2)
    umag = torch.sqrt(uperp2 + uz * uz)
    cphi, sphi = torch.cos(phi), torch.sin(phi)
    safe = uperp > 1e-12 * torch.clamp(umag, min=1.0)
    up = torch.where(safe, uperp, 1.0)
    dux = (ux / up) * uz * sin_t * cphi - (uy / up) * umag * sin_t * sphi \
        - ux * one_m
    duy = (uy / up) * uz * sin_t * cphi + (ux / up) * umag * sin_t * sphi \
        - uy * one_m
    duz = -up * sin_t * cphi - uz * one_m
    dux0 = uz * sin_t * cphi
    duy0 = uz * sin_t * sphi
    duz0 = -uz * one_m
    return torch.stack([torch.where(safe, dux, dux0),
                        torch.where(safe, duy, duy0),
                        torch.where(safe, duz, duz0)], dim=-1)


def ta_kick(u: torch.Tensor, delta: torch.Tensor,
            phi: torch.Tensor) -> torch.Tensor:
    """CUDA kernel: same arguments and result as ``ta_kick_plain``."""
    _build.require_cuda(u, "ta_kick")
    m = u.shape[0]
    _build.require(u, "u", torch.float32, (m, 3), u.device)
    _build.require(delta, "delta", torch.float32, (m,), u.device)
    _build.require(phi, "phi", torch.float32, (m,), u.device)
    du = torch.empty_like(u)
    if m == 0:
        return du
    fn = _build.function("collide", "ta_kick", _ARGTYPES)
    err = fn(u.data_ptr(), delta.data_ptr(), phi.data_ptr(), du.data_ptr(),
             m, _build.stream_of(u))
    ta_kick.launches += 1
    _build.check_launch(err, "ta_kick")
    return du


ta_kick.launches = 0


def coulomb_pair_rows(order: torch.Tensor, cell: torch.Tensor,
                      v: torch.Tensor, n_cell: torch.Tensor,
                      nrm: torch.Tensor, rate, dt):
    """``pair_in_cells``' head rule on a given cell-shuffled ``order`` and
    each position's deflection input: (ia, ib, valid, u, delta), each
    indexed by sorted position. ``cell`` (n,) int32 parks ineligible rows at
    nc = ``n_cell.shape[0]``."""
    n, nc = order.shape[0], n_cell.shape[0]
    ok = cell != nc
    cs = cell[order]
    idx = torch.arange(n, device=cell.device)
    boundary = torch.ones(n, dtype=torch.bool, device=cell.device)
    boundary[1:] = cs[1:] != cs[:-1]
    seg_start = torch.cummax(torch.where(boundary, idx, 0), 0).values
    local = idx - seg_start
    succ = torch.clamp(idx + 1, max=n - 1)
    ia, ib = order, order[succ]
    valid = ((local % 2 == 0) & (idx + 1 < n) & (cs[succ] == cs)
             & ok[ia] & ok[ib])
    u = v[ia] - v[ib]
    umag = torch.sqrt(torch.sum(u * u, dim=-1))
    n_at = torch.cat([n_cell, n_cell.new_zeros(1)])[cs.long()].to(v.dtype)
    var = rate * n_at * dt / torch.clamp(umag * umag * umag, min=1e-12)
    return ia, ib, valid, u, torch.sqrt(var) * nrm


def coulomb_pairs_plain(order: torch.Tensor, cell: torch.Tensor,
                        v: torch.Tensor, n_cell: torch.Tensor,
                        nrm: torch.Tensor, phi: torch.Tensor, rate, dt
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version: the within-cell pairs of ``order`` deflected through
    ``ta_kick_plain`` with the draws ``nrm`` and ``phi`` (n,), read at each
    head's sorted position. Returns (new v (n, 3), pair count () int32)."""
    ia, ib, valid, u, delta = coulomb_pair_rows(order, cell, v, n_cell, nrm,
                                                rate, dt)
    du = torch.where(valid[:, None], ta_kick_plain(u, delta, phi), 0.0)
    out = v.index_add(0, ia, 0.5 * du).index_add(0, ib, -0.5 * du)
    return out, valid.sum(dtype=torch.int32)


def _scalar(a, name: str, device: torch.device):
    """(pointer, value) of a kernel scalar: a 0-d float32 tensor on the
    card is passed by pointer, a Python number by value."""
    if isinstance(a, torch.Tensor):
        _build.require(a, name, torch.float32, (), device)
        return a.data_ptr(), 0.0
    return None, float(a)


def coulomb_pairs(order: torch.Tensor, cell: torch.Tensor, v: torch.Tensor,
                  n_cell: torch.Tensor, nrm: torch.Tensor, phi: torch.Tensor,
                  rate, dt) -> tuple[torch.Tensor, torch.Tensor]:
    """CUDA kernel: same arguments and result as ``coulomb_pairs_plain``.
    ``order`` must be a permutation of the rows (every row is written
    through it)."""
    _build.require_cuda(v, "coulomb_pairs")
    n, nc, dev = v.shape[0], n_cell.shape[0], v.device
    _build.require(order, "order", torch.int64, (n,), dev)
    _build.require(cell, "cell", torch.int32, (n,), dev)
    _build.require(v, "v", torch.float32, (n, 3), dev)
    _build.require(n_cell, "n_cell", torch.float32, (nc,), dev)
    _build.require(nrm, "nrm", torch.float32, (n,), dev)
    _build.require(phi, "phi", torch.float32, (n,), dev)
    rate_p, rate_v = _scalar(rate, "rate", dev)
    dt_p, dt_v = _scalar(dt, "dt", dev)
    out = torch.empty_like(v)
    if n == 0:
        return out, torch.zeros((), dtype=torch.int32, device=dev)
    count = torch.empty((), dtype=torch.int32, device=dev)
    cs = torch.empty(n, dtype=torch.int32, device=dev)
    first = torch.empty(nc, dtype=torch.int64, device=dev)
    fn = _build.function("collide", "coulomb_pairs", _PAIR_ARGTYPES)
    err = fn(order.data_ptr(), cell.data_ptr(), v.data_ptr(),
             n_cell.data_ptr(), nrm.data_ptr(), phi.data_ptr(), rate_p, rate_v,
             dt_p, dt_v, out.data_ptr(), cs.data_ptr(), first.data_ptr(),
             count.data_ptr(), n, nc, _build.stream_of(v))
    coulomb_pairs.launches += 1
    _build.check_launch(err, "coulomb_pairs")
    return out, count


coulomb_pairs.launches = 0


def cell_density_plain(x: torch.Tensor, alive: torch.Tensor, w: torch.Tensor,
                       *, dx: float, nc: int, length: float) -> torch.Tensor:
    """Plain version: the (nc,) sum of the weights w (n,) of the ``eligible``
    rows by ``cell_keys``; the other rows add 0 into a sentinel bin nc, cut
    off."""
    ok = eligible(x, alive, length)
    hist = torch.zeros(nc + 1, dtype=x.dtype, device=x.device)
    hist.index_add_(0, cell_keys(x, ok, dx, nc).long(),
                    torch.where(ok, w, 0.0))
    return hist[:nc]


def cell_density(x: torch.Tensor, alive: torch.Tensor, w: torch.Tensor, *,
                 dx: float, nc: int, length: float) -> torch.Tensor:
    """CUDA kernel: same arguments and result as ``cell_density_plain``."""
    _build.require_cuda(x, "cell_density")
    n, dev = x.shape[0], x.device
    _build.require(x, "x", torch.float32, (n,), dev)
    _build.require(alive, "alive", torch.bool, (n,), dev)
    _build.require(w, "w", torch.float32, (n,), dev)
    if n == 0:
        return torch.zeros(nc, dtype=torch.float32, device=dev)
    hist = torch.empty(nc, dtype=torch.float32, device=dev)
    fn = _build.function("collide", "cell_density", _DENSITY_ARGTYPES)
    err = fn(x.data_ptr(), alive.data_ptr(), w.data_ptr(), hist.data_ptr(),
             inv_dx(dx), float(length), n, nc, _build.stream_of(x))
    cell_density.launches += 1
    _build.check_launch(err, "cell_density")
    return hist


cell_density.launches = 0

