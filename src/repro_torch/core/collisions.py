"""Monte-Carlo ionization, the paper's §3.3 source (the ionization half of
``repro.core.collisions``), and the collision-menu configuration.

Electron-impact ionization depletes neutrals as dn/dt = -n n_e R. Per
macro-neutral per step, P = 1 - exp(-n_e(x) R dt) with n_e gathered from
the deposited electron density; an ionized neutral dies and spawns an
(e-, D+) pair at its position: the ion inherits its velocity, the electron
samples a Maxwellian. A pair is born only when both buffers have a free
slot; a refused neutral survives and retries (``birth_overflow``).

Binary collisions pair particles inside one grid cell. Three operators run
from a ``CollisionConfig`` menu (``apply_menu``), on the cell-binned
machinery ``cell_density`` / ``cell_shuffled_order`` / ``pair_in_cells`` /
``_cell_starts``:

* ``elastic_scatter``: isotropic scattering off a per-cell partner density,
  P = 1 - exp(-n_cell rate dt); keeps each particle's speed;
* ``charge_exchange``: an event ion swaps its velocity with a distinct
  random neutral of its own cell (equal masses, so momentum and energy are
  exchanged exactly);
* ``coulomb_intra``: every within-cell pair deflects its relative velocity
  through a Takizuka-Abe angle (``ta_kick_ref``, or pairing and deflection
  in one CUDA kernel through ``kernels.ops.coulomb_pairs``); the half-kicks
  v1 += du/2, v2 -= du/2 keep the pair's momentum exactly.

Every draw is indexed by occupancy rank: the k-th eligible row reads the
k-th element of a full-length stream, so a stable reorder of the buffer
changes no surviving particle's physics. Sorts are stable, as the
reference's ``jnp.argsort`` is, so the same draws give the same pairs.
Each operator takes ``gen`` and an optional ``draws`` dict of the arrays it
would draw: bounded uniforms arrive already scaled to their bounds.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Sequence

import torch

from repro_torch.core.grid import Grid1D, deposit_density, gather
from repro_torch.core.particles import (SpeciesBuffer, _put, as_target,
                                        copy_species, nonzero_static, take)
from repro_torch.kernels import ops
# rows that may collide and their cell keys: the rule lives beside the
# density kernel, which restates it
from repro_torch.kernels.collide import cell_keys as _cells
from repro_torch.kernels.collide import eligible as _eligible


class IonizationParams(NamedTuple):
    rate: float          # R, ionization rate coefficient
    vth_electron: float  # thermal speed of spawned electrons


class IonizationBirths(NamedTuple):
    """Full-length birth candidates of one ``ionize`` call (``ok`` marks the
    pairs that landed); the carried-rho cycle deposits these."""

    x: torch.Tensor           # (cap,) birth position (the neutral's)
    v_electron: torch.Tensor  # (cap, 3)
    v_ion: torch.Tensor       # (cap, 3)
    w: torch.Tensor           # (cap,)
    ok: torch.Tensor          # (cap,) bool: pair actually born


class BirthPack(NamedTuple):
    """Packed ionization kills and births of one queue (``budget`` rows).

    ``slot`` holds the queue-local indices of the neutrals that won a budget
    row (``ok``); the caller decides which die (ring availability) and feeds
    the freed slots to ``ring_push``. ``n_events`` counts every hit before
    the clamp; hits beyond the budget survive and retry next step."""

    slot: torch.Tensor        # (B,) int32 queue-local neutral slot, cap pad
    ok: torch.Tensor          # (B,) bool: row holds a real event
    x: torch.Tensor           # (B,)
    v_electron: torch.Tensor  # (B, 3)
    v_ion: torch.Tensor       # (B, 3)
    w: torch.Tensor           # (B,)
    n_events: torch.Tensor    # () int32 hits before the budget clamp


def ionization_events(gen: torch.Generator, x: torch.Tensor,
                      alive: torch.Tensor, ne_at: torch.Tensor,
                      params: IonizationParams, dt: float,
                      draws: dict | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Which neutrals ionize, and the spawned electrons' Maxwellian
    velocities. ``draws``: ``"uniform"`` x.shape and ``"normal"``
    x.shape + (3,). Returns (hit mask, v_electron)."""
    p = 1.0 - torch.exp(-ne_at * params.rate * dt)
    if draws is None:
        u = torch.rand(x.shape, generator=gen, dtype=x.dtype,
                       device=x.device)
        nrm = torch.randn(x.shape + (3,), generator=gen, dtype=x.dtype,
                          device=x.device)
    else:
        u = torch.as_tensor(draws["uniform"], dtype=x.dtype, device=x.device)
        nrm = torch.as_tensor(draws["normal"], dtype=x.dtype, device=x.device)
    hit = alive & (u < p)
    return hit, params.vth_electron * nrm


def ionize(gen: torch.Generator, neutrals: SpeciesBuffer,
           electrons: SpeciesBuffer, ions: SpeciesBuffer, grid: Grid1D,
           params: IonizationParams, dt: float,
           ne: torch.Tensor | None = None, draws: dict | None = None,
           donate: bool = False,
           ) -> tuple[SpeciesBuffer, SpeciesBuffer, SpeciesBuffer, dict,
                      IonizationBirths]:
    """One MC ionization step over the full buffers: the k-th hit, in index
    order, is born in the k-th dead slot of both the electrons and the ions
    and its neutral dies, for k below both buffers' free counts
    (``kernels.ops.place_births_``). With ``donate`` the three buffers are
    written in place and returned (``births.w`` is then a copy of the
    neutrals' weights taken before the kill); without, they are left
    unchanged.

    Returns (neutrals, electrons, ions, diag, births).
    """
    if ne is None:
        ne = deposit_density(grid, electrons)
    ne_at = gather(grid, ne, neutrals.x)
    hit, ve = ionization_events(gen, neutrals.x, neutrals.alive, ne_at,
                                params, dt, draws)
    if donate:
        w = neutrals.w.clone()          # the kill zeroes the ionized rows
    else:
        w = neutrals.w
        neutrals = dataclasses.replace(neutrals, w=w.clone(),
                                       alive=neutrals.alive.clone())
        electrons, ions = copy_species(electrons), copy_species(ions)
    ok, n, overflow = ops.place_births_(
        hit, [as_target(electrons), as_target(ions)],
        [(neutrals.x, ve, neutrals.w), (neutrals.x, neutrals.v, neutrals.w)],
        kill=(neutrals.alive, neutrals.w))
    births = IonizationBirths(x=neutrals.x, v_electron=ve, v_ion=neutrals.v,
                              w=w, ok=ok)
    # a pair lands in both buffers or in neither: none is dropped
    diag = {
        "n_ionized": n,
        "ionize_dropped": torch.zeros((), dtype=torch.int32,
                                      device=hit.device),
        "birth_overflow": overflow,
    }
    return neutrals, electrons, ions, diag, births


def ionize_packed(gen: torch.Generator, neutrals: SpeciesBuffer, grid: Grid1D,
                  params: IonizationParams, dt: float, ne: torch.Tensor,
                  budget: int, draws: dict | None = None) -> BirthPack:
    """MC ionization with kills and births as packed rows (the engine's
    per-queue form). Events are drawn over the queue slice (``draws`` as
    ``ionization_events``) and the first ``budget`` hits are packed by
    their prefix-sum rank; later hits do not ionize this step. Neutrals
    outside [0, grid.length), crossers awaiting migration, are excluded.
    The caller kills the rows it accepts (``particles.kill_packed``)."""
    ne_at = gather(grid, ne, neutrals.x)
    inside = (neutrals.x >= 0.0) & (neutrals.x < grid.length)
    hit, ve = ionization_events(gen, neutrals.x, neutrals.alive & inside,
                                ne_at, params, dt, draws)
    cap = neutrals.capacity
    idx = nonzero_static(hit, budget, cap)
    sub = take(neutrals, idx)             # alive == row won a budget slot
    ve_rows = torch.where(sub.alive[:, None], ve[idx.clamp(0, cap - 1)], 0.0)
    return BirthPack(slot=idx.to(torch.int32), ok=sub.alive, x=sub.x,
                     v_electron=ve_rows, v_ion=sub.v, w=sub.w,
                     n_events=hit.sum(dtype=torch.int32))


# ---- per-cell binary collisions ---------------------------------------------

COLLISION_KINDS = ("elastic", "charge_exchange", "coulomb")

# diagnostic key per kind
_KIND_DIAG = {"elastic": "coll_elastic", "charge_exchange": "coll_cx",
              "coulomb": "coll_coulomb"}


@dataclasses.dataclass(frozen=True)
class CollisionConfig:
    """One entry of the binary-collision menu (see the reference's
    ``CollisionConfig`` for the meaning of each field)."""

    kind: str
    species: int
    partner: int | None = None
    rate: float = 0.0


def validate_menu(cfgs: Sequence[CollisionConfig], species) -> None:
    """Static sanity of a collision menu against a species list (raises)."""
    ns = len(species)
    for cc in cfgs:
        if cc.kind not in COLLISION_KINDS:
            raise ValueError(f"unknown collision kind {cc.kind!r}; valid "
                             f"kinds are {COLLISION_KINDS}")
        if not 0 <= cc.species < ns:
            raise ValueError(f"collision species index {cc.species} out of "
                             f"range for {ns} species")
        if cc.kind == "coulomb":
            if cc.partner not in (None, cc.species):
                raise ValueError(
                    "coulomb is intra-species: partner must be None "
                    f"(got {cc.partner})")
        else:
            if cc.partner is None or not 0 <= cc.partner < ns:
                raise ValueError(f"{cc.kind} needs a partner species index, "
                                 f"got {cc.partner}")
            if cc.partner == cc.species:
                raise ValueError(f"{cc.kind} partner must differ from the "
                                 f"scattered species ({cc.species})")
        if cc.kind == "charge_exchange":
            if species[cc.species].mass != species[cc.partner].mass:
                raise ValueError(
                    "charge_exchange is an identity swap — it conserves "
                    "momentum/energy only for equal masses, got "
                    f"{species[cc.species].mass} vs "
                    f"{species[cc.partner].mass}")
        if cc.rate < 0.0:
            raise ValueError(f"collision rate must be >= 0, got {cc.rate}")


def involved_species(cfgs: Sequence[CollisionConfig]) -> tuple[int, ...]:
    """Every species index a menu reads or writes."""
    out: set[int] = set()
    for cc in cfgs:
        out.add(cc.species)
        if cc.partner is not None:
            out.add(cc.partner)
    return tuple(sorted(out))


def density_species(cfgs: Sequence[CollisionConfig]) -> tuple[int, ...]:
    """Species whose per-cell density sets a menu's collision rates."""
    return tuple(sorted(
        {cc.species if cc.partner is None else cc.partner for cc in cfgs}))


def _rank_rows(ok: torch.Tensor) -> torch.Tensor:
    """Occupancy rank of each row (the k-th ``ok`` row maps to k); draws
    are gathered through it."""
    n = ok.shape[0]
    return (torch.cumsum(ok, 0) - 1).clamp(0, n - 1)


def _at_cell(n_cell: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Gather a (nc,) per-cell field at cell keys (0 at the nc sentinel)."""
    return torch.cat([n_cell, n_cell.new_zeros(1)])[c.long()]


def _draw(draws: dict | None, name: str, gen: torch.Generator, n: int,
          device: torch.device, lo: float = 0.0,
          hi: float = 1.0) -> torch.Tensor:
    """(n,) float32 uniform in [lo, hi): ``draws[name]`` as given, else
    lo + (hi - lo) * u with u from ``gen``."""
    if draws is not None:
        return torch.as_tensor(draws[name], dtype=torch.float32,
                               device=device)
    u = torch.rand(n, generator=gen, dtype=torch.float32, device=device)
    return u if (lo, hi) == (0.0, 1.0) else lo + (hi - lo) * u


def cell_density(grid: Grid1D, buf: SpeciesBuffer) -> torch.Tensor:
    """Per-cell weighted density (nc,): the rate input of the menu. A
    histogram of the eligible rows' weights (``_eligible``, ``_cells``),
    not the CIC deposit; one kernel on the card."""
    return ops.cell_density(buf.x, buf.alive, buf.w, dx=grid.dx, nc=grid.nc,
                            length=grid.length)


def _cell_shuffle(gen: torch.Generator, cell: torch.Tensor, ok: torch.Tensor,
                  draws: dict | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(order, cell[order]) of ``cell_shuffled_order``: the sorted keys come
    with the sort that groups the rows."""
    n = cell.shape[0]
    u = _draw(draws, "shuffle", gen, n, cell.device)[_rank_rows(ok)]
    perm = torch.sort(u, stable=True).indices
    keys, idx = torch.sort(cell[perm], stable=True)
    return perm[idx], keys


def cell_shuffled_order(gen: torch.Generator, cell: torch.Tensor,
                        ok: torch.Tensor,
                        draws: dict | None = None) -> torch.Tensor:
    """Permutation grouping rows by cell in random within-cell order
    (ineligible rows at the tail). ``draws``: ``"shuffle"`` (n,) in
    [0, 1), read through the occupancy rank."""
    return _cell_shuffle(gen, cell, ok, draws)[0]


def pair_in_cells(gen: torch.Generator, cell: torch.Tensor, ok: torch.Tensor,
                  draws: dict | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Disjoint random within-cell pairs.

    Returns (ia, ib, valid), each (n,): position t of the cell-shuffled
    order is a pair head where ``valid``, a row at an even offset within
    its cell's segment whose successor ``ib[t]`` is in the same cell. Each
    cell forms floor(count / 2) pairs wherever its segment starts."""
    n = cell.shape[0]
    order = cell_shuffled_order(gen, cell, ok, draws)
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
    return ia, ib, valid


def elastic_scatter(gen: torch.Generator, sp: SpeciesBuffer,
                    n_cell: torch.Tensor, grid: Grid1D, rate: float,
                    dt: float, draws: dict | None = None
                    ) -> tuple[SpeciesBuffer, torch.Tensor]:
    """Isotropic elastic scattering off a per-cell partner density.

    P = 1 - exp(-n_cell rate dt) per eligible particle; an event turns the
    velocity to a uniform direction on the sphere at the same speed.
    ``draws``: ``"uniform"`` (cap,) in [0, 1), ``"cos"`` (cap,) in
    [-1, 1), ``"phi"`` (cap,) in [0, 2 pi). Returns (buffer, n_events)."""
    cap = sp.x.shape[0]
    ok = _eligible(sp.x, sp.alive, grid.length)
    c = _cells(sp.x, ok, grid.dx, grid.nc)
    rows = _rank_rows(ok)
    p = -torch.expm1(-_at_cell(n_cell, c).to(sp.x.dtype) * rate * dt)
    dev = sp.x.device
    u = _draw(draws, "uniform", gen, cap, dev)[rows]
    cos_t = _draw(draws, "cos", gen, cap, dev, -1.0, 1.0)[rows]
    phi = _draw(draws, "phi", gen, cap, dev, 0.0, 2.0 * math.pi)[rows]
    hit = ok & (u < p)

    speed = torch.sqrt(torch.sum(sp.v * sp.v, dim=-1, keepdim=True))
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    dirs = torch.stack([cos_t, sin_t * torch.cos(phi),
                        sin_t * torch.sin(phi)], -1)
    v = torch.where(hit[:, None], speed * dirs, sp.v)
    return (dataclasses.replace(sp, v=v), hit.sum(dtype=torch.int32))


def _cell_starts(keys: torch.Tensor, nc: int) -> torch.Tensor:
    """Bin starts (nc + 1,) int32 of cell keys (n,) int32 sorted ascending
    in [0, nc]: ``starts[c]`` is the first position whose key is >= c, so
    cell c occupies [starts[c], starts[c + 1]). ``particles.cell_bins``'
    starts, without its histogram or its host sync."""
    cells = torch.arange(nc + 1, dtype=keys.dtype, device=keys.device)
    return torch.searchsorted(keys, cells, out_int32=True)


def _hit_ranks(cell: torch.Tensor, hit: torch.Tensor, nc: int
               ) -> tuple[torch.Tensor, ...]:
    """Rows in stable cell order and, for each hit row, its rank among its
    cell's hits: the running hit count minus the hits before the cell's
    first sorted row. Returns (order, cell[order] int64, hit[order],
    rank); a row that is no hit has no meaningful rank."""
    keys, order = torch.sort(cell, stable=True)
    c_sort = keys.long()
    first = _cell_starts(keys, nc)[c_sort]
    hit_sort = hit[order]
    csum = torch.cumsum(hit_sort, 0)
    return order, c_sort, hit_sort, csum - 1 - (csum - hit_sort.long())[first]


def charge_exchange(gen: torch.Generator, ions: SpeciesBuffer,
                    neutrals: SpeciesBuffer, nn_cell: torch.Tensor,
                    grid: Grid1D, rate: float, dt: float,
                    draws: dict | None = None
                    ) -> tuple[SpeciesBuffer, SpeciesBuffer, torch.Tensor]:
    """Resonant charge exchange: within-cell ion <-> neutral velocity swap.

    Each eligible ion collides with P = 1 - exp(-n_n(cell) rate dt); the
    r-th event ion of a cell swaps velocities with the r-th neutral of that
    cell's shuffled bin. Events beyond a cell's neutrals are starved and
    retry next step. ``draws``: ``"uniform"`` (cap_i,) and ``"shuffle"``
    (cap_n,). Returns (ions, neutrals, n_swapped)."""
    cap_i, cap_n = ions.x.shape[0], neutrals.x.shape[0]
    nc = grid.nc

    ok_i = _eligible(ions.x, ions.alive, grid.length)
    c_i = _cells(ions.x, ok_i, grid.dx, nc)
    p = -torch.expm1(-_at_cell(nn_cell, c_i).to(ions.x.dtype) * rate * dt)
    u = _draw(draws, "uniform", gen, cap_i, ions.x.device)[_rank_rows(ok_i)]
    hit = ok_i & (u < p)

    # the partner table: this buffer's neutrals by cell, shuffled in-cell,
    # its bins read off the sorted keys
    ok_n = _eligible(neutrals.x, neutrals.alive, grid.length)
    c_n = _cells(neutrals.x, ok_n, grid.dx, nc)
    n_order, cn_sort = _cell_shuffle(gen, c_n, ok_n, draws)
    starts_n = _cell_starts(cn_sort, nc)
    counts_n = torch.diff(starts_n, append=starts_n.new_full((1,), cap_n))

    i_order, c_sort, hit_sort, rk = _hit_ranks(c_i, hit, nc)
    has = hit_sort & (rk < counts_n[c_sort])
    ppos = torch.where(has, starts_n[c_sort] + rk, cap_n)
    partner = n_order[ppos.clamp(0, cap_n - 1)]

    vi_rows = ions.v[i_order]
    vn_rows = neutrals.v[partner]
    iv = _put(ions.v, torch.where(has, i_order, cap_i), vn_rows)
    nv = _put(neutrals.v, torch.where(has, partner, cap_n), vi_rows)
    return (dataclasses.replace(ions, v=iv),
            dataclasses.replace(neutrals, v=nv), has.sum(dtype=torch.int32))


def ta_kick_ref(u: torch.Tensor, delta: torch.Tensor,
                phi: torch.Tensor) -> torch.Tensor:
    """Takizuka-Abe deflection of relative velocities (the reference's
    ``ta_kick_ref``, which divides by 1 + delta^2 where the kernel
    multiplies by its inverse).

    ``u`` (M, 3) rotates through theta with tan(theta/2) = ``delta`` about
    azimuth ``phi``; returns du = u' - u with |u'| = |u|."""
    ux, uy, uz = u[..., 0], u[..., 1], u[..., 2]
    d2 = delta * delta
    cos_t = (1.0 - d2) / (1.0 + d2)
    sin_t = 2.0 * delta / (1.0 + d2)
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
    # u along z: scatter out of the degenerate frame directly
    dux0 = uz * sin_t * cphi
    duy0 = uz * sin_t * sphi
    duz0 = -uz * one_m
    return torch.stack([torch.where(safe, dux, dux0),
                        torch.where(safe, duy, duy0),
                        torch.where(safe, duz, duz0)], dim=-1)


def _coulomb_draws(gen: torch.Generator, draws: dict | None, m: int,
                   dtype: torch.dtype, device: torch.device
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(nrm, phi) of ``coulomb_intra``, in that order: a standard normal
    (m,) and an azimuth (m,) in [0, 2 pi)."""
    if draws is None:
        nrm = torch.randn(m, generator=gen, dtype=dtype, device=device)
    else:
        nrm = torch.as_tensor(draws["normal"], dtype=dtype, device=device)
    return nrm, _draw(draws, "phi", gen, m, device, 0.0, 2.0 * math.pi)


def coulomb_intra(gen: torch.Generator, sp: SpeciesBuffer,
                  n_cell: torch.Tensor, grid: Grid1D, rate: float, dt: float,
                  use_kernel: bool = False, draws: dict | None = None
                  ) -> tuple[SpeciesBuffer, torch.Tensor]:
    """Takizuka-Abe intra-species Coulomb scattering.

    Every eligible within-cell pair (``pair_in_cells``) deflects its
    relative velocity u by tan(theta/2) ~ N(0, rate n_cell dt / |u|^3);
    v1 += du/2, v2 -= du/2. ``use_kernel`` pairs and deflects the rows of
    ``cell_shuffled_order`` through ``kernels.ops.coulomb_pairs`` (one CUDA
    kernel on the card), else through ``pair_in_cells`` and
    ``ta_kick_ref``; the draws are the same either way. ``draws``:
    ``"shuffle"`` (cap,), ``"normal"`` (cap,), ``"phi"`` (cap,) in
    [0, 2 pi). Returns (buffer, n_pairs)."""
    dtype = sp.x.dtype
    ok = _eligible(sp.x, sp.alive, grid.length)
    c = _cells(sp.x, ok, grid.dx, grid.nc)
    if use_kernel:
        order = cell_shuffled_order(gen, c, ok, draws)
        nrm, phi = _coulomb_draws(gen, draws, order.shape[0], dtype,
                                  sp.x.device)
        v, n_pairs = ops.coulomb_pairs(order, c, sp.v, n_cell.to(dtype), nrm,
                                       phi, rate, dt)
        return dataclasses.replace(sp, v=v), n_pairs
    ia, ib, valid = pair_in_cells(gen, c, ok, draws)
    m = ia.shape[0]

    u = sp.v[ia] - sp.v[ib]
    umag = torch.sqrt(torch.sum(u * u, dim=-1))
    n_at = _at_cell(n_cell, c[ia]).to(dtype)   # both rows share the cell
    var = rate * n_at * dt / torch.clamp(umag * umag * umag, min=1e-12)
    nrm, phi = _coulomb_draws(gen, draws, m, dtype, sp.x.device)
    delta = torch.sqrt(var) * nrm
    du = torch.where(valid[:, None], ta_kick_ref(u, delta, phi), 0.0)
    v = sp.v.index_add(0, ia, 0.5 * du).index_add(0, ib, -0.5 * du)
    return dataclasses.replace(sp, v=v), valid.sum(dtype=torch.int32)


def apply_menu(gen: torch.Generator, bufs: dict[int, SpeciesBuffer],
               cfgs: Sequence[CollisionConfig],
               dens: dict[int, torch.Tensor], grid: Grid1D, dt: float,
               use_kernel: bool = False,
               draws: Sequence[dict] | None = None,
               rates: Sequence[torch.Tensor] | None = None
               ) -> tuple[dict[int, SpeciesBuffer], dict]:
    """Run a collision menu, in order, over species buffers (index ->
    buffer). ``dens`` maps the menu's ``density_species`` to their (nc,)
    cell densities. ``draws``: one dict per menu entry, in menu order.
    ``rates`` (optional, one 0-d tensor per menu entry) replaces the
    entries' ``cc.rate``: the runtime-parameter path. Returns (bufs, diag)
    with one event counter per kind."""
    bufs = dict(bufs)
    diag: dict = {}
    for k_i, cc in enumerate(cfgs):
        d = None if draws is None else draws[k_i]
        rate = cc.rate if rates is None else rates[k_i]
        if cc.kind == "elastic":
            out, n = elastic_scatter(gen, bufs[cc.species], dens[cc.partner],
                                     grid, rate, dt, d)
            bufs[cc.species] = out
        elif cc.kind == "charge_exchange":
            bi, bn, n = charge_exchange(gen, bufs[cc.species],
                                        bufs[cc.partner], dens[cc.partner],
                                        grid, rate, dt, d)
            bufs[cc.species], bufs[cc.partner] = bi, bn
        else:
            out, n = coulomb_intra(gen, bufs[cc.species], dens[cc.species],
                                   grid, rate, dt, use_kernel, d)
            bufs[cc.species] = out
        k = _KIND_DIAG[cc.kind]
        diag[k] = diag[k] + n if k in diag else n
    return bufs, diag
