"""Fixed-capacity SoA particle buffers (the port of ``repro.core.particles``).

A species is a dense structure of arrays with a fixed capacity and an
``alive`` mask: birth writes into dead slots found by a prefix sum, death
clears the mask. Dead slots carry ``w == 0``. Functions return new buffers
and leave their inputs unchanged, as the reference's do.

Monte-Carlo functions take ``draws=``: a dict of the raw random arrays they
would otherwise draw from their ``torch.Generator`` (``"uniform"`` in
[0, 1), ``"normal"`` standard normal). Tests hand in the reference's draws.

The free-slot ring (``FreeSlotRing``, ``ring_*``) and ``kill_packed`` serve
the multi-domain engine: they take any leading batch axes (the engine's
(D, S) domains by species) and work along the last one. The planar helpers
are the reference's (rows, 128) layout contract for its TPU kernels; no
kernel of the port needs it, and they are kept as plain functions.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from repro_torch.kernels.mover import inv_dx


# ---- planar layout of the reference's TPU kernels ---------------------------
LANES = 128


def plane_pad(a: torch.Tensor, block: int, value=0.0) -> torch.Tensor:
    """Pad dim 0 up to a multiple of ``block`` (no copy when aligned)."""
    pad = (-a.shape[0]) % block
    if pad == 0:
        return a
    return torch.cat([a, torch.full((pad,) + tuple(a.shape[1:]), value,
                                    dtype=a.dtype, device=a.device)])


def to_planes(a: torch.Tensor, tile_rows: int = 8,
              value=0.0) -> torch.Tensor:
    """(cap,) -> (rows, LANES) with rows a multiple of ``tile_rows``."""
    return plane_pad(a, tile_rows * LANES, value).reshape(-1, LANES)


def from_planes(p: torch.Tensor, capacity: int) -> torch.Tensor:
    """(rows, LANES) -> (capacity,), dropping pad slots."""
    return p.reshape(-1)[:capacity]


@dataclasses.dataclass
class SpeciesBuffer:
    """SoA buffer for one species. All tensors share leading dim = capacity."""

    x: torch.Tensor      # (cap,)   position, in [0, L)
    v: torch.Tensor      # (cap, 3) velocity (1D3V: only v[:, 0] couples to E)
    w: torch.Tensor      # (cap,)   macro-particle weight
    alive: torch.Tensor  # (cap,)   bool mask

    @property
    def capacity(self) -> int:
        return self.x.shape[0]

    def count(self) -> torch.Tensor:
        return self.alive.sum(dtype=torch.int32)


@dataclasses.dataclass
class StackedSpecies:
    """All same-capacity species as one (S, cap) structure: the input of the
    stacked fused kernel. Per-species scalars travel as (S,) tensors."""

    x: torch.Tensor      # (S, cap)
    v: torch.Tensor      # (S, cap, 3)
    w: torch.Tensor      # (S, cap)
    alive: torch.Tensor  # (S, cap)

    @property
    def num_species(self) -> int:
        return self.x.shape[0]

    @property
    def capacity(self) -> int:
        return self.x.shape[1]

    def counts(self) -> torch.Tensor:
        return self.alive.sum(dim=1, dtype=torch.int32)


def stack_species(bufs: Sequence[SpeciesBuffer]) -> StackedSpecies:
    """Stack same-capacity species buffers into one (S, cap) structure."""
    caps = {b.capacity for b in bufs}
    if len(caps) != 1:
        raise ValueError(f"stack_species needs equal capacities, got {caps}")
    return StackedSpecies(
        x=torch.stack([b.x for b in bufs]),
        v=torch.stack([b.v for b in bufs]),
        w=torch.stack([b.w for b in bufs]),
        alive=torch.stack([b.alive for b in bufs]))


def unstack_species(st: StackedSpecies) -> tuple[SpeciesBuffer, ...]:
    """Per-species views into the stack (no copy)."""
    return tuple(
        SpeciesBuffer(x=st.x[s], v=st.v[s], w=st.w[s], alive=st.alive[s])
        for s in range(st.num_species))


def make_species(capacity: int, dtype=torch.float32,
                 device="cuda") -> SpeciesBuffer:
    """An empty (all-dead) buffer."""
    return SpeciesBuffer(
        x=torch.zeros(capacity, dtype=dtype, device=device),
        v=torch.zeros(capacity, 3, dtype=dtype, device=device),
        w=torch.zeros(capacity, dtype=dtype, device=device),
        alive=torch.zeros(capacity, dtype=torch.bool, device=device))


def init_uniform(gen: torch.Generator, capacity: int, n: int, length: float,
                 vth: float, drift: float = 0.0, weight: float = 1.0,
                 dtype=torch.float32, draws: dict | None = None
                 ) -> SpeciesBuffer:
    """n live particles uniform in x, Maxwellian in v; rest of buffer dead.
    Tensors land on the generator's device. ``draws``: ``"uniform"``
    (capacity,) and ``"normal"`` (capacity, 3)."""
    dev = gen.device
    if draws is None:
        u = torch.rand(capacity, generator=gen, dtype=dtype, device=dev)
        nrm = torch.randn(capacity, 3, generator=gen, dtype=dtype, device=dev)
    else:
        u = torch.as_tensor(draws["uniform"], dtype=dtype, device=dev)
        nrm = torch.as_tensor(draws["normal"], dtype=dtype, device=dev)
    x = u * length
    v = vth * nrm
    v[:, 0] = v[:, 0] + drift
    alive = torch.arange(capacity, device=dev) < n
    w = torch.full((capacity,), weight, dtype=dtype, device=dev)
    return SpeciesBuffer(x=x, v=v, w=w * alive, alive=alive)


def nonzero_static(mask: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    """Indices (int64) of the first ``size`` True entries of ``mask``
    (..., n) along the last axis, padded with ``fill``: the reference's
    ``jnp.nonzero(size=, fill_value=)``, without waiting for the card
    (``torch.nonzero`` would). One prefix sum over all rows laid end to
    end (a 1-D scan; a batched scan along a long last axis runs a few rows
    at a time on a card) and a binary search of it for each wanted rank:
    the work is O(n + size log n), and nothing scatters into a pad slot."""
    n = mask.shape[-1]
    rows = mask.reshape(-1, n)
    b = rows.shape[0]
    dev = mask.device
    csum = torch.cumsum(rows.reshape(-1), 0)
    upto = csum.view(b, n)[:, -1]                 # trues up to a row's end
    before = upto - rows.sum(-1)                  # trues in earlier rows
    k = torch.arange(1, size + 1, device=dev)
    pos = torch.searchsorted(csum, (before[:, None] + k).reshape(-1))
    local = pos.view(b, size) - torch.arange(b, device=dev)[:, None] * n
    found = k <= (upto - before)[:, None]
    out = torch.where(found, local, fill)
    return out.reshape(tuple(mask.shape[:-1]) + (size,))


def free_slots(buf: SpeciesBuffer, max_n: int) -> torch.Tensor:
    """Indices of the first ``max_n`` dead slots (capacity = none left).
    A prefix sum and one scatter, so the host never waits for the card."""
    cap = buf.capacity
    dead = ~buf.alive
    pos = torch.cumsum(dead, 0) - 1
    tgt = torch.where(dead & (pos < max_n), pos, max_n)
    out = torch.full((max_n + 1,), cap, dtype=torch.long,
                     device=buf.x.device)
    out.scatter_(0, tgt, torch.arange(cap, device=buf.x.device))
    return out[:max_n]


def _put(a: torch.Tensor, dest: torch.Tensor, rows) -> torch.Tensor:
    """Copy of ``a`` with ``rows`` written at ``dest``; a destination equal
    to the capacity lands in a scratch row that is cut off (mode='drop')."""
    cap = a.shape[0]
    out = torch.empty((cap + 1,) + tuple(a.shape[1:]), dtype=a.dtype,
                      device=a.device)
    out[:cap] = a
    out.index_put_((dest,), torch.as_tensor(rows, dtype=a.dtype,
                                            device=a.device).expand(
        (dest.shape[0],) + tuple(a.shape[1:])))
    return out[:cap]


def inject_at(buf: SpeciesBuffer, dest: torch.Tensor, x: torch.Tensor,
              v: torch.Tensor, w: torch.Tensor,
              ok: torch.Tensor) -> SpeciesBuffer:
    """Scatter candidates into pre-claimed dead slots ``dest`` (M,); rows
    where ``ok`` is False are dropped."""
    dest = torch.where(ok, dest, buf.capacity)
    return SpeciesBuffer(x=_put(buf.x, dest, x), v=_put(buf.v, dest, v),
                         w=_put(buf.w, dest, w),
                         alive=_put(buf.alive, dest, True))


def inject_masked(buf: SpeciesBuffer, x: torch.Tensor, v: torch.Tensor,
                  w: torch.Tensor, mask: torch.Tensor
                  ) -> tuple[SpeciesBuffer, torch.Tensor, torch.Tensor]:
    """Write ``mask``-selected candidates (fixed length M) into dead slots.
    Returns (buffer, n_dropped, accepted): candidates that find no free slot
    are dropped and counted."""
    m = x.shape[0]
    rank = torch.cumsum(mask, 0) - 1
    slots = free_slots(buf, m)
    dest = torch.where(mask, slots[rank.clamp(0, m - 1)], buf.capacity)
    ok = mask & (dest < buf.capacity)
    out = inject_at(buf, dest, x, v, w, ok)
    n_dropped = (mask & ~ok).sum(dtype=torch.int32)
    return out, n_dropped, ok


def inject(buf: SpeciesBuffer, x: torch.Tensor, v: torch.Tensor,
           w: torch.Tensor, mask: torch.Tensor
           ) -> tuple[SpeciesBuffer, torch.Tensor]:
    """``inject_masked`` without the accepted mask."""
    out, n_dropped, _ = inject_masked(buf, x, v, w, mask)
    return out, n_dropped


def kill(buf: SpeciesBuffer, mask: torch.Tensor) -> SpeciesBuffer:
    """Mark ``mask`` particles dead (absorbed at a wall, ionized away)."""
    alive = buf.alive & ~mask
    return dataclasses.replace(buf, alive=alive, w=buf.w * alive)


def cell_index(buf: SpeciesBuffer, dx: float, nc: int) -> torch.Tensor:
    """Cell of each particle (int32); dead particles are parked at nc. The
    cell coordinate is x * inv_dx(dx), as in every other path."""
    c = torch.floor(buf.x * inv_dx(dx)).to(torch.int32).clamp(0, nc - 1)
    return torch.where(buf.alive, c, nc)


def counts_per_cell(buf: SpeciesBuffer, dx: float, nc: int) -> torch.Tensor:
    """Live particles per cell (nc,) int32, BIT1's ``np[isp][j]``."""
    return torch.bincount(cell_index(buf, dx, nc).long(),
                          minlength=nc + 1)[:nc].to(torch.int32)


def _reorder(buf: SpeciesBuffer, order: torch.Tensor) -> SpeciesBuffer:
    return SpeciesBuffer(x=buf.x[order], v=buf.v[order], w=buf.w[order],
                         alive=buf.alive[order])


def sort_by_cell(buf: SpeciesBuffer, dx: float, nc: int) -> SpeciesBuffer:
    """Live particles grouped by cell (stable), dead particles at the tail."""
    key = cell_index(buf, dx, nc)
    return _reorder(buf, torch.sort(key, stable=True).indices)


def cell_bins(cell: torch.Tensor, nc: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Bin table of a cell-key array (ineligible rows keyed ``nc``).

    Returns (counts, starts), both (nc + 1,) int32: in any stable sort by
    ``cell``, cell c occupies positions [starts[c], starts[c] + counts[c]).
    ``starts[nc]`` is the number of rows keyed below nc. A histogram and a
    (nc + 1,) prefix sum: the cost scales with the cell count."""
    counts = torch.bincount(cell.long(), minlength=nc + 1)[:nc + 1]
    starts = torch.cumsum(counts, 0) - counts
    return counts.to(torch.int32), starts.to(torch.int32)


def compact(buf: SpeciesBuffer) -> SpeciesBuffer:
    """Live particles first, in their order (stable)."""
    return _reorder(buf, torch.sort((~buf.alive).to(torch.uint8),
                                    stable=True).indices)


def take(buf: SpeciesBuffer, idx: torch.Tensor) -> SpeciesBuffer:
    """Gather a sub-buffer; an index equal to the capacity gives a dead,
    zeroed row."""
    cap = buf.capacity
    valid = idx < cap
    idx_c = idx.clamp(0, cap - 1)
    return SpeciesBuffer(x=buf.x[idx_c] * valid,
                         v=buf.v[idx_c] * valid[:, None],
                         w=buf.w[idx_c] * valid,
                         alive=buf.alive[idx_c] & valid)


def kill_packed(buf: SpeciesBuffer, idx: torch.Tensor,
                ok: torch.Tensor) -> SpeciesBuffer:
    """Kill the ``ok``-masked packed slot indices ``idx`` (M,): the packed
    mirror of ``inject_at``, so the freed slots can feed ``ring_push``
    without a scan."""
    cap = buf.capacity
    gone = torch.zeros(cap + 1, dtype=torch.bool, device=buf.x.device)
    gone[torch.where(ok.bool(), idx.long(), cap)] = True
    return kill(buf, gone[:cap])


# ---- persistent free-slot ring ----------------------------------------------
# Dead-slot indices kept incrementally: killed, absorbed and migrated
# particles push their slot, arrivals and births pop one, so the engine's
# merge costs O(arrivals) and never scans a buffer. A full scan is left only
# at init (``ring_init``); a compacted buffer rebuilds its ring in closed
# form (``ring_from_counts``). Every function takes leading batch axes and
# runs along the last; all are prefix sums, gathers and scatters, so none
# waits for the card.


@dataclasses.dataclass
class FreeSlotRing:
    """FIFO of dead slot indices of one fixed-capacity buffer (per leading
    batch index). Entries ``head .. head+count-1`` (mod R) of ``slots`` are
    live; the live entries are exactly the buffer's dead slots minus those
    claimed by in-flight arrivals, each at most once. int32, as the
    reference's."""

    slots: torch.Tensor   # (..., R) int32
    head: torch.Tensor    # (...,)  int32 read cursor
    count: torch.Tensor   # (...,)  int32 live entries

    @property
    def ring_capacity(self) -> int:
        return self.slots.shape[-1]


def put_rows_(dst: torch.Tensor, idx: torch.Tensor, val: torch.Tensor,
              ok: torch.Tensor) -> None:
    """``dst[idx[ok]] = val[ok]`` along dim 0, in place, without reading a
    count on the host: a row that is not ``ok`` writes the first ``ok``
    row's value to its index again (or, with none, dst[0] onto itself), so
    every index written twice gets one value. The ``ok`` indices must be
    distinct."""
    idx, ok = idx.reshape(-1), ok.reshape(-1)
    val = val.reshape((-1,) + tuple(dst.shape[1:])).to(dst.dtype)
    anyv = ok.any()
    first = torch.argmax(ok.to(torch.int32))
    fill_i = torch.where(anyv, idx[first], 0)
    fill_v = torch.where(anyv, val[first], dst[0])
    okb = ok.reshape((-1,) + (1,) * (dst.dim() - 1))
    dst.index_put_((torch.where(ok, idx, fill_i),),
                   torch.where(okb, val, fill_v))


def ring_init(alive: torch.Tensor) -> FreeSlotRing:
    """A ring holding the dead slots of ``alive`` (..., cap) in slot order
    (the one full scan), padded with the capacity."""
    cap = alive.shape[-1]
    dead = ~alive
    return FreeSlotRing(slots=nonzero_static(dead, cap, cap).to(torch.int32),
                        head=torch.zeros(alive.shape[:-1], dtype=torch.int32,
                                         device=alive.device),
                        count=dead.sum(-1, dtype=torch.int32))


def ring_from_counts(alive_count: torch.Tensor, cap: int) -> FreeSlotRing:
    """Ring of a freshly compacted buffer: the free slots are
    [count, cap)."""
    c = alive_count.to(torch.int32)
    ar = torch.arange(cap, dtype=torch.int32, device=c.device)
    slots = ar + c[..., None]
    slots = torch.where(slots < cap, slots, cap).to(torch.int32)
    return FreeSlotRing(slots=slots, head=torch.zeros_like(c),
                        count=(cap - c).to(torch.int32))


def ring_push(ring: FreeSlotRing, idx: torch.Tensor,
              ok: torch.Tensor) -> FreeSlotRing:
    """Append the freed slots ``idx`` (..., M) where ``ok``. O(M).

    The slots are written in place: the writes land past the tail of the
    live window, on stale entries, so the input ring still reads as it
    did (its head and count are untouched). ``slots`` must be
    contiguous."""
    r = ring.slots.shape[-1]
    ok = ok.bool()
    rank = torch.cumsum(ok, -1) - 1
    pos = torch.remainder(ring.head[..., None].long()
                          + ring.count[..., None] + rank, r)
    base = torch.arange(ring.count.numel(), device=pos.device).reshape(
        tuple(ring.count.shape) + (1,)) * r
    put_rows_(ring.slots.view(-1), base + pos, idx, ok)
    return FreeSlotRing(slots=ring.slots,
                        head=ring.head,
                        count=ring.count + ok.sum(-1, dtype=torch.int32))


def ring_claim(ring: FreeSlotRing, want: torch.Tensor, sentinel: int,
               budget: torch.Tensor | None = None
               ) -> tuple[FreeSlotRing, torch.Tensor, torch.Tensor]:
    """Pop one slot per ``want`` (..., M) candidate, in order.

    Returns (ring, dest, ok): ``dest`` int32 holds a claimed dead slot where
    ``ok`` and ``sentinel`` elsewhere (not wanted, or the ring ran dry).
    ``budget`` (...,) caps the grants below the ring's count: a paired claim
    on two rings passes min(count_a, count_b) to both, so both grant the
    same candidates. O(M)."""
    r = ring.slots.shape[-1]
    want = want.bool()
    rank = torch.cumsum(want, -1) - 1
    avail = (ring.count if budget is None
             else torch.minimum(ring.count, budget.to(torch.int32)))
    ok = want & (rank < avail[..., None])
    pos = torch.remainder(ring.head[..., None].long() + rank.clamp(0, r - 1),
                          r)
    dest = torch.where(ok, ring.slots.gather(-1, pos),
                       sentinel).to(torch.int32)
    n = ok.sum(-1, dtype=torch.int32)
    out = FreeSlotRing(slots=ring.slots,
                       head=torch.remainder(ring.head + n, r).to(torch.int32),
                       count=ring.count - n)
    return out, dest, ok
