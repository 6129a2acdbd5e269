"""Asynchronous multi-domain PIC engine on one device (the port of
``repro.distributed.engine``).

The paper (§4) splits each GPU's particles across async(n) queues whose
migration exchange overlaps the next queue's mover. The reference maps its
D domains onto mesh devices under ``shard_map``; the port runs the D
domains in one process on one card:

* every species field is a (D, cap_l) view of its capacity group's
  (D, S, cap_l) tensor, and domain r works on row r;
* a queue is the interleaved slice "slot c -> queue c % n_q" of a domain's
  (S, cap_l) group stack, gathered to a contiguous (S, cap_l / n_q) buffer
  for the fused kernel (``_split_queues``), and interleaved back at the
  merge (``_merge_queues``), so the ring's slot indices j * n_q + k equal
  the reference's;
* each (domain, queue) pair runs on its own CUDA stream. Its push waits for
  nothing but the step's field (an event on the main stream); its
  migration packs are copied into the neighbour domains' receive buffers on
  its own stream, and queue k+1's push does not wait for them (``nowait``).
  The free-slot rings and the carried rho are chained through the queues
  in the reference's order by one event per domain, which queue k records
  after its ring and rho updates and queue k+1 waits for before its own
  (the kernels themselves never wait on it). The deferred merge, on the
  main stream, waits for every queue's last event (``depend(in)``);
* the reference's ``ppermute`` is a counted copy between domain rows
  (``halo.send`` / ``halo.ppermute``).

The phase order is the reference's: ingest (flush pending, periodic and
skew-triggered rebalance, ``cell_order``) -> halo field -> per queue: fused
push (``boundary="open"``, carried rho) -> collide -> MC ionization ->
migrate + SEE -> deferred merge -> diagnostics. ``make_engine_step(upto=)``
builds the probes of ``PHASES``; each phase and queue stage runs inside a
``torch.profiler.record_function`` range with the reference's scope name.

No host synchronisation inside a step: packing is done by prefix sums
(``particles.nonzero_static``), never ``torch.nonzero``, and no ``.item()``
is called, with one exception: with ``rebalance_skew > 0`` the step reads
the (groups, D) tensor of per-domain occupancy skews once, after the
ingest flush, to decide which domains compact (the reference branches on
the same device value with ``lax.cond``). The periodic trigger is a host
integer.

Divergences from the reference, kept on purpose:

* The field phase solves Poisson and E in float64 (as the port's
  single-domain cycle), so a domain's E matches the reference's to float32
  rounding of a float32 solve, not bitwise.
* The diagnostics accumulate charge and kinetic energy in float64 over the
  resident rows plus the pending ones (no flushed copy of the buffers):
  the charge total of identical weights is then exact whatever the domain
  split, which a float32 sum cannot be (the reference's
  ``test_domain_parity`` fails on exactly that).
* The step donates its input state, as the reference's does: the ingest
  writes the pending rows into the input's buffers in place. The probes
  (``upto`` other than "full") and ``donate=False`` copy first.
* Random numbers come from one ``torch.Generator`` per domain; ``draws=``
  takes the reference's arrays instead (see ``step``).

``with_params``, ``retarget_state``, ``state_shape``/``state_shardings``,
``resplit_host`` and ``elastic_state`` raise ``NotImplementedError``; they
belong to later items of ``ROADMAP.md`` (3, 4, 5).
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.core import boundaries, collisions, mover
from repro_torch.core.grid import Grid1D, deposit_stacked, deposit_windowed
from repro_torch.core.particles import (FreeSlotRing, SpeciesBuffer,
                                        StackedSpecies, cell_index,
                                        init_uniform, inject_masked, kill,
                                        kill_packed, nonzero_static,
                                        put_rows_, ring_claim,
                                        ring_from_counts, ring_init,
                                        ring_push)
from repro_torch.core.pic import PICConfig, PICState
from repro_torch.core.pic import _carries_rho as pic_carries_rho
from repro_torch.device import resolve_device
from repro_torch.distributed import halo

# cumulative phase checkpoints of the probes (see perf.py): a step built
# with upto=<phase> runs the pipeline through that phase and returns
PHASES = ("ingest", "field", "push", "collide", "migrate", "merge", "full")

_ROADMAP = "ROADMAP.md queue 1 item {}"


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Decomposition and queue schedule of a global PICConfig (the
    reference's fields; ``domains`` replaces its mesh and axis names).

    ``async_n`` is the paper's async(n): queues per domain.
    ``max_migration`` is the per-species, per-direction send budget of a
    domain a step, split evenly over the queues; ``max_births`` the
    per-domain ionization birth budget. ``rebalance_every = K`` compacts
    each capacity group every K steps, ``rebalance_skew = T`` whenever a
    domain's per-queue occupancy skew exceeds T (0 disables either);
    ``cell_order`` makes the compaction a stable sort by cell.
    ``use_ring=False`` is the legacy full-scan merge, a parity mode.
    ``metrics`` adds the ring and pending counters to the diagnostics.
    """
    pic: PICConfig                       # pic.nc == GLOBAL cell count
    domains: int = 1
    async_n: int = 1
    max_migration: int = 2048            # per species/direction/step
    species_capacity_local: int | None = None  # default: global cap / D
    rebalance_every: int = 0
    rebalance_skew: int = 0
    max_births: int = 2048               # ionization births per domain/step
    use_ring: bool = True
    cell_order: bool = False
    metrics: bool = False

    def __post_init__(self):
        if self.domains < 1:
            raise ValueError(f"domains must be >= 1, got {self.domains}")
        if self.async_n < 1:
            raise ValueError(f"async_n must be >= 1, got {self.async_n}")
        if self.max_migration % self.async_n != 0:
            raise ValueError(
                f"async_n ({self.async_n}) must divide max_migration "
                f"({self.max_migration}) so every queue gets an equal "
                f"send budget")
        if (self.pic.ionization is not None
                and self.max_births % self.async_n != 0):
            raise ValueError(
                f"async_n ({self.async_n}) must divide max_births "
                f"({self.max_births}) so every queue gets an equal "
                f"birth budget")
        if self.rebalance_every < 0:
            raise ValueError(
                f"rebalance_every must be >= 0, got {self.rebalance_every}")
        if self.rebalance_skew < 0:
            raise ValueError(
                f"rebalance_skew must be >= 0, got {self.rebalance_skew}")

    def num_domains(self) -> int:
        return self.domains

    def local_nc(self) -> int:
        if self.pic.nc % self.domains != 0:
            raise ValueError(f"domains ({self.domains}) must divide nc "
                             f"({self.pic.nc})")
        return self.pic.nc // self.domains

    def local_cap(self, sc) -> int:
        if self.species_capacity_local is not None:
            return self.species_capacity_local
        if sc.capacity % self.domains != 0:
            raise ValueError(f"domains ({self.domains}) must divide the "
                             f"capacity ({sc.capacity}) of {sc.name!r}")
        return sc.capacity // self.domains

    @property
    def queue_migration(self) -> int:
        return self.max_migration // self.async_n

    @property
    def queue_births(self) -> int:
        return self.max_births // self.async_n


@dataclasses.dataclass
class PendingArrivals:
    """Rows received or born this step, scattered into their pre-claimed
    slots at the NEXT step's ingest; (D, S, M) per capacity group. ``dest``
    is the claimed dead slot of an accepted row, the local capacity (a
    drop) otherwise. The diagnostics count pending rows as resident."""

    x: torch.Tensor      # (D, S, M)
    v: torch.Tensor      # (D, S, M, 3)
    w: torch.Tensor      # (D, S, M)
    alive: torch.Tensor  # (D, S, M) bool: accepted rows
    dest: torch.Tensor   # (D, S, M) int32


@dataclasses.dataclass
class EngineState:
    """The engine's state. ``groups`` holds one (D, S, cap_l) stack per
    capacity group (``group_species`` its species indices), ``gens`` one
    generator per domain, ``rho`` the carried (D, ncl + 1) charge (None
    unless carried), ``rings``/``pending`` one entry per group, batched
    over (D, S) (empty in the legacy mode)."""

    groups: tuple[StackedSpecies, ...]
    group_species: tuple[tuple[int, ...], ...]
    gens: tuple[torch.Generator, ...]
    step: int
    rho: torch.Tensor | None
    rings: tuple[FreeSlotRing, ...]
    pending: tuple[PendingArrivals, ...]

    @property
    def species(self) -> tuple[SpeciesBuffer, ...]:
        """Per-species (D, cap_l) views, in config order."""
        out = {}
        for st, idxs in zip(self.groups, self.group_species):
            for j, i in enumerate(idxs):
                out[i] = SpeciesBuffer(x=st.x[:, j], v=st.v[:, j],
                                       w=st.w[:, j], alive=st.alive[:, j])
        return tuple(out[i] for i in sorted(out))


def _carries_rho(ecfg: EngineConfig) -> bool:
    """The single-domain cycle's rule for an exact carried deposit."""
    return pic_carries_rho(ecfg.pic)


def _see_pairs(cfg: PICConfig) -> tuple[tuple[int, int], ...]:
    """Active (primary, target) wall-emission pairs (absorbing walls)."""
    if cfg.wall_emission and cfg.boundary == "absorb":
        return tuple(cfg.wall_emission)
    return ()


def _capacity_groups(ecfg: EngineConfig) -> list[tuple[int, ...]]:
    """Species indices grouped by equal local capacity: each group is one
    (S, cap_l) stack and one set of queues."""
    by_cap: dict[int, list[int]] = {}
    for i, sc in enumerate(ecfg.pic.species):
        by_cap.setdefault(ecfg.local_cap(sc), []).append(i)
    return [tuple(v) for v in by_cap.values()]


def _species_location(groups) -> dict[int, tuple[int, int]]:
    """species index -> (capacity group, row within the group's stack)."""
    return {i: (g, j)
            for g, idxs in enumerate(groups) for j, i in enumerate(idxs)}


def _group_pending_rows(ecfg: EngineConfig, groups) -> list[int]:
    """Pending rows per group: 2 directions x the migration budget, plus
    the group's ionization block (one shared block when electron and ion
    stack together) and its SEE blocks."""
    cfg = ecfg.pic
    rows = [2 * ecfg.max_migration] * len(groups)
    loc = _species_location(groups)
    if cfg.ionization is not None:
        _, ei, ii = cfg.ionization
        for g in {loc[ei][0], loc[ii][0]}:
            rows[g] += ecfg.max_births
    for _, t in _see_pairs(cfg):
        rows[loc[t][0]] += 2 * ecfg.max_migration
    return rows


def _map(st, fn):
    """Apply ``fn`` to every tensor field of a dataclass."""
    return dataclasses.replace(st, **{f.name: fn(getattr(st, f.name))
                                      for f in dataclasses.fields(st)})


def _queue_slice(st: StackedSpecies, n: int, k: int) -> StackedSpecies:
    """Queue k of an (S, cap) stack (slot c -> queue c % n), gathered to a
    contiguous (S, cap / n) buffer; the stack itself when n == 1."""
    if n == 1:
        return st

    def part(a):
        s, cap = a.shape[:2]
        return a.reshape((s, cap // n, n) + tuple(a.shape[2:]))[:, :, k] \
            .contiguous()

    return _map(st, part)


def _split_queues(st: StackedSpecies, n: int) -> list[StackedSpecies]:
    """Interleaved queue slices of an (S, cap) stack: slot c -> queue
    c % n (keeps a compacted live block evenly spread over the queues)."""
    return [_queue_slice(st, n, k) for k in range(n)]


def _merge_queues(queues: list, n: int, out=None):
    """Inverse of ``_split_queues``; writes into ``out`` (same layout as
    the merged result) when given."""
    if out is None:
        if n == 1:
            return queues[0]
        out = _map(queues[0], lambda a: a.new_empty(
            (a.shape[0], a.shape[1] * n) + tuple(a.shape[2:])))
    for k, q in enumerate(queues):
        for f in dataclasses.fields(q):
            a = getattr(out, f.name)
            s, cap = a.shape[:2]
            a.reshape((s, cap // n, n) + tuple(a.shape[2:]))[:, :, k].copy_(
                getattr(q, f.name))
    return out


def _queue_occupancy(alive: torch.Tensor, n: int) -> torch.Tensor:
    """(..., cap) alive -> (..., n) per-queue alive counts."""
    return alive.reshape(alive.shape[:-1] + (-1, n)).sum(-2,
                                                         dtype=torch.int32)


def _take_rows(st: StackedSpecies, idx: torch.Tensor) -> StackedSpecies:
    """Gather rows ``idx`` (S, M) of an (S, cap) stack; an index equal to
    the capacity gives a dead, zeroed row (``particles.take`` batched)."""
    cap = st.x.shape[1]
    valid = idx < cap
    ic = idx.clamp(0, cap - 1)
    return StackedSpecies(
        x=st.x.gather(1, ic) * valid,
        v=st.v.gather(1, ic[..., None].expand(-1, -1, 3)) * valid[..., None],
        w=st.w.gather(1, ic) * valid,
        alive=st.alive.gather(1, ic) & valid)


def _exchange_queue(q: StackedSpecies, l_local: float, m: int,
                    boundary: str, is_first: bool, is_last: bool, top: float):
    """Pack one queue's boundary crossers, over the species axis.

    Returns (kept, pack_l, pack_r, leaver_x, leaver_w, freed_idx, freed_ok,
    absorbed_l, absorbed_r, diag) as the reference's: the fixed-size send
    packs in the receiver's frame, the leavers' raw positions and weights
    (for the carried-rho subtraction), the queue-local slots they freed,
    the packed rows absorbed at a global wall. Crossers beyond the pack or
    the per-direction budget stay, clamped just inside the slab."""
    x, alive = q.x, q.alive
    cap = x.shape[1]
    leave = alive & ((x < 0.0) | (x >= l_local))
    idx = nonzero_static(leave, 2 * m, cap)
    packed = _take_rows(q, idx)
    went_l = packed.alive & (packed.x < 0.0)
    went_r = packed.alive & (packed.x >= l_local)
    ok_l = went_l & (torch.cumsum(went_l, -1) - 1 < m)
    ok_r = went_r & (torch.cumsum(went_r, -1) - 1 < m)
    ok = ok_l | ok_r
    gone = torch.zeros(x.shape[0], cap + 1, dtype=torch.bool,
                       device=x.device)
    gone.scatter_(1, idx, ok)
    gone = gone[:, :cap]
    kept = kill(SpeciesBuffer(x=x, v=q.v, w=q.w, alive=alive), gone)
    stay = leave & ~gone
    kept_x = torch.where(stay, x.clamp(0.0, top), x)
    kept = StackedSpecies(x=kept_x, v=q.v, w=kept.w, alive=kept.alive)
    if boundary == "absorb":             # the global walls absorb
        abs_l = ok_l & is_first
        abs_r = ok_r & is_last
    else:                                # periodic: the ring wraps
        abs_l = torch.zeros_like(ok_l)
        abs_r = torch.zeros_like(ok_r)
    absorb = abs_l | abs_r
    send_l = ok_l & ~absorb
    send_r = ok_r & ~absorb
    pack_l = _take_rows(packed, nonzero_static(send_l, m, 2 * m))
    pack_r = _take_rows(packed, nonzero_static(send_r, m, 2 * m))
    pack_l = dataclasses.replace(pack_l, x=pack_l.x + l_local)
    pack_r = dataclasses.replace(pack_r, x=pack_r.x - l_local)
    diag = {
        "migrated_left": send_l.sum(-1, dtype=torch.int32),
        "migrated_right": send_r.sum(-1, dtype=torch.int32),
        "migration_overflow": stay.sum(-1, dtype=torch.int32),
        "wall_absorbed": absorb.sum(-1, dtype=torch.int32),
    }
    return (kept, pack_l, pack_r, packed.x, packed.w * ok, idx, ok, abs_l,
            abs_r, diag)


def _flush_pending(st: StackedSpecies, p: PendingArrivals, *,
                   inplace: bool) -> StackedSpecies:
    """Scatter pre-claimed rows into their slots: (D, S, cap) stacks,
    (D, S, M) pending. The slots were dead when claimed, so this is exact."""
    if not inplace:
        st = _map(st, torch.clone)
    d, s, cap = st.x.shape
    base = (torch.arange(d * s, device=st.x.device) * cap).reshape(d, s, 1)
    ok = p.alive & (p.dest < cap)
    flat = base + p.dest.long().clamp(max=cap - 1)
    put_rows_(st.x.view(-1), flat, p.x, ok)
    put_rows_(st.v.view(-1, 3), flat, p.v, ok)
    put_rows_(st.w.view(-1), flat, p.w, ok)
    put_rows_(st.alive.view(-1), flat, torch.ones_like(ok), ok)
    return st


def _empty_pending(d: int, s: int, m: int, cap: int, device,
                   dtype=torch.float32) -> PendingArrivals:
    return PendingArrivals(
        x=torch.zeros(d, s, m, dtype=dtype, device=device),
        v=torch.zeros(d, s, m, 3, dtype=dtype, device=device),
        w=torch.zeros(d, s, m, dtype=dtype, device=device),
        alive=torch.zeros(d, s, m, dtype=torch.bool, device=device),
        dest=torch.full((d, s, m), cap, dtype=torch.int32, device=device))


def _birth_block(s: int, nb: int, cap: int, device, rows: dict
                 ) -> PendingArrivals:
    """One (S, nb) pending block of one domain whose live rows are MC
    births: ``rows`` maps a species row j to (x, v, w, ok, dest); other
    rows stay dead. ``dest=None`` (legacy mode) leaves the drop value."""
    f32 = torch.float32
    b = PendingArrivals(
        x=torch.zeros(s, nb, dtype=f32, device=device),
        v=torch.zeros(s, nb, 3, dtype=f32, device=device),
        w=torch.zeros(s, nb, dtype=f32, device=device),
        alive=torch.zeros(s, nb, dtype=torch.bool, device=device),
        dest=torch.full((s, nb), cap, dtype=torch.int32, device=device))
    for j, (x, v, w, ok, dest) in rows.items():
        ok = ok.bool()
        b.x[j] = x
        b.v[j] = v
        b.w[j] = w * ok
        b.alive[j] = ok
        if dest is not None:
            b.dest[j] = dest
    return b


def _ring_row(ring: FreeSlotRing, r: int) -> FreeSlotRing:
    return FreeSlotRing(slots=ring.slots[r], head=ring.head[r],
                        count=ring.count[r])


def _claim_rows(ring: FreeSlotRing, want_rows: dict, cap: int,
                budget: torch.Tensor | None = None):
    """Claim slots from one domain's (S, R) group ring for the species
    rows of ``want_rows`` (row j -> (M,) mask); ``budget`` caps every
    row's grants. Returns (ring, dest (S, M), ok (S, M))."""
    s = ring.count.shape[0]
    m = next(iter(want_rows.values())).shape[0]
    want = torch.zeros(s, m, dtype=torch.bool, device=ring.slots.device)
    for j, wv in want_rows.items():
        want[j] = wv.bool()
    bud = None if budget is None else budget.expand(s)
    return ring_claim(ring, want, cap, bud)


def _push_rows(ring: FreeSlotRing, idx_rows: dict, m: int) -> FreeSlotRing:
    """Push freed slots into one domain's (S, R) group ring for the rows
    of ``idx_rows`` (row j -> (idx (M,), ok (M,)))."""
    s = ring.count.shape[0]
    dev = ring.slots.device
    idx = torch.zeros(s, m, dtype=torch.int32, device=dev)
    okm = torch.zeros(s, m, dtype=torch.bool, device=dev)
    for j, (iv, ov) in idx_rows.items():
        idx[j] = iv.to(torch.int32)
        okm[j] = ov.bool()
    return ring_push(ring, idx, okm)


def _compact_group(st: StackedSpecies
                   ) -> tuple[StackedSpecies, torch.Tensor]:
    """Stable per-species compaction (alive first) of a domain's (S, cap)
    group: its interleaved queue split is occupancy-even. Returns the
    group and its (S,) alive counts."""
    order = torch.sort((~st.alive).to(torch.uint8), dim=-1,
                       stable=True).indices
    out = _reorder(st, order)
    return out, out.alive.sum(-1, dtype=torch.int32)


def _cellsort_group(st: StackedSpecies, dx: float, nc: int
                    ) -> tuple[StackedSpecies, torch.Tensor]:
    """Per-species stable sort by cell, dead rows at the tail
    (``particles.sort_by_cell`` over the species axis): also a valid
    compaction. Returns the group and its (S,) alive counts."""
    key = cell_index(SpeciesBuffer(x=st.x, v=st.v, w=st.w, alive=st.alive),
                     dx, nc)
    out = _reorder(st, torch.sort(key, dim=-1, stable=True).indices)
    return out, out.alive.sum(-1, dtype=torch.int32)


def _reorder(st: StackedSpecies, order: torch.Tensor) -> StackedSpecies:
    return StackedSpecies(
        x=st.x.gather(1, order),
        v=st.v.gather(1, order[..., None].expand(-1, -1, 3)),
        w=st.w.gather(1, order), alive=st.alive.gather(1, order))


def _group_consts(cfg: PICConfig, idxs, device):
    """(S,) float32 q/m, dt*stride and charge of a group, on ``device``."""
    scs = [cfg.species[i] for i in idxs]
    f32 = torch.float32
    return (torch.tensor([sc.charge / sc.mass for sc in scs], dtype=f32,
                         device=device),
            torch.tensor([cfg.dt * sc.stride for sc in scs], dtype=f32,
                         device=device),
            torch.tensor([sc.charge for sc in scs], dtype=f32,
                         device=device))


def make_engine_step(ecfg: EngineConfig, *, upto: str = "full",
                     donate: bool = True, with_params: bool = False):
    """Build the async(n) step: ``step(state, draws=None) -> (state,
    diag)`` with ``upto='full'``; an earlier ``upto`` builds a probe that
    runs through that phase and returns ``(state, aux)`` (see ``PHASES``).
    The full step donates its input state unless ``donate=False``; the
    probes never do.

    ``draws`` (optional) replaces the per-domain generators: one dict per
    domain with ``"ionize"`` (per queue, the ``ionization_events`` arrays
    of the queue's neutral slice), ``"see"`` (per wall-emission pair, per
    queue, the ``emission_candidates`` arrays of the queue's pack) and
    ``"collide"`` (per queue, a dict group -> the menu draws of the
    group's entries), as the reference derives them from its keys.
    """
    if with_params:
        raise NotImplementedError(
            "with_params (runtime parameters) is not ported yet: "
            + _ROADMAP.format(5))
    if upto not in PHASES:
        raise ValueError(f"upto must be one of {PHASES}, got {upto!r}")
    cfg = ecfg.pic
    d = ecfg.num_domains()
    ncl = ecfg.local_nc()
    ngl = ncl + 1
    grid_local = Grid1D(nc=ncl, dx=cfg.dx)
    l_local = ncl * cfg.dx
    top = float(np.nextafter(np.float32(l_local), np.float32(0.0)))
    n_q = ecfg.async_n
    m_q = ecfg.queue_migration
    ion = cfg.ionization
    b_q = ecfg.queue_births if ion is not None else 0
    carried = _carries_rho(ecfg)
    use_ring = ecfg.use_ring
    reb_k = ecfg.rebalance_every
    skew_k = ecfg.rebalance_skew
    groups = _capacity_groups(ecfg)
    loc = _species_location(groups)
    prows = _group_pending_rows(ecfg, groups)
    group_caps = [ecfg.local_cap(cfg.species[idxs[0]]) for idxs in groups]
    see_pairs = _see_pairs(cfg)
    coll = tuple(cfg.collisions)
    for sc in cfg.species:
        cap_l = ecfg.local_cap(sc)
        if cap_l % n_q != 0:
            raise ValueError(
                f"async_n ({n_q}) must divide the local capacity ({cap_l}) "
                f"of species {sc.name!r}")
    for cc in coll:
        parts = collisions.involved_species([cc])
        if len({loc[i][0] for i in parts}) != 1:
            names = [cfg.species[i].name for i in parts]
            raise ValueError(
                f"collision {cc.kind!r} pairs species {names} across "
                f"capacity groups; give them equal capacities to run on "
                f"the engine")
    iparams = (collisions.IonizationParams(
        rate=cfg.ionization_rate, vth_electron=cfg.ionization_vth_e)
        if ion is not None else None)
    eparams = (boundaries.EmissionParams(
        yield_=cfg.emission_yield, vth_emit=cfg.emission_vth,
        weight=cfg.emission_weight) if see_pairs else None)
    strides = [sc.stride for sc in cfg.species]
    consts: dict = {}          # device -> per-group (qm, dts, charges)
    streams: dict = {}         # device -> {(domain, queue): stream}

    def step(state: EngineState, draws=None):
        dev = state.groups[0].x.device
        card = dev.type == "cuda"
        if dev not in consts:
            consts[dev] = [_group_consts(cfg, idxs, dev) for idxs in groups]
            if card:
                streams[dev] = {(r, k): torch.cuda.Stream(dev)
                                for r in range(d) for k in range(n_q)}
        gconsts = consts[dev]

        def on(r, k):
            return (torch.cuda.stream(streams[dev][(r, k)]) if card
                    else contextlib.nullcontext())

        def record():
            if not card:
                return None
            ev = torch.cuda.Event()
            ev.record()
            return ev

        def wait(ev):
            if ev is not None:
                torch.cuda.current_stream(dev).wait_event(ev)

        sts = list(state.groups)
        rings = list(state.rings)
        pend_in = list(state.pending)
        step_i = state.step
        inplace = donate and upto == "full"

        def pack_state(rho, pend):
            return EngineState(groups=tuple(sts),
                               group_species=tuple(groups), gens=state.gens,
                               step=step_i + 1, rho=rho, rings=tuple(rings),
                               pending=tuple(pend))

        # ---- ingest: land last step's arrivals and births in their
        #      pre-claimed slots, then compact the domains that are due ----
        with record_function("engine/ingest"):
            due = [None] * len(groups)
            for g in range(len(groups)):
                if use_ring:
                    sts[g] = _flush_pending(sts[g], pend_in[g],
                                            inplace=inplace)
                elif not inplace and (reb_k > 0 or skew_k > 0):
                    sts[g] = _map(sts[g], torch.clone)
                if reb_k > 0 and step_i > 0 and step_i % reb_k == 0:
                    due[g] = [True] * d
            if skew_k > 0 and step_i > 0:
                occ = [_queue_occupancy(st.alive, n_q) for st in sts]
                skews = torch.stack([(o.max(-1).values - o.min(-1).values)
                                     .amax(-1) for o in occ])
                over = (skews > skew_k).tolist()   # the one host read
                due = [over[g] if due[g] is None
                       else [a or b for a, b in zip(due[g], over[g])]
                       for g in range(len(groups))]
            for g in range(len(groups)):
                if due[g] is None or not any(due[g]):
                    continue
                st, cap_g = sts[g], group_caps[g]
                counts = None
                for r in range(d):
                    if not due[g][r]:
                        continue
                    row = _map(st, lambda a, r=r: a[r])
                    new, alive_counts = (
                        _cellsort_group(row, cfg.dx, ncl) if ecfg.cell_order
                        else _compact_group(row))
                    for f in dataclasses.fields(new):
                        getattr(st, f.name)[r] = getattr(new, f.name)
                    if use_ring:
                        if counts is None:
                            rings[g] = FreeSlotRing(
                                slots=rings[g].slots.clone(),
                                head=rings[g].head.clone(),
                                count=rings[g].count.clone())
                            counts = True
                        fresh = ring_from_counts(alive_counts, cap_g)
                        rings[g].slots[r] = fresh.slots
                        rings[g].head[r] = fresh.head
                        rings[g].count[r] = fresh.count
        empty_pend = ([_empty_pending(d, len(idxs), prows[g], group_caps[g],
                                      dev)
                       for g, idxs in enumerate(groups)] if use_ring else [])
        if upto == "ingest":
            aux = sum(st.alive.sum((1, 2)).float() for st in sts)
            return pack_state(state.rho, empty_pend), aux

        # ---- field: halo exchange of edge nodes and scalars only ----
        with record_function("engine/field"):
            if not cfg.field_solve:
                e = torch.zeros(d, ngl, dtype=torch.float32, device=dev)
            else:
                if carried and state.rho is not None:
                    rho_local = state.rho
                else:
                    rho_local = torch.stack([
                        sum(deposit_stacked(grid_local, st.x[r], st.w[r],
                                            st.alive[r], gconsts[g][2])
                            for g, st in enumerate(sts))
                        for r in range(d)])
                e = halo.field_phase(rho_local, dx=cfg.dx, eps0=cfg.eps0,
                                     smoothing_passes=cfg.smoothing_passes)
        if upto == "field":
            return pack_state(state.rho, empty_pend), e

        # ---- sources: the electron density of each domain (halo-summed
        #      at the shared nodes) and the collision densities ----
        ne = coll_dens = None
        with record_function("engine/sources"):
            if ion is not None:
                ge, je = loc[ion[1]]
                st = sts[ge]
                ne = halo.halo_sum(torch.stack([
                    deposit_windowed(grid_local, st.x[r, je],
                                     st.w[r, je] * st.alive[r, je])
                    for r in range(d)]))
        if coll:
            with record_function("engine/collide_setup"):
                coll_dens = [{
                    i: collisions.cell_density(grid_local, SpeciesBuffer(
                        x=sts[loc[i][0]].x[r, loc[i][1]],
                        v=sts[loc[i][0]].v[r, loc[i][1]],
                        w=sts[loc[i][0]].w[r, loc[i][1]],
                        alive=sts[loc[i][0]].alive[r, loc[i][1]]))
                    for i in collisions.density_species(coll)}
                    for r in range(d)]

        # receive buffers of the migration packs: (D, S, n_q, 2, m_q) per
        # group, [.., k, 0] from the left neighbour, [.., k, 1] from the
        # right, so a domain's rows read as the reference's concatenation
        # (q0 left, q0 right, q1 left, ...)
        recv = [StackedSpecies(
            x=torch.zeros(d, len(idxs), n_q, 2, m_q, device=dev),
            v=torch.zeros(d, len(idxs), n_q, 2, m_q, 3, device=dev),
            w=torch.zeros(d, len(idxs), n_q, 2, m_q, device=dev),
            alive=torch.zeros(d, len(idxs), n_q, 2, m_q, dtype=torch.bool,
                              device=dev)) for idxs in groups]
        contrib: list[tuple[str, torch.Tensor]] = []
        kept = [[[None] * n_q for _ in range(d)] for _ in groups]
        births = [[[] for _ in range(d)] for _ in groups]
        # each domain's own ring rows and carried rho: a domain's chain of
        # queues updates only these, so no stream reads another domain's
        rrows = [[_ring_row(rg, r) for r in range(d)] for rg in rings]
        rho_acc = [torch.zeros(ngl, dtype=torch.float32, device=dev)
                   if carried else None for _ in range(d)]
        done = []              # each queue's last event
        keep = []              # tensors read across streams: held to the end
        ready = record()       # every input of the queues is on main

        def dacc(name, k, v):
            contrib.append((f"{name}/{k}" if name else k, v))

        # ---- async(n) pipeline, domain by domain: queue k's push, collide,
        #      ionization and packing run on its own stream; its ring and
        #      rho updates wait for queue k-1's ----
        for r in range(d):
            chain = None
            gen = state.gens[r]
            dr = None if draws is None else draws[r]
            for g, idxs in enumerate(groups):
                qm, dts, charges = gconsts[g]
                st = _map(sts[g], lambda a, r=r: a[r])
                for k in range(n_q):
                    with on(r, k):
                        wait(ready)
                        q = _queue_slice(st, n_q, k)
                        with record_function(f"engine/push/q{k}"):
                            out, _, _, pdiag, rho_k = mover.push_stacked(
                                q, e[r], grid_local, qm, dts, b=cfg.b_field,
                                boundary="open", gather_mode=cfg.gather_mode,
                                charges=charges if carried else None)
                            if any(strides[i] > 1 for i in idxs):
                                do = torch.tensor(
                                    [step_i % strides[i] == 0 for i in idxs],
                                    device=dev)
                                out = StackedSpecies(*(
                                    torch.where(do.reshape(
                                        (-1,) + (1,) * (getattr(out, f)
                                                        .dim() - 1)),
                                        getattr(out, f), getattr(q, f))
                                    for f in ("x", "v", "w", "alive")))
                                pdiag = {n: torch.where(do, v, 0)
                                         for n, v in pdiag.items()}
                            for j, i in enumerate(idxs):
                                for n_, v in pdiag.items():
                                    dacc(cfg.species[i].name, n_, v[j])
                        if upto == "push":
                            kept[g][r][k] = out
                            if carried:
                                wait(chain)
                                rho_acc[r] = rho_acc[r] + rho_k
                                keep.append(rho_acc[r])
                                chain = record()
                            done.append(record())
                            continue

                        # ---- binary collisions on this queue ----
                        g_coll = [cc for cc in coll
                                  if loc[cc.species][0] == g]
                        if g_coll:
                            with record_function(f"engine/collide/q{k}"):
                                rows_c = collisions.involved_species(g_coll)
                                cbufs = {i: SpeciesBuffer(
                                    x=out.x[idxs.index(i)],
                                    v=out.v[idxs.index(i)],
                                    w=out.w[idxs.index(i)],
                                    alive=out.alive[idxs.index(i)])
                                    for i in rows_c}
                                cdraws = (None if dr is None
                                          else dr["collide"][k][g])
                                cbufs, cdiag = collisions.apply_menu(
                                    gen, cbufs, g_coll, coll_dens[r],
                                    grid_local, cfg.dt, cfg.collide_kernel,
                                    cdraws)
                                for i, cb in cbufs.items():
                                    out.v[idxs.index(i)] = cb.v
                                for ck, cv in cdiag.items():
                                    dacc(None, ck, cv)
                        if upto == "collide":
                            kept[g][r][k] = out
                            if carried:
                                wait(chain)
                                rho_acc[r] = rho_acc[r] + rho_k
                                keep.append(rho_acc[r])
                                chain = record()
                            done.append(record())
                            continue

                        # ---- MC ionization: events and the packed rows
                        #      (the kills wait for the ring) ----
                        pack = None
                        if ion is not None and ion[0] in idxs:
                            with record_function(f"engine/ionize/q{k}"):
                                jn = idxs.index(ion[0])
                                qn = SpeciesBuffer(
                                    x=out.x[jn], v=out.v[jn], w=out.w[jn],
                                    alive=out.alive[jn])
                                pack = collisions.ionize_packed(
                                    gen, qn, grid_local, iparams, cfg.dt,
                                    ne[r], b_q,
                                    None if dr is None else dr["ionize"][k])

                        # ---- migration packs (the crossers are outside
                        #      the slab, so no ionized neutral is one) ----
                        with record_function(f"engine/migrate/q{k}"):
                            (kq, pack_l, pack_r, lv_x, lv_w, free_idx,
                             free_ok, abs_l, abs_r, dmig) = _exchange_queue(
                                out, l_local, m_q, cfg.boundary, r == 0,
                                r == d - 1, top)
                            lv_rho = (deposit_windowed(
                                grid_local, lv_x, charges[:, None] * lv_w)
                                if carried else None)
                            # the copies to the neighbours, on this stream
                            halo.send(recv[g], ((r + 1) % d, slice(None), k,
                                                0), pack_r)
                            halo.send(recv[g], ((r - 1) % d, slice(None), k,
                                                1), pack_l)
                            for j, i in enumerate(idxs):
                                for n_, v in dmig.items():
                                    dacc(cfg.species[i].name, n_, v[j])

                        # ---- ring and rho updates, in queue order ----
                        wait(chain)
                        keep.append([rr[r] for rr in rrows])
                        if pack is not None:
                            kq = _ionize_rows(
                                kq, pack, idxs, g, k, r, rrows, births,
                                use_ring, loc, groups, group_caps, n_q, b_q,
                                ion, dacc, dev)
                        if use_ring:
                            rrows[g][r] = ring_push(
                                rrows[g][r], free_idx * n_q + k, free_ok)
                        for pi, (p_, t_) in enumerate(see_pairs):
                            if p_ not in idxs:
                                continue
                            with record_function(f"engine/see/q{k}"):
                                jp = idxs.index(p_)
                                emit, ex, ev, ew = \
                                    boundaries.emission_candidates(
                                        gen, abs_l[jp], abs_r[jp], eparams,
                                        l_local, torch.float32,
                                        None if dr is None
                                        else dr["see"][pi][k])
                                gt, jt = loc[t_]
                                if use_ring:
                                    rrows[gt][r], dstm, okm = _claim_rows(
                                        rrows[gt][r], {jt: emit},
                                        group_caps[gt])
                                    ok_t, dest_t = okm[jt], dstm[jt]
                                else:
                                    ok_t, dest_t = emit, None
                                births[gt][r].append(_birth_block(
                                    len(groups[gt]), 2 * m_q, group_caps[gt],
                                    dev, {jt: (ex, ev, ew, ok_t, dest_t)}))
                                name = cfg.species[t_].name
                                dacc(name, "emitted",
                                     ok_t.sum(dtype=torch.int32))
                                dacc(name, "emission_overflow",
                                     (emit & ~ok_t).sum(dtype=torch.int32))
                        if carried:
                            rho_acc[r] = (rho_acc[r] + rho_k) - lv_rho
                            keep.append(rho_acc[r])
                        kept[g][r][k] = kq
                        chain = record()
                        done.append(chain)
                    keep.append(st)

        # ---- the merge waits for every queue (depend(in)) ----
        for ev in done:
            wait(ev)
        rings = [FreeSlotRing(slots=rg.slots,
                              head=torch.stack([rr.head for rr in rows]),
                              count=torch.stack([rr.count for rr in rows]))
                 for rg, rows in zip(rings, rrows)]
        if upto in ("push", "collide", "migrate"):
            for g in range(len(groups)):
                sts[g] = _merged(sts[g], kept[g], n_q)
            rho_out = torch.stack(rho_acc) if carried else state.rho
            return pack_state(rho_out, empty_pend), e

        pend_out = list(empty_pend)
        with record_function("engine/merge"):
            for g, idxs in enumerate(groups):
                charges = gconsts[g][2]
                cap_g = group_caps[g]
                full = _merged(sts[g], kept[g], n_q)
                s = len(idxs)
                cand = _map(recv[g], lambda a: a.reshape(
                    (d, s, 2 * ecfg.max_migration) + tuple(a.shape[5:])))
                blocks = [PendingArrivals(*(
                    torch.stack([torch.cat([getattr(b, f) for b in
                                            births[g][r]], 1)
                                 for r in range(d)])
                    for f in ("x", "v", "w", "alive", "dest")))] \
                    if births[g][0] else []
                if use_ring:
                    rings[g], dest, accepted = ring_claim(
                        rings[g], cand.alive, cap_g)
                    pend_g = PendingArrivals(
                        x=cand.x, v=cand.v, w=cand.w * accepted,
                        alive=cand.alive & accepted, dest=dest)
                    if blocks:
                        pend_g = PendingArrivals(*(
                            torch.cat([getattr(pend_g, f),
                                       getattr(blocks[0], f)], 2)
                            for f in ("x", "v", "w", "alive", "dest")))
                    pend_out[g] = pend_g
                    dropped = (cand.alive & ~accepted).sum(
                        -1, dtype=torch.int32)
                    sts[g] = full
                    dep_rows = pend_g
                    dep_w = pend_g.w * pend_g.alive
                else:
                    cand_all = cand if not blocks else StackedSpecies(*(
                        torch.cat([getattr(cand, f), getattr(blocks[0], f)],
                                  2) for f in ("x", "v", "w", "alive")))
                    merged, dropped, accepted = _inject_rows(full, cand_all)
                    sts[g] = merged
                    dep_rows = cand_all
                    dep_w = cand_all.w * accepted
                if carried:
                    for r in range(d):
                        rho_acc[r] = rho_acc[r] + deposit_windowed(
                            grid_local, dep_rows.x[r],
                            charges[:, None] * dep_w[r])
                for j, i in enumerate(idxs):
                    dacc(cfg.species[i].name, "merge_dropped",
                         dropped[:, j].sum())
        rho_out = torch.stack(rho_acc) if carried else state.rho
        if upto == "merge":
            return pack_state(rho_out, pend_out), e

        # ---- diagnostics over the resident rows plus the pending ones ----
        with record_function("engine/diag"):
            diag: dict = {}
            for key, v in contrib:
                diag[key] = diag[key] + v if key in diag else v
            for i, sc in enumerate(cfg.species):
                g, j = loc[i]
                st = sts[g]
                alive, w, v = st.alive[:, j], st.w[:, j], st.v[:, j]
                count = alive.sum(dtype=torch.int32)
                wsum = _sum64(alive, w)
                ke = _sum64(alive, (v * v).sum(-1) * w)
                occ = _queue_occupancy(alive, n_q)          # (D, n_q)
                if use_ring:
                    p = pend_out[g]
                    pa = p.alive[:, j]
                    count = count + pa.sum(dtype=torch.int32)
                    wsum = wsum + _sum64(pa, p.w[:, j])
                    ke = ke + _sum64(pa, (p.v[:, j] * p.v[:, j]).sum(-1)
                                     * p.w[:, j])
                    q_of = torch.where(pa, p.dest[:, j].long() % n_q, n_q)
                    hist = torch.zeros(d, n_q + 1, dtype=torch.int32,
                                       device=dev)
                    hist.scatter_add_(1, q_of, torch.ones_like(
                        q_of, dtype=torch.int32))
                    occ = occ + hist[:, :n_q]
                diag[f"{sc.name}/count"] = count
                diag[f"{sc.name}/ke"] = 0.5 * sc.mass * ke
                diag[f"{sc.name}/charge"] = sc.charge * wsum
                diag[f"{sc.name}/queue_occ"] = occ.sum(0)
                diag[f"{sc.name}/queue_skew"] = (occ.max(-1).values
                                                 - occ.min(-1).values).max()
                if ecfg.metrics and use_ring:
                    diag[f"{sc.name}/ring_free"] = rings[g].count[:, j].sum()
                    diag[f"{sc.name}/pending_rows"] = pend_out[g].alive[
                        :, j].sum(dtype=torch.int32)
        return pack_state(rho_out, pend_out), diag

    return step


def _sum64(mask: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Sum of the float32 ``a`` where ``mask``, accumulated in float64:
    exact for a sum of equal weights, whatever the split into domains."""
    return torch.where(mask, a, 0.0).sum(dtype=torch.float64)


def _merged(st_in: StackedSpecies, kept_g, n_q: int) -> StackedSpecies:
    """The (D, S, cap) stack of every domain's merged queues (one domain's
    single queue as it is)."""
    if len(kept_g) == 1 and n_q == 1:
        return _map(kept_g[0][0], lambda a: a[None])
    out = _map(st_in, torch.empty_like)
    for r, qs in enumerate(kept_g):
        _merge_queues(qs, n_q, _map(out, lambda a, r=r: a[r]))
    return out


def _inject_rows(full: StackedSpecies, cand: StackedSpecies):
    """The legacy merge (``use_ring=False``): a full-scan
    ``inject_masked`` per domain and species. Returns (stack, dropped
    (D, S), accepted (D, S, M))."""
    d, s = full.x.shape[:2]
    out = _map(full, torch.clone)
    dropped = torch.zeros(d, s, dtype=torch.int32, device=full.x.device)
    accepted = torch.zeros_like(cand.alive)
    for r in range(d):
        for j in range(s):
            buf, n_drop, ok = inject_masked(
                SpeciesBuffer(x=full.x[r, j], v=full.v[r, j],
                              w=full.w[r, j], alive=full.alive[r, j]),
                cand.x[r, j], cand.v[r, j], cand.w[r, j], cand.alive[r, j])
            out.x[r, j], out.v[r, j] = buf.x, buf.v
            out.w[r, j], out.alive[r, j] = buf.w, buf.alive
            dropped[r, j] = n_drop
            accepted[r, j] = ok
    return out, dropped, accepted


def _ionize_rows(kq, pack, idxs, g, k, r, rrows, births, use_ring, loc,
                 groups, group_caps, n_q, b_q, ion, dacc, dev):
    """One queue's ionization after its ring turn: claim an electron and
    an ion slot per birth under the shared min-count budget (a birth gets
    both or neither), push the freed neutral slots, kill the neutrals and
    hold the births as pending blocks. Returns the queue's stack."""
    ni, ei, ii = ion
    jn = idxs.index(ni)
    (ge, je), (gi, ji) = loc[ei], loc[ii]
    if use_ring:
        avail = torch.minimum(rrows[ge][r].count[je], rrows[gi][r].count[ji])
        if ge == gi:
            rrows[ge][r], dest, okm = _claim_rows(
                rrows[ge][r], {je: pack.ok, ji: pack.ok}, group_caps[ge],
                avail)
            allowed = okm[je]
            dest_e, dest_i = dest[je], dest[ji]
        else:
            rrows[ge][r], de, oe = _claim_rows(
                rrows[ge][r], {je: pack.ok}, group_caps[ge], avail)
            rrows[gi][r], di, _ = _claim_rows(
                rrows[gi][r], {ji: pack.ok}, group_caps[gi], avail)
            allowed = oe[je]
            dest_e, dest_i = de[je], di[ji]
        # freed neutral slots feed the ring (queue slot j -> j * n_q + k)
        rrows[g][r] = _push_rows(rrows[g][r],
                                 {jn: (pack.slot * n_q + k, allowed)}, b_q)
    else:
        allowed = pack.ok
        dest_e = dest_i = None
    killed = kill_packed(SpeciesBuffer(x=kq.x[jn], v=kq.v[jn], w=kq.w[jn],
                                       alive=kq.alive[jn]),
                         pack.slot, allowed)
    alive = kq.alive.clone()
    w = kq.w.clone()
    alive[jn] = killed.alive
    w[jn] = killed.w
    kq = StackedSpecies(x=kq.x, v=kq.v, w=w, alive=alive)
    e_row = (pack.x, pack.v_electron, pack.w, allowed, dest_e)
    i_row = (pack.x, pack.v_ion, pack.w, allowed, dest_i)
    if ge == gi:
        births[ge][r].append(_birth_block(len(groups[ge]), b_q,
                                          group_caps[ge], dev,
                                          {je: e_row, ji: i_row}))
    else:
        births[ge][r].append(_birth_block(len(groups[ge]), b_q,
                                          group_caps[ge], dev, {je: e_row}))
        births[gi][r].append(_birth_block(len(groups[gi]), b_q,
                                          group_caps[gi], dev, {ji: i_row}))
    n_born = allowed.sum(dtype=torch.int32)
    dacc(None, "n_ionized", n_born)
    dacc(None, "birth_overflow", pack.n_events - n_born)
    return kq


def _engine_extras(ecfg: EngineConfig, sts, device):
    """Rings from the alive masks (the init-time full scan) and empty
    pending blocks."""
    groups = _capacity_groups(ecfg)
    prows = _group_pending_rows(ecfg, groups)
    d = ecfg.num_domains()
    rings, pending = [], []
    for g, idxs in enumerate(groups):
        st = sts[g]
        rings.append(ring_init(st.alive))
        pending.append(_empty_pending(d, len(idxs), prows[g], st.x.shape[-1],
                                      device))
    return tuple(rings), tuple(pending)


def _domain_gens(seed: int, d: int, device) -> tuple[torch.Generator, ...]:
    """One generator per domain, domain r seeded from (seed, r)."""
    return tuple(torch.Generator(device=device).manual_seed(
        seed * 1_000_003 + r) for r in range(d))


def _carried_rho(ecfg: EngineConfig, sts, device) -> torch.Tensor:
    """(D, ncl + 1) total charge of every domain's buffers."""
    cfg = ecfg.pic
    grid_local = Grid1D(nc=ecfg.local_nc(), dx=cfg.dx)
    groups = _capacity_groups(ecfg)
    out = []
    for r in range(ecfg.num_domains()):
        rho = torch.zeros(grid_local.ng, dtype=torch.float32, device=device)
        for g, idxs in enumerate(groups):
            charges = _group_consts(cfg, idxs, device)[2]
            st = sts[g]
            rho = rho + deposit_stacked(grid_local, st.x[r], st.w[r],
                                        st.alive[r], charges)
        out.append(rho)
    return torch.stack(out)


def _assemble(ecfg: EngineConfig, species, gens, step: int, rho, device,
              rings=None, pending=None) -> EngineState:
    """An EngineState from per-species (D, cap_l) buffers: groups stacked,
    rings rebuilt from the alive masks and pending empty unless given."""
    groups = _capacity_groups(ecfg)
    sts = tuple(StackedSpecies(
        x=torch.stack([species[i].x for i in idxs], 1).contiguous(),
        v=torch.stack([species[i].v for i in idxs], 1).contiguous(),
        w=torch.stack([species[i].w for i in idxs], 1).contiguous(),
        alive=torch.stack([species[i].alive for i in idxs], 1).contiguous())
        for idxs in groups)
    if rho is None and _carries_rho(ecfg):
        rho = _carried_rho(ecfg, sts, device)
    if not ecfg.use_ring:
        rings, pending = (), ()
    elif rings is None:
        rings, pending = _engine_extras(ecfg, sts, device)
    return EngineState(groups=sts, group_species=tuple(groups), gens=gens,
                       step=int(step), rho=rho, rings=tuple(rings),
                       pending=tuple(pending))


def init_engine_state(ecfg: EngineConfig, seed: int = 0,
                      device="cuda") -> EngineState:
    """Per-domain init: each domain draws its n_init / D particles of each
    species uniform over its own slab, from its own generator."""
    dev = resolve_device(device)
    cfg = ecfg.pic
    d = ecfg.num_domains()
    l_local = ecfg.local_nc() * cfg.dx
    gens = _domain_gens(seed, d, dev)
    species = []
    for sc in cfg.species:
        bufs = [init_uniform(gens[r], ecfg.local_cap(sc), sc.n_init // d,
                             l_local, sc.vth, sc.drift, sc.weight)
                for r in range(d)]
        species.append(SpeciesBuffer(*(torch.stack([getattr(b, f)
                                                    for b in bufs])
                                       for f in ("x", "v", "w", "alive"))))
    return _assemble(ecfg, species, gens, 0, None, dev)


def attach_engine_state(ecfg: EngineConfig, state: PICState,
                        seed: int = 0) -> EngineState:
    """Wrap a PICState whose buffers carry a leading domain axis
    ((D, cap_l) species, (D, ncl + 1) rho; the usual ``[None]`` lift of a
    single-domain state): rings rebuilt from the alive masks, no in-flight
    arrivals, one generator per domain seeded from ``seed``."""
    dev = state.species[0].x.device
    gens = _domain_gens(seed, ecfg.num_domains(), dev)
    return _assemble(ecfg, state.species, gens, state.step, state.rho, dev)


def state_from_numpy(ecfg: EngineConfig, arrays: dict, seed: int = 0,
                     device="cuda") -> EngineState:
    """The port's state from numpy arrays, e.g. the reference's EngineState
    exported with ``np.asarray``: ``arrays`` holds ``species`` (per species
    a mapping of (D, cap_l) ``x``/``v``/``w``/``alive``), ``rings`` and
    ``pending`` (per capacity group, the reference's (D, S, ...) leaves),
    ``rho`` ((D, ncl + 1) or None) and ``step``. A JAX key cannot become a
    generator: the domains get fresh ones seeded from ``seed``."""
    dev = resolve_device(device)

    def tt(a, dtype):
        return torch.tensor(np.asarray(a), dtype=dtype, device=dev)

    f32, i32 = torch.float32, torch.int32
    species = [SpeciesBuffer(x=tt(a["x"], f32), v=tt(a["v"], f32),
                             w=tt(a["w"], f32), alive=tt(a["alive"],
                                                         torch.bool))
               for a in arrays["species"]]
    if len(species) != len(ecfg.pic.species):
        raise ValueError(f"{len(species)} species arrays for "
                         f"{len(ecfg.pic.species)} configured species")
    rings = pending = None
    if ecfg.use_ring:
        rings = [FreeSlotRing(slots=tt(a["slots"], i32),
                              head=tt(a["head"], i32),
                              count=tt(a["count"], i32))
                 for a in arrays["rings"]]
        pending = [PendingArrivals(x=tt(a["x"], f32), v=tt(a["v"], f32),
                                   w=tt(a["w"], f32),
                                   alive=tt(a["alive"], torch.bool),
                                   dest=tt(a["dest"], i32))
                   for a in arrays["pending"]]
    rho = arrays.get("rho")
    rho = None if rho is None else tt(rho, f32)
    gens = _domain_gens(seed, ecfg.num_domains(), dev)
    return _assemble(ecfg, species, gens, int(arrays["step"]), rho, dev,
                     rings, pending)


def to_numpy(state: EngineState) -> dict:
    """The arrays of a state in the layout ``state_from_numpy`` takes (the
    reference's ``EngineState`` leaves)."""
    def a(t):
        return t.detach().cpu().numpy()

    return {
        "step": state.step,
        "rho": None if state.rho is None else a(state.rho),
        "species": [{f: a(getattr(b, f)) for f in ("x", "v", "w", "alive")}
                    for b in state.species],
        "rings": [{f: a(getattr(rg, f)) for f in ("slots", "head", "count")}
                  for rg in state.rings],
        "pending": [{f: a(getattr(p, f))
                     for f in ("x", "v", "w", "alive", "dest")}
                    for p in state.pending]}


def retarget_state(*args, **kwargs):
    raise NotImplementedError("retarget_state (the auto-tuner's knob "
                              "change) is not ported yet: "
                              + _ROADMAP.format(3))


def state_shape(*args, **kwargs):
    raise NotImplementedError("state_shape (checkpoint restore) is not "
                              "ported yet: " + _ROADMAP.format(4))


def state_shardings(*args, **kwargs):
    raise NotImplementedError("state_shardings (checkpoint restore) is not "
                              "ported yet: " + _ROADMAP.format(4))


def resplit_host(*args, **kwargs):
    raise NotImplementedError("resplit_host (elastic restore) is not "
                              "ported yet: " + _ROADMAP.format(4))


def elastic_state(*args, **kwargs):
    raise NotImplementedError("elastic_state (elastic restore) is not "
                              "ported yet: " + _ROADMAP.format(4))
