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
migrate + SEE -> deferred merge -> diagnostics, one function a phase; each
phase and queue stage runs inside an ``obs.tracing.phase_scope`` with the
reference's scope name. Scopes only the port has name the host work between
them: ``engine/step`` (the root), ``engine/buffers`` (the step's receive
buffers, ring rows and carried rho), per (domain, queue)
``engine/queue/q<k>`` around everything issued on the queue's stream, with
``engine/slice/q<k>`` (the queue's gather) and ``engine/ring/q<k>`` (its
turn in the domain's ring chain, holding ``engine/births/q<k>`` and the SEE
stage) beside the stages, ``engine/join`` (the wait for every queue) and
``engine/release`` (the step's working set freed). Where the rho is
carried, ``engine/rho/q<k>`` (in the migration) holds the leavers' deposit
and ``engine/merge/rho`` the merged rows'; a step that carries none enters
neither.

No host read inside a step: packing is done by prefix sums
(``particles.nonzero_static``), never ``torch.nonzero``; no ``.item()`` is
called, and no tensor is indexed by a 0-d tensor, which ATen reads on the
host (``particles.put_rows_`` takes its fill row by ``index_select``). The
one exception: with ``rebalance_skew > 0`` the step reads the (groups, D)
tensor of per-domain occupancy skews once, after the ingest flush, to
decide which domains compact (the reference branches on the same device
value with ``lax.cond``). The periodic trigger is a host integer.

On a card the step is therefore captured as a CUDA graph and replayed
(``_Graphs``): the queues' streams are branches forked from the capture
stream and joined back by the step's own events, so the replay keeps the
async(n) dependencies above, and the host's issue of the step's ~6,000
launches leaves the critical path. A replay opens ``engine/graph/replay``
inside ``engine/step`` and none of the phases' spans; a capture opens
``engine/graph/capture`` around the phases' spans (without CUDA events).

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
  writes the pending rows into the input's buffers in place, and the
  merge writes the queues back into them; ``donate=False`` copies first.
  The step has no probe mode: ``perf.phase_breakdown`` reads the phases
  from the spans of real (eager) steps.
* Random numbers come from one ``torch.Generator`` per domain; ``draws=``
  takes the reference's arrays instead (see ``step``). The state keeps the
  reference's per-domain key, ``EngineState.key`` ((D, 2) uint32, the
  ``pic/key`` of a checkpoint), as a host array the step never reads: the
  reference's own key when the state came from its arrays, else each
  domain's generator seed in two words (``_domain_keys``).

The checkpoint side (``runtime/resilience.py`` drives it): ``state_tree``
lays a state out as the reference's ``EngineState`` pytree, so a checkpoint
holds the reference's keys, shapes and dtypes; ``state_shape`` and
``state_shardings`` give the ``like`` tree and the device of each leaf of a
typed restore, ``state_from_tree`` rebuilds the state; ``resplit_host`` and
``elastic_state`` are the elastic restore onto another domain count;
``retarget_state`` carries a state across a knob change of the auto-tuner.

``make_engine_step(with_params=True)`` builds ``step(state, params,
draws=None)``: one ``RuntimeParams`` (``core/params.py``) serves every
domain, as the reference replicates it, and supplies dt, b, the source
coefficients and the collision rates; equal values are bit-identical to
the static step.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from repro_torch.core import boundaries, collisions, mover
from repro_torch.core.grid import Grid1D, deposit_stacked, deposit_windowed
from repro_torch.core.particles import (FreeSlotRing, SpeciesBuffer,
                                        StackedSpecies, cell_index,
                                        init_uniform, inject_masked, kill,
                                        kill_packed, nonzero_static,
                                        put_rows_, ring_claim,
                                        ring_from_counts, ring_init,
                                        ring_push)
from repro_torch.core.params import RuntimeParams
from repro_torch.core.pic import PICConfig, PICState
from repro_torch.core.pic import _b_arg
from repro_torch.core.pic import _carries_rho as pic_carries_rho
from repro_torch.device import resolve_device
from repro_torch.distributed import halo
from repro_torch.obs.tracing import graph_capture, phase_scope
from repro_torch.tree import leaves, rebuild

_SPECIES_FIELDS = ("x", "v", "w", "alive")
_RING_FIELDS = ("slots", "head", "count")
_PENDING_FIELDS = ("x", "v", "w", "alive", "dest")


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
    generator per domain, ``key`` the reference's (D, 2) uint32 key on the
    host (read by no step), ``rho`` the carried (D, ncl + 1) charge (None
    unless carried), ``rings``/``pending`` one entry per group, batched
    over (D, S) (empty in the legacy mode)."""

    groups: tuple[StackedSpecies, ...]
    group_species: tuple[tuple[int, ...], ...]
    gens: tuple[torch.Generator, ...]
    key: np.ndarray
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


def _empty_pending(lead: tuple, cap: int, device) -> PendingArrivals:
    """Dead pending rows of shape ``lead``, ``dest`` the drop value."""
    f32 = torch.float32
    return PendingArrivals(
        x=torch.zeros(lead, dtype=f32, device=device),
        v=torch.zeros(lead + (3,), dtype=f32, device=device),
        w=torch.zeros(lead, dtype=f32, device=device),
        alive=torch.zeros(lead, dtype=torch.bool, device=device),
        dest=torch.full(lead, cap, dtype=torch.int32, device=device))


def _birth_block(s: int, nb: int, cap: int, device, rows: dict
                 ) -> PendingArrivals:
    """One (S, nb) pending block of one domain whose live rows are MC
    births: ``rows`` maps a species row j to (x, v, w, ok, dest); other
    rows stay dead. ``dest=None`` (legacy mode) leaves the drop value."""
    b = _empty_pending((s, nb), cap, device)
    for j, (x, v, w, ok, dest) in rows.items():
        ok = ok.bool()
        b.x[j] = x
        b.v[j] = v
        b.w[j] = w * ok
        b.alive[j] = ok
        if dest is not None:
            b.dest[j] = dest
    return b


def _row_tables(ring: FreeSlotRing, rows: dict, dtypes: tuple) -> list:
    """(S, M) tables over the species rows of one domain's (S, R) group
    ring: row j of table t is ``rows[j][t]`` cast to ``dtypes[t]``, every
    other row zero."""
    s = ring.count.shape[0]
    m = next(iter(rows.values()))[0].shape[0]
    tabs = [torch.zeros(s, m, dtype=dt, device=ring.slots.device)
            for dt in dtypes]
    for j, vals in rows.items():
        for tab, v, dt in zip(tabs, vals, dtypes):
            tab[j] = v.to(dt)
    return tabs


def _claim_rows(ring: FreeSlotRing, want_rows: dict, cap: int,
                budget: torch.Tensor | None = None):
    """Claim slots from one domain's (S, R) group ring for the species
    rows of ``want_rows`` (row j -> (M,) mask); ``budget`` caps every
    row's grants. Returns (ring, dest (S, M), ok (S, M))."""
    want, = _row_tables(ring, {j: (wv,) for j, wv in want_rows.items()},
                        (torch.bool,))
    bud = None if budget is None else budget.expand(ring.count.shape[0])
    return ring_claim(ring, want, cap, bud)


def _compact_group(st: StackedSpecies, cell: tuple | None
                   ) -> tuple[StackedSpecies, torch.Tensor]:
    """Stable per-species compaction (alive first) of a domain's (S, cap)
    group, or with ``cell = (dx, nc)`` a stable sort by cell with the dead
    rows at the tail (``particles.sort_by_cell`` over the species axis):
    either way its interleaved queue split is occupancy-even. Returns the
    group and its (S,) alive counts."""
    key = ((~st.alive).to(torch.uint8) if cell is None else cell_index(
        SpeciesBuffer(x=st.x, v=st.v, w=st.w, alive=st.alive), *cell))
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


def _domain_rho(grid: Grid1D, sts, charges) -> torch.Tensor:
    """(D, ng) charge of every domain's group stacks, given each group's
    (S,) charges."""
    return torch.stack([
        sum(deposit_stacked(grid, st.x[r], st.w[r], st.alive[r], ch)
            for st, ch in zip(sts, charges))
        for r in range(sts[0].x.shape[0])])


# --------------------------------------------------------------- the step
#
# ``make_engine_step`` derives a ``_Plan`` from the config once; each step
# opens a ``_Work`` on its state and runs one function a phase on the two.

@dataclasses.dataclass(frozen=True)
class _Plan:
    """What a step takes from its config: the local grid, the queues'
    sizes and budgets, the capacity groups and the menu of each."""
    ecfg: EngineConfig
    cfg: PICConfig
    d: int                        # domains
    grid: Grid1D                  # a domain's grid
    top: float                    # the last float32 inside the slab
    n_q: int                      # queues per domain
    m_q: int                      # per-queue migration budget
    b_q: int                      # per-queue birth budget (0: no ionization)
    ion: tuple | None             # (neutral, electron, ion) species
    carried: bool                 # the rho is carried from step to step
    groups: tuple                 # species indices of each capacity group
    loc: dict                     # species -> (group, row)
    prows: tuple                  # pending rows of each group
    caps: tuple                   # local capacity of each group
    see_pairs: tuple              # active (primary, target) emission pairs
    g_menu: tuple                 # menu indices of each group's entries


def _plan(ecfg: EngineConfig) -> _Plan:
    """Validate ``ecfg`` for the engine and derive its plan."""
    cfg = ecfg.pic
    ncl = ecfg.local_nc()
    n_q = ecfg.async_n
    groups = _capacity_groups(ecfg)
    loc = _species_location(groups)
    for sc in cfg.species:
        cap_l = ecfg.local_cap(sc)
        if cap_l % n_q != 0:
            raise ValueError(
                f"async_n ({n_q}) must divide the local capacity ({cap_l}) "
                f"of species {sc.name!r}")
    for cc in cfg.collisions:
        parts = collisions.involved_species([cc])
        if len({loc[i][0] for i in parts}) != 1:
            names = [cfg.species[i].name for i in parts]
            raise ValueError(
                f"collision {cc.kind!r} pairs species {names} across "
                f"capacity groups; give them equal capacities to run on "
                f"the engine")
    return _Plan(
        ecfg=ecfg, cfg=cfg, d=ecfg.num_domains(),
        grid=Grid1D(nc=ncl, dx=cfg.dx),
        top=float(np.nextafter(np.float32(ncl * cfg.dx), np.float32(0.0))),
        n_q=n_q, m_q=ecfg.queue_migration,
        b_q=ecfg.queue_births if cfg.ionization is not None else 0,
        ion=cfg.ionization, carried=_carries_rho(ecfg),
        groups=tuple(groups), loc=loc,
        prows=tuple(_group_pending_rows(ecfg, groups)),
        caps=tuple(ecfg.local_cap(cfg.species[idxs[0]]) for idxs in groups),
        see_pairs=_see_pairs(cfg),
        g_menu=tuple(tuple(k_m for k_m, cc in enumerate(cfg.collisions)
                           if loc[cc.species][0] == g)
                     for g in range(len(groups))))


# device -> the engine's streams on it: the graphs' capture stream, then
# the queues' (domain r's queue k is 1 + r * async_n + k). One list a
# process, made in one go and grown as needed: PyTorch hands out streams
# from a pool of 32 a priority in turn, so streams made a step function
# at a time (a retune, a test) would come round to the capture stream,
# and a queue on the capture stream could reuse, before the join, memory
# that another queue still reads.
_STREAM_SETS: dict = {}


def _streams(dev, n: int) -> list:
    """The capture stream and at least ``n`` queue streams on ``dev``."""
    have = _STREAM_SETS.setdefault(dev, [])
    while len(have) < n + 1:
        have.append(torch.cuda.Stream(dev))
    return have


class _Work:
    """One step's working set: its input state, its constants on the
    state's device, the group stacks and rings it replaces, and what each
    phase hands to the next."""

    def __init__(self, plan: _Plan, cache: dict, state: EngineState,
                 rp: RuntimeParams | None, draws, donate: bool):
        cfg = plan.cfg
        dev = state.groups[0].x.device
        self.state, self.rp, self.draws, self.dev = state, rp, draws, dev
        self.card = dev.type == "cuda"
        if dev not in cache:
            streams = _streams(dev, plan.d * plan.n_q) if self.card else None
            cache[dev] = (
                [_group_consts(cfg, idxs, dev) for idxs in plan.groups],
                [torch.tensor(idxs, device=dev) for idxs in plan.groups],
                {(r, k): streams[1 + r * plan.n_q + k]
                 for r in range(plan.d) for k in range(plan.n_q)}
                if self.card else None)
        gconsts, sel, self.streams = cache[dev]
        if rp is not None:
            # the params' dt*stride in place of the config's; q/m*dt is
            # formed on the device from them on both paths
            gconsts = [(qm, rp.dts.index_select(0, ix), ch)
                       for (qm, _, ch), ix in zip(gconsts, sel)]
        self.gconsts = gconsts        # per group (q/m, dt*stride, charges)
        self.dt = cfg.dt if rp is None else rp.dt
        self.b = _b_arg(cfg, rp)
        self.iparams = (collisions.IonizationParams(
            rate=cfg.ionization_rate if rp is None else rp.ionization_rate,
            vth_electron=cfg.ionization_vth_e)
            if plan.ion is not None else None)
        self.eparams = (boundaries.EmissionParams(
            yield_=cfg.emission_yield if rp is None else rp.emission_yield,
            vth_emit=cfg.emission_vth, weight=cfg.emission_weight)
            if plan.see_pairs else None)
        self.donate = donate          # the ingest writes into the input
        self.sts = list(state.groups)
        self.rings = list(state.rings)
        # set by the phases: the step's pending blocks, field and sources;
        # per group the receive buffers, [domain][queue] kept stacks,
        # [domain] birth blocks and ring rows; per domain the carried rho;
        # the events that every input of the queues is on main (ready) and
        # of the domain's ring chain of queues (chain)
        self.pend = self.e = self.ne = self.coll_dens = None
        self.recv = self.kept = self.births = self.rrows = None
        self.rho_acc = self.rho_out = self.ready = self.chain = None
        self.done = []                # each queue's last event
        self.keep = []                # tensors read across streams
        self.contrib = []             # the queues' diagnostics

    def on(self, r: int, k: int):
        """Issue on queue (r, k)'s stream: a card's, nothing on the CPU."""
        return (torch.cuda.stream(self.streams[(r, k)]) if self.card
                else contextlib.nullcontext())

    def record(self):
        if not self.card:
            return None
        ev = torch.cuda.Event()
        ev.record()
        return ev

    def wait(self, ev) -> None:
        if ev is not None:
            torch.cuda.current_stream(self.dev).wait_event(ev)

    def dacc(self, name: str | None, k: str, v: torch.Tensor) -> None:
        self.contrib.append((f"{name}/{k}" if name else k, v))


def make_engine_step(ecfg: EngineConfig, *, donate: bool = True,
                     with_params: bool = False, graph: bool = True):
    """Build the async(n) step: ``step(state, draws=None) -> (state,
    diag)``. The step donates its input state unless ``donate=False``.

    ``with_params=True`` builds ``step(state, params, draws=None)``: the
    ``RuntimeParams`` ``params`` supplies dt, b, the ionization rate, the
    SEE yield and the collision rates to every domain in place of the
    config's. Equal values give the static step's results bit for bit.

    ``draws`` (optional) replaces the per-domain generators: one dict per
    domain with ``"ionize"`` (per queue, the ``ionization_events`` arrays
    of the queue's neutral slice), ``"see"`` (per wall-emission pair, per
    queue, the ``emission_candidates`` arrays of the queue's pack) and
    ``"collide"`` (per queue, a dict group -> the menu draws of the
    group's entries), as the reference derives them from its keys.

    On a CUDA device the step replays its work as a CUDA graph
    (``_Graphs``) wherever the host need not read the card to branch; its
    phases then open no spans. ``graph=False`` runs every step eagerly,
    phase by phase (``perf.phase_breakdown``, ``pic_run --phases``). A
    replayed step returns the step function's own buffers: the state it
    returns holds until the function's next call, which writes them
    whatever its input (copy a state to keep it longer); with
    ``donate=False`` it returns copies.
    """
    plan = _plan(ecfg)
    # device -> (per-group (q/m, dt*stride, charges), per-group species
    # index tensors, {(domain, queue): stream} on a card, from _streams)
    cache: dict = {}
    graphs = _Graphs(plan, donate) if graph else None

    def run(state: EngineState, params: RuntimeParams | None, draws,
            donate: bool):
        w = _Work(plan, cache, state, params, draws, donate)
        _ingest(plan, w)
        _field(plan, w)
        _sources(plan, w)
        _buffers(plan, w)
        # the async(n) pipeline, domain by domain: queue k's push,
        # collide, ionization and packing run on its own stream; its
        # ring and rho updates wait for queue k-1's
        for r in range(plan.d):
            w.chain = None
            for g in range(len(plan.groups)):
                st = _map(w.sts[g], lambda a, r=r: a[r])
                for k in range(plan.n_q):
                    _queue_turn(plan, w, r, g, k, st)
                w.keep.append(st)
        _join(plan, w)
        _merge(plan, w)
        diag = _diag(plan, w)
        out = EngineState(
            groups=tuple(w.sts), group_species=plan.groups,
            gens=state.gens, key=state.key, step=state.step + 1,
            rho=w.rho_out, rings=tuple(w.rings), pending=tuple(w.pend))
        _release(w)
        return out, diag

    def step(state: EngineState, params: RuntimeParams | None, draws=None):
        with phase_scope("engine/step"):
            if graphs is not None and graphs.takes(state, params):
                return graphs.step(state, draws, run)
            return run(state, params, draws, donate)

    if with_params:
        return step

    def step_static(state: EngineState, draws=None):
        return step(state, None, draws)

    return step_static


# ------------------------------------------------------------ CUDA graphs


def _parts(state: EngineState) -> tuple:
    return state.groups, state.rings, state.pending, state.rho


def _fields(state: EngineState) -> list[torch.Tensor]:
    """The state's device tensors in a fixed order: each group's stack,
    ring and pending block, then the carried rho (where there is one)."""
    return [t for _, t in leaves(_parts(state))]


def _with_fields(state: EngineState, tensors, step: int) -> EngineState:
    """``state`` with ``tensors`` (in ``_fields``' order) and ``step``."""
    it = iter(tensors)
    groups, rings, pending, rho = rebuild(_parts(state), lambda _, t: next(it))
    return dataclasses.replace(state, groups=groups, rings=rings,
                               pending=pending, rho=rho, step=step)


class _Diag:
    """A step's diagnostics packed into one buffer a dtype, inside the
    graph. ``read`` copies each buffer once, after a replay, and returns
    the dict of views of the copies, so a later replay leaves it as it
    was."""

    def __init__(self, diag: dict):
        parts: dict = {}
        self.layout = []              # (key, dtype, offset, shape)
        for key, v in diag.items():
            row = parts.setdefault(v.dtype, [])
            self.layout.append((key, v.dtype, sum(p.numel() for p in row),
                                tuple(v.shape)))
            row.append(v.reshape(-1))
        self.bufs = {dt: torch.cat(row) for dt, row in parts.items()}

    def read(self) -> dict:
        copies = {dt: b.clone() for dt, b in self.bufs.items()}
        return {key: copies[dt].narrow(0, off, int(np.prod(shape)))
                .view(shape) for key, dt, off, shape in self.layout}


@dataclasses.dataclass
class _Captured:
    graph: object                 # torch.cuda.CUDAGraph
    draws: list                   # the static draw buffers, leaf by leaf
    diag: _Diag


class _Graphs:
    """The step captured as CUDA graphs and replayed.

    The step owns one set of device buffers of the state (``own``, in
    ``_fields``' order) and captures its phases on them, donating them,
    with the queues' streams forked from the capture stream and joined
    back by the step's own events; the graph ends by copying each returned
    tensor that is not already the owned one into it. A replay then reads
    and writes ``own`` alone: a call on the step's last output runs in
    place, any other input is copied in first (one device copy a tensor).
    With ``donate=False`` the step returns copies of ``own``, so the
    caller's input is never written. The domains' generators are
    registered with each graph, so a replay draws the eager step's numbers
    and moves the generators on as the eager step does.

    A graph is captured once a branch of the host (``_branch``): the form
    of ``draws`` (its leaves are copied into the graph's static buffers),
    the species whose stride skips the step, and whether the periodic
    rebalance is due. The graphs share one memory pool and are replayed
    one at a time. The first step on a card runs eagerly (lazily loaded
    kernels, the queues' streams), as does every step with runtime
    parameters or with ``rebalance_skew > 0`` (its host read of the
    skews). New generators or another layout of the state start the
    graphs anew."""

    def __init__(self, plan: _Plan, donate: bool):
        self.plan, self.donate = plan, donate
        self.warm = False             # an eager step has run on the card
        self.own: list | None = None
        self.layout = None            # shapes, dtypes, devices of own
        self.gens: tuple = ()         # the generators the graphs register
        self.graphs: dict = {}        # branch -> _Captured
        self.pool = None

    def takes(self, state: EngineState, params) -> bool:
        return (params is None and self.plan.ecfg.rebalance_skew == 0
                and state.groups[0].x.is_cuda)

    def step(self, state: EngineState, draws, run):
        if not self.warm:
            self.warm = True
            return run(state, None, draws, self.donate)
        fields = _fields(state)
        layout = tuple((t.shape, t.dtype, t.device) for t in fields)
        if layout != self.layout:
            self.own = [torch.empty(t.shape, dtype=t.dtype, device=t.device)
                        for t in fields]
            self.layout = layout
            self.graphs.clear()
        if (len(state.gens) != len(self.gens)
                or any(a is not b for a, b in zip(state.gens, self.gens))):
            self.gens = tuple(state.gens)
            self.graphs.clear()
        for o, t in zip(self.own, fields):
            if o.data_ptr() != t.data_ptr():
                o.copy_(t)
        key = _branch(self.plan, state, draws)
        cap = self.graphs.get(key)
        if cap is None:
            cap = self.graphs[key] = self._capture(state, draws, run)
        if draws is not None:
            for buf, (_, a) in zip(cap.draws, leaves(draws)):
                buf.copy_(torch.as_tensor(a))
        with phase_scope("engine/graph/replay"):
            cap.graph.replay()
            diag = cap.diag.read()
        own = self.own if self.donate else [t.clone() for t in self.own]
        return _with_fields(state, own, state.step + 1), diag

    def _capture(self, state: EngineState, draws, run) -> _Captured:
        inp = _with_fields(state, self.own, state.step)
        dev = self.own[0].device
        static = None if draws is None else rebuild(
            draws, lambda _, a: torch.empty_like(torch.as_tensor(a),
                                                 device=dev))
        g = torch.cuda.CUDAGraph()
        for gen in state.gens:
            g.register_generator_state(gen)
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        with phase_scope("engine/graph/capture"), graph_capture(), \
                torch.cuda.graph(g, pool=self.pool,
                                 stream=_streams(dev, 0)[0]):
            packed = self._into_own(inp, static, run)
        return _Captured(graph=g, diag=packed,
                         draws=[a for _, a in leaves(static)])

    def _into_own(self, inp: EngineState, draws, run) -> _Diag:
        """The captured work: the step on the owned buffers, donating
        them, each returned tensor copied into its owned one where it is
        another, and the diagnostics packed."""
        out, diag = run(inp, None, draws, True)
        for o, t in zip(self.own, _fields(out)):
            if o.data_ptr() != t.data_ptr():
                o.copy_(t)
        return _Diag(diag)


def _branch(plan: _Plan, state: EngineState, draws) -> tuple:
    """What the host branches on in a step: the form of ``draws``, the
    species pushed this step (those with a stride > 1) and whether the
    periodic rebalance is due."""
    reb = plan.ecfg.rebalance_every
    return (None if draws is None else tuple(
        (path, torch.as_tensor(a).shape, torch.as_tensor(a).dtype)
        for path, a in leaves(draws)),
            tuple(state.step % sc.stride == 0 for sc in plan.cfg.species
                  if sc.stride > 1),
            reb > 0 and state.step > 0 and state.step % reb == 0)


def _ingest(plan: _Plan, w: _Work) -> None:
    """Land last step's arrivals and births in their pre-claimed slots,
    then compact the domains that are due: every ``rebalance_every`` steps,
    and where a domain's queue occupancy skews past ``rebalance_skew`` (the
    step's one host read). Opens the step's empty pending blocks."""
    ecfg, sts, step_i = plan.ecfg, w.sts, w.state.step
    reb_k, skew_k = ecfg.rebalance_every, ecfg.rebalance_skew
    ngr = len(plan.groups)
    with phase_scope("engine/ingest"):
        due = [None] * ngr
        for g in range(ngr):
            if ecfg.use_ring:
                sts[g] = _flush_pending(sts[g], w.state.pending[g],
                                        inplace=w.donate)
            elif not w.donate and (reb_k > 0 or skew_k > 0):
                sts[g] = _map(sts[g], torch.clone)
            if reb_k > 0 and step_i > 0 and step_i % reb_k == 0:
                due[g] = [True] * plan.d
        if skew_k > 0 and step_i > 0:
            occ = [_queue_occupancy(st.alive, plan.n_q) for st in sts]
            skews = torch.stack([(o.max(-1).values - o.min(-1).values)
                                 .amax(-1) for o in occ])
            over = (skews > skew_k).tolist()   # the one host read
            due = [over[g] if due[g] is None
                   else [a or b for a, b in zip(due[g], over[g])]
                   for g in range(ngr)]
        cell = (plan.cfg.dx, plan.grid.nc) if ecfg.cell_order else None
        for g in range(ngr):
            for r in range(plan.d):
                if not (due[g] and due[g][r]):
                    continue
                # compact domain r's rows in place, and rebuild its ring
                # rows (the group's ring copied once) from the counts
                row = _map(sts[g], lambda a, r=r: a[r])
                new, alive_counts = _compact_group(row, cell)
                for f in dataclasses.fields(new):
                    getattr(sts[g], f.name)[r] = getattr(new, f.name)
                if not ecfg.use_ring:
                    continue
                if w.rings[g] is w.state.rings[g]:
                    w.rings[g] = _map(w.rings[g], torch.clone)
                fresh = ring_from_counts(alive_counts, plan.caps[g])
                for f in dataclasses.fields(fresh):
                    getattr(w.rings[g], f.name)[r] = getattr(fresh, f.name)
    w.pend = ([_empty_pending((plan.d, len(idxs), plan.prows[g]),
                              plan.caps[g], w.dev)
               for g, idxs in enumerate(plan.groups)]
              if ecfg.use_ring else [])


def _field(plan: _Plan, w: _Work) -> None:
    """The field: a halo exchange of edge nodes and scalars only."""
    cfg = plan.cfg
    with phase_scope("engine/field"):
        if not cfg.field_solve:
            w.e = torch.zeros(plan.d, plan.grid.ng, dtype=torch.float32,
                              device=w.dev)
            return
        if plan.carried and w.state.rho is not None:
            rho_local = w.state.rho
        else:
            rho_local = _domain_rho(plan.grid, w.sts,
                                    [c[2] for c in w.gconsts])
        w.e = halo.field_phase(rho_local, dx=cfg.dx, eps0=cfg.eps0,
                               smoothing_passes=cfg.smoothing_passes)


def _sources(plan: _Plan, w: _Work) -> None:
    """The electron density of each domain (halo-summed at the shared
    nodes) and the collision densities."""
    sts, loc = w.sts, plan.loc
    with phase_scope("engine/sources"):
        if plan.ion is not None:
            ge, je = loc[plan.ion[1]]
            st = sts[ge]
            w.ne = halo.halo_sum(torch.stack([
                deposit_windowed(plan.grid, st.x[r, je],
                                 st.w[r, je] * st.alive[r, je])
                for r in range(plan.d)]))
    if plan.cfg.collisions:
        with phase_scope("engine/collide_setup"):
            w.coll_dens = [{
                i: collisions.cell_density(plan.grid, SpeciesBuffer(
                    x=sts[loc[i][0]].x[r, loc[i][1]],
                    v=sts[loc[i][0]].v[r, loc[i][1]],
                    w=sts[loc[i][0]].w[r, loc[i][1]],
                    alive=sts[loc[i][0]].alive[r, loc[i][1]]))
                for i in collisions.density_species(plan.cfg.collisions)}
                for r in range(plan.d)]


def _buffers(plan: _Plan, w: _Work) -> None:
    """The step's receive buffers, ring rows and carried rho."""
    d, n_q, m_q, dev = plan.d, plan.n_q, plan.m_q, w.dev
    with phase_scope("engine/buffers"):
        # receive buffers of the migration packs: (D, S, n_q, 2, m_q)
        # per group, [.., k, 0] from the left neighbour, [.., k, 1]
        # from the right, so a domain's rows read as the reference's
        # concatenation (q0 left, q0 right, q1 left, ...)
        w.recv = [StackedSpecies(
            x=torch.zeros(d, len(idxs), n_q, 2, m_q, device=dev),
            v=torch.zeros(d, len(idxs), n_q, 2, m_q, 3, device=dev),
            w=torch.zeros(d, len(idxs), n_q, 2, m_q, device=dev),
            alive=torch.zeros(d, len(idxs), n_q, 2, m_q,
                              dtype=torch.bool, device=dev))
            for idxs in plan.groups]
        w.kept = [[[None] * n_q for _ in range(d)] for _ in plan.groups]
        w.births = [[[] for _ in range(d)] for _ in plan.groups]
        # each domain's own ring rows and carried rho: a domain's chain
        # of queues updates only these, so no stream reads another
        # domain's
        w.rrows = [[_map(rg, lambda a, r=r: a[r]) for r in range(d)]
                   for rg in w.rings]
        w.rho_acc = [torch.zeros(plan.grid.ng, dtype=torch.float32,
                                 device=dev) if plan.carried else None
                     for _ in range(d)]
        # read by the queues' streams, replaced by their sums
        w.keep.extend(a for a in w.rho_acc if a is not None)
        w.ready = w.record()


def _queue_turn(plan: _Plan, w: _Work, r, g, k, st: StackedSpecies):
    """Queue k of group g on domain r, on the queue's stream: its slice of
    ``st`` (the group's row of the domain) is pushed, collided, ionized
    and packed, then takes its turn in the domain's ring chain."""
    with w.on(r, k), phase_scope(f"engine/queue/q{k}"):
        with phase_scope(f"engine/slice/q{k}"):
            w.wait(w.ready)
            q = _queue_slice(st, plan.n_q, k)
        out, rho_k = _push(plan, w, r, g, k, q)
        _collide(plan, w, r, g, k, out)
        pack = _ionize(plan, w, r, g, k, out)
        mig = _migrate(plan, w, r, g, k, out)
        _ring(plan, w, r, g, k, pack, mig, rho_k)


def _push(plan: _Plan, w: _Work, r, g, k, q: StackedSpecies):
    """The fused push of a queue (open walls: the crossers wait for the
    migration), each sub-cycled species held where its stride skips this
    step. Returns the pushed queue and its carried-rho deposit."""
    cfg, idxs = plan.cfg, plan.groups[g]
    qm, dts, charges = w.gconsts[g]
    with phase_scope(f"engine/push/q{k}"):
        out, _, _, pdiag, rho_k = mover.push_stacked(
            q, w.e[r], plan.grid, qm, dts, b=w.b, boundary="open",
            gather_mode=cfg.gather_mode,
            charges=charges if plan.carried else None)
        strides = [cfg.species[i].stride for i in idxs]
        if any(s > 1 for s in strides):
            # filled slot by slot: a copy from the host cannot be
            # captured into the step's graph
            do = torch.zeros(len(strides), dtype=torch.bool, device=w.dev)
            for j, s in enumerate(strides):
                if w.state.step % s == 0:
                    do[j].fill_(True)
            out = StackedSpecies(*(
                torch.where(do.reshape((-1,) + (1,) * (getattr(out, f)
                                                       .dim() - 1)),
                            getattr(out, f), getattr(q, f))
                for f in ("x", "v", "w", "alive")))
            pdiag = {n: torch.where(do, v, 0) for n, v in pdiag.items()}
        for j, i in enumerate(idxs):
            for n_, v in pdiag.items():
                w.dacc(cfg.species[i].name, n_, v[j])
    return out, rho_k


def _collide(plan: _Plan, w: _Work, r, g, k, out: StackedSpecies):
    """The group's binary collisions on a pushed queue: the deflected
    velocities are written back into ``out``."""
    menu = plan.g_menu[g]
    if not menu:
        return
    idxs = plan.groups[g]
    g_coll = [plan.cfg.collisions[k_m] for k_m in menu]
    with phase_scope(f"engine/collide/q{k}"):
        rows_c = collisions.involved_species(g_coll)
        cbufs = {i: SpeciesBuffer(
            x=out.x[idxs.index(i)], v=out.v[idxs.index(i)],
            w=out.w[idxs.index(i)], alive=out.alive[idxs.index(i)])
            for i in rows_c}
        cdraws = None if w.draws is None else w.draws[r]["collide"][k][g]
        cbufs, cdiag = collisions.apply_menu(
            w.state.gens[r], cbufs, g_coll, w.coll_dens[r], plan.grid, w.dt,
            plan.cfg.collide_kernel, cdraws,
            rates=None if w.rp is None else [w.rp.collision_rates[k_m]
                                             for k_m in menu])
        for i, cb in cbufs.items():
            out.v[idxs.index(i)] = cb.v
        for ck, cv in cdiag.items():
            w.dacc(None, ck, cv)


def _ionize(plan: _Plan, w: _Work, r, g, k, out: StackedSpecies):
    """MC ionization of a pushed queue's neutrals: the events and the
    packed rows, None where the group holds no neutrals. The kills wait
    for the ring (``_ionize_rows``)."""
    idxs = plan.groups[g]
    if plan.ion is None or plan.ion[0] not in idxs:
        return None
    with phase_scope(f"engine/ionize/q{k}"):
        jn = idxs.index(plan.ion[0])
        qn = SpeciesBuffer(x=out.x[jn], v=out.v[jn], w=out.w[jn],
                           alive=out.alive[jn])
        return collisions.ionize_packed(
            w.state.gens[r], qn, plan.grid, w.iparams, w.dt, w.ne[r],
            plan.b_q, None if w.draws is None else w.draws[r]["ionize"][k])


def _migrate(plan: _Plan, w: _Work, r, g, k, out: StackedSpecies):
    """A pushed queue's migration packs, copied into the neighbours'
    receive buffers on this stream (the crossers are outside the slab, so
    no ionized neutral is one). Returns (kept queue, freed slots, freed
    ok, absorbed left, absorbed right, the leavers' rho or None)."""
    cfg, idxs = plan.cfg, plan.groups[g]
    with phase_scope(f"engine/migrate/q{k}"):
        (kq, pack_l, pack_r, lv_x, lv_w, free_idx, free_ok, abs_l, abs_r,
         dmig) = _exchange_queue(out, plan.grid.length, plan.m_q,
                                 cfg.boundary, r == 0, r == plan.d - 1,
                                 plan.top)
        lv_rho = None
        if plan.carried:
            with phase_scope(f"engine/rho/q{k}"):
                lv_rho = deposit_windowed(plan.grid, lv_x,
                                          w.gconsts[g][2][:, None] * lv_w)
        # the copies to the neighbours, on this stream
        halo.send(w.recv[g], ((r + 1) % plan.d, slice(None), k, 0), pack_r)
        halo.send(w.recv[g], ((r - 1) % plan.d, slice(None), k, 1), pack_l)
        for j, i in enumerate(idxs):
            for n_, v in dmig.items():
                w.dacc(cfg.species[i].name, n_, v[j])
    return kq, free_idx, free_ok, abs_l, abs_r, lv_rho


def _ring(plan: _Plan, w: _Work, r, g, k, pack, mig: tuple, rho_k):
    """A queue's turn in its domain's ring chain, after queue k-1's: the
    births and SEE claim ring rows, the freed slots go back, the carried
    rho takes the queue's deposit less its leavers'."""
    kq, free_idx, free_ok, abs_l, abs_r, lv_rho = mig
    idxs, use_ring = plan.groups[g], plan.ecfg.use_ring
    with phase_scope(f"engine/ring/q{k}"):
        w.wait(w.chain)
        w.keep.append([rr[r] for rr in w.rrows])
        if pack is not None:
            with phase_scope(f"engine/births/q{k}"):
                kq = _ionize_rows(plan, w, r, g, k, kq, pack)
        if use_ring:
            w.rrows[g][r] = ring_push(w.rrows[g][r],
                                      free_idx * plan.n_q + k, free_ok)
        for pi, (p_, t_) in enumerate(plan.see_pairs):
            if p_ not in idxs:
                continue
            with phase_scope(f"engine/see/q{k}"):
                jp = idxs.index(p_)
                emit, ex, ev, ew = boundaries.emission_candidates(
                    w.state.gens[r], abs_l[jp], abs_r[jp], w.eparams,
                    plan.grid.length, torch.float32,
                    None if w.draws is None else w.draws[r]["see"][pi][k])
                gt, jt = plan.loc[t_]
                if use_ring:
                    w.rrows[gt][r], dstm, okm = _claim_rows(
                        w.rrows[gt][r], {jt: emit}, plan.caps[gt])
                    ok_t, dest_t = okm[jt], dstm[jt]
                else:
                    ok_t, dest_t = emit, None
                w.births[gt][r].append(_birth_block(
                    len(plan.groups[gt]), 2 * plan.m_q, plan.caps[gt], w.dev,
                    {jt: (ex, ev, ew, ok_t, dest_t)}))
                name = plan.cfg.species[t_].name
                w.dacc(name, "emitted", ok_t.sum(dtype=torch.int32))
                w.dacc(name, "emission_overflow",
                       (emit & ~ok_t).sum(dtype=torch.int32))
        if plan.carried:
            w.rho_acc[r] = (w.rho_acc[r] + rho_k) - lv_rho
            w.keep.append(w.rho_acc[r])
        w.kept[g][r][k] = kq
        w.chain = w.record()
        w.done.append(w.chain)


def _ionize_rows(plan: _Plan, w: _Work, r, g, k, kq: StackedSpecies, pack):
    """One queue's ionization after its ring turn: claim an electron and
    an ion slot per birth under the shared min-count budget (a birth gets
    both or neither), push the freed neutral slots, kill the neutrals and
    hold the births as pending blocks. Returns the queue's stack."""
    ni, ei, ii = plan.ion
    jn = plan.groups[g].index(ni)
    (ge, je), (gi, ji) = plan.loc[ei], plan.loc[ii]
    rrows, caps = w.rrows, plan.caps
    if plan.ecfg.use_ring:
        avail = torch.minimum(rrows[ge][r].count[je], rrows[gi][r].count[ji])
        if ge == gi:
            rrows[ge][r], dest, okm = _claim_rows(
                rrows[ge][r], {je: pack.ok, ji: pack.ok}, caps[ge], avail)
            allowed = okm[je]
            dest_e, dest_i = dest[je], dest[ji]
        else:
            rrows[ge][r], de, oe = _claim_rows(
                rrows[ge][r], {je: pack.ok}, caps[ge], avail)
            rrows[gi][r], di, _ = _claim_rows(
                rrows[gi][r], {ji: pack.ok}, caps[gi], avail)
            allowed = oe[je]
            dest_e, dest_i = de[je], di[ji]
        # freed neutral slots feed the ring (queue slot j -> j * n_q + k)
        idx, ok = _row_tables(rrows[g][r],
                              {jn: (pack.slot * plan.n_q + k, allowed)},
                              (torch.int32, torch.bool))
        rrows[g][r] = ring_push(rrows[g][r], idx, ok)
    else:
        allowed = pack.ok
        dest_e = dest_i = None
    killed = kill_packed(SpeciesBuffer(x=kq.x[jn], v=kq.v[jn], w=kq.w[jn],
                                       alive=kq.alive[jn]),
                         pack.slot, allowed)
    alive = kq.alive.clone()
    wts = kq.w.clone()
    alive[jn] = killed.alive
    wts[jn] = killed.w
    kq = StackedSpecies(x=kq.x, v=kq.v, w=wts, alive=alive)
    # one birth block a group: both rows in one when the groups are one
    rows = {ge: {}, gi: {}}
    rows[ge][je] = (pack.x, pack.v_electron, pack.w, allowed, dest_e)
    rows[gi][ji] = (pack.x, pack.v_ion, pack.w, allowed, dest_i)
    for gb, rows_b in rows.items():
        w.births[gb][r].append(_birth_block(len(plan.groups[gb]), plan.b_q,
                                            caps[gb], w.dev, rows_b))
    n_born = allowed.sum(dtype=torch.int32)
    w.dacc(None, "n_ionized", n_born)
    w.dacc(None, "birth_overflow", pack.n_events - n_born)
    return kq


def _join(plan: _Plan, w: _Work) -> None:
    """The merge waits for every queue (``depend(in)``); the domains' ring
    rows are stacked back into the group rings."""
    with phase_scope("engine/join"):
        for ev in w.done:
            w.wait(ev)
        w.rings = [FreeSlotRing(
            slots=rg.slots, head=torch.stack([rr.head for rr in rows]),
            count=torch.stack([rr.count for rr in rows]))
            for rg, rows in zip(w.rings, w.rrows)]


def _merge(plan: _Plan, w: _Work) -> None:
    """The deferred merge: every group's queues interleaved back, its
    received rows and births claimed into pending blocks (the legacy mode
    injects them), their charge added to the carried rho."""
    d = plan.d
    with phase_scope("engine/merge"):
        for g, idxs in enumerate(plan.groups):
            charges = w.gconsts[g][2]
            # the ring path owns w.sts[g] (the donated input or the
            # ingest's copy): the queues are merged back into it
            full = _merged(w.sts[g], w.kept[g], plan.n_q,
                           into=plan.ecfg.use_ring)
            s = len(idxs)
            cand = _map(w.recv[g], lambda a: a.reshape(
                (d, s, 2 * plan.ecfg.max_migration) + tuple(a.shape[5:])))
            blocks = [PendingArrivals(*(
                torch.stack([torch.cat([getattr(b, f) for b in
                                        w.births[g][r]], 1)
                             for r in range(d)])
                for f in _PENDING_FIELDS))] if w.births[g][0] else []
            if plan.ecfg.use_ring:
                w.rings[g], dest, accepted = ring_claim(
                    w.rings[g], cand.alive, plan.caps[g])
                pend_g = PendingArrivals(
                    x=cand.x, v=cand.v, w=cand.w * accepted,
                    alive=cand.alive & accepted, dest=dest)
                if blocks:
                    pend_g = PendingArrivals(*(
                        torch.cat([getattr(pend_g, f),
                                   getattr(blocks[0], f)], 2)
                        for f in _PENDING_FIELDS))
                w.pend[g] = pend_g
                dropped = (cand.alive & ~accepted).sum(-1, dtype=torch.int32)
                w.sts[g] = full
                dep_rows = pend_g
                dep_w = pend_g.w * pend_g.alive
            else:
                cand_all = cand if not blocks else StackedSpecies(*(
                    torch.cat([getattr(cand, f), getattr(blocks[0], f)], 2)
                    for f in _SPECIES_FIELDS))
                merged, dropped, accepted = _inject_rows(full, cand_all)
                w.sts[g] = merged
                dep_rows = cand_all
                dep_w = cand_all.w * accepted
            if plan.carried:
                with phase_scope("engine/merge/rho"):
                    for r in range(d):
                        w.rho_acc[r] = w.rho_acc[r] + deposit_windowed(
                            plan.grid, dep_rows.x[r],
                            charges[:, None] * dep_w[r])
            for j, i in enumerate(idxs):
                w.dacc(plan.cfg.species[i].name, "merge_dropped",
                       dropped[:, j].sum())
    w.rho_out = torch.stack(w.rho_acc) if plan.carried else w.state.rho


def _diag(plan: _Plan, w: _Work) -> dict:
    """The step's diagnostics: the queues' counters summed, and each
    species' count, energy, charge and queue occupancy over the resident
    rows plus the pending ones."""
    n_q, use_ring = plan.n_q, plan.ecfg.use_ring
    with phase_scope("engine/diag"):
        diag: dict = {}
        for key, v in w.contrib:
            diag[key] = diag[key] + v if key in diag else v
        for i, sc in enumerate(plan.cfg.species):
            g, j = plan.loc[i]
            st = w.sts[g]
            alive, wt, v = st.alive[:, j], st.w[:, j], st.v[:, j]
            count = alive.sum(dtype=torch.int32)
            wsum = _sum64(alive, wt)
            ke = _sum64(alive, (v * v).sum(-1) * wt)
            occ = _queue_occupancy(alive, n_q)          # (D, n_q)
            if use_ring:
                p = w.pend[g]
                pa = p.alive[:, j]
                count = count + pa.sum(dtype=torch.int32)
                wsum = wsum + _sum64(pa, p.w[:, j])
                ke = ke + _sum64(pa, (p.v[:, j] * p.v[:, j]).sum(-1)
                                 * p.w[:, j])
                q_of = torch.where(pa, p.dest[:, j].long() % n_q, n_q)
                hist = torch.zeros(plan.d, n_q + 1, dtype=torch.int32,
                                   device=w.dev)
                hist.scatter_add_(1, q_of, torch.ones_like(
                    q_of, dtype=torch.int32))
                occ = occ + hist[:, :n_q]
            diag[f"{sc.name}/count"] = count
            diag[f"{sc.name}/ke"] = 0.5 * sc.mass * ke
            diag[f"{sc.name}/charge"] = sc.charge * wsum
            diag[f"{sc.name}/queue_occ"] = occ.sum(0)
            diag[f"{sc.name}/queue_skew"] = (occ.max(-1).values
                                             - occ.min(-1).values).max()
            if plan.ecfg.metrics and use_ring:
                diag[f"{sc.name}/ring_free"] = w.rings[g].count[:, j].sum()
                diag[f"{sc.name}/pending_rows"] = w.pend[g].alive[
                    :, j].sum(dtype=torch.int32)
    return diag


def _release(w: _Work) -> None:
    """Free the step's working set (~900 tensors) in a scope, rather than
    unranged as the frame unwinds."""
    with phase_scope("engine/release"):
        for held in (w.keep, w.kept, w.births, w.contrib, w.recv, w.rrows,
                     w.rho_acc, w.done):
            held.clear()


def _sum64(mask: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Sum of the float32 ``a`` where ``mask``, accumulated in float64:
    exact for a sum of equal weights, whatever the split into domains."""
    return torch.where(mask, a, 0.0).sum(dtype=torch.float64)


def _merged(st_in: StackedSpecies, kept_g, n_q: int,
            into: bool = False) -> StackedSpecies:
    """The (D, S, cap) stack of every domain's merged queues (one domain's
    single queue as it is), written into ``st_in`` with ``into`` (the
    queues hold copies of its rows, or rows it no longer needs)."""
    if len(kept_g) == 1 and n_q == 1:
        return _map(kept_g[0][0], lambda a: a[None])
    out = st_in if into else _map(st_in, torch.empty_like)
    for r, qs in enumerate(kept_g):
        _merge_queues(qs, n_q, _map(out, lambda a, r=r: a[r]))
    return out


def _inject_rows(full: StackedSpecies, cand: StackedSpecies):
    """The legacy merge (``use_ring=False``): a full-scan
    ``inject_masked`` per domain and species, into a copy of ``full``.
    Returns (stack, dropped (D, S), accepted (D, S, M))."""
    d, s = full.x.shape[:2]
    out = _map(full, torch.clone)
    dropped = torch.zeros(d, s, dtype=torch.int32, device=full.x.device)
    accepted = torch.zeros_like(cand.alive)
    for r in range(d):
        for j in range(s):
            _, n_drop, ok = inject_masked(
                SpeciesBuffer(x=out.x[r, j], v=out.v[r, j], w=out.w[r, j],
                              alive=out.alive[r, j]),
                cand.x[r, j], cand.v[r, j], cand.w[r, j], cand.alive[r, j],
                donate=True)
            dropped[r, j] = n_drop
            accepted[r, j] = ok
    return out, dropped, accepted


def _domain_keys(seed: int, d: int) -> np.ndarray:
    """(D, 2) uint32: domain r's generator seed, (seed, r) folded into 64
    bits, as its high and low words."""
    s = np.array([(seed * 1_000_003 + r) % 2**64 for r in range(d)],
                 np.uint64)
    return np.stack([s >> np.uint64(32), s & np.uint64(0xFFFFFFFF)],
                    -1).astype(np.uint32)


def _key_seed(row) -> int:
    """The 64-bit integer of a (2,) uint32 key row."""
    hi, lo = (int(v) for v in np.asarray(row, np.uint32))
    return (hi << 32) | lo


def _gens_from_key(key: np.ndarray, device) -> tuple[torch.Generator, ...]:
    """One generator per domain, domain r seeded with the 64-bit integer of
    key row r: a port key gives each domain its initial generator back."""
    return tuple(torch.Generator(device=device).manual_seed(_key_seed(row))
                 for row in key)


def _assemble(ecfg: EngineConfig, species, key, step: int, rho,
              rings=None, pending=None, gens=None) -> EngineState:
    """An EngineState from per-species (D, cap_l) buffers, on their
    device: groups stacked, the carried rho deposited unless given, rings
    rebuilt from the alive masks (the init-time full scan) and pending
    empty unless given, generators seeded from ``key`` unless given."""
    cfg, d = ecfg.pic, ecfg.num_domains()
    dev = species[0].x.device
    groups = _capacity_groups(ecfg)
    key = np.asarray(key, np.uint32)
    if key.shape != (d, 2):
        raise ValueError(f"key has shape {key.shape}, expected ({d}, 2)")
    sts = tuple(StackedSpecies(
        x=torch.stack([species[i].x for i in idxs], 1).contiguous(),
        v=torch.stack([species[i].v for i in idxs], 1).contiguous(),
        w=torch.stack([species[i].w for i in idxs], 1).contiguous(),
        alive=torch.stack([species[i].alive for i in idxs], 1).contiguous())
        for idxs in groups)
    if rho is None and _carries_rho(ecfg):
        rho = _domain_rho(Grid1D(nc=ecfg.local_nc(), dx=cfg.dx), sts,
                          [_group_consts(cfg, idxs, dev)[2]
                           for idxs in groups])
    if not ecfg.use_ring:
        rings, pending = (), ()
    if rings is None:
        rings = [ring_init(st.alive) for st in sts]
    if pending is None:
        pending = [_empty_pending((d, len(idxs), m), st.x.shape[-1], dev)
                   for st, idxs, m in zip(sts, groups,
                                          _group_pending_rows(ecfg, groups))]
    if gens is None:
        gens = _gens_from_key(key, dev)
    return EngineState(groups=sts, group_species=tuple(groups), gens=gens,
                       key=key.copy(), step=int(step), rho=rho,
                       rings=tuple(rings), pending=tuple(pending))


def init_engine_state(ecfg: EngineConfig, seed: int = 0,
                      device="cuda") -> EngineState:
    """Per-domain init: each domain draws its n_init / D particles of each
    species uniform over its own slab, from its own generator."""
    dev = resolve_device(device)
    cfg = ecfg.pic
    d = ecfg.num_domains()
    l_local = ecfg.local_nc() * cfg.dx
    key = _domain_keys(seed, d)
    gens = _gens_from_key(key, dev)
    species = []
    for sc in cfg.species:
        bufs = [init_uniform(gens[r], ecfg.local_cap(sc), sc.n_init // d,
                             l_local, sc.vth, sc.drift, sc.weight)
                for r in range(d)]
        species.append(SpeciesBuffer(*(torch.stack([getattr(b, f)
                                                    for b in bufs])
                                       for f in ("x", "v", "w", "alive"))))
    return _assemble(ecfg, species, key, 0, None, gens=gens)


def attach_engine_state(ecfg: EngineConfig, state: PICState,
                        seed: int = 0) -> EngineState:
    """Wrap a PICState whose buffers carry a leading domain axis
    ((D, cap_l) species, (D, ncl + 1) rho; the usual ``[None]`` lift of a
    single-domain state): rings rebuilt from the alive masks, no in-flight
    arrivals, one generator per domain seeded from ``seed``."""
    return _assemble(ecfg, state.species,
                     _domain_keys(seed, ecfg.num_domains()), state.step,
                     state.rho)


def state_from_numpy(ecfg: EngineConfig, arrays: dict, seed: int = 0,
                     device="cuda") -> EngineState:
    """The port's state from numpy arrays (or tensors), e.g. the reference's
    EngineState exported with ``np.asarray``: ``arrays`` holds ``species``
    (per species a mapping of (D, cap_l) ``x``/``v``/``w``/``alive``),
    ``rings`` and ``pending`` (per capacity group, the reference's
    (D, S, ...) leaves), ``rho`` ((D, ncl + 1) or None), ``step`` and
    optionally ``key`` ((D, 2) uint32). The state keeps the key, and each
    domain's generator is seeded with its key row as one 64-bit integer (a
    port key holds the seeds themselves); without a key, the domains are
    seeded from ``seed`` as ``init_engine_state`` seeds them."""
    dev = resolve_device(device)

    def tt(a, dtype):
        if isinstance(a, torch.Tensor):
            return a.to(device=dev, dtype=dtype, copy=True)
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
    key = arrays.get("key")
    key = (_domain_keys(seed, ecfg.num_domains()) if key is None
           else np.asarray(key))
    return _assemble(ecfg, species, key, int(arrays["step"]), rho, rings,
                     pending)


def to_numpy(state: EngineState) -> dict:
    """The arrays of a state in the layout ``state_from_numpy`` takes (the
    reference's ``EngineState`` leaves)."""
    def a(t):
        return t.detach().cpu().numpy()

    return {
        "step": state.step,
        "key": state.key.copy(),
        "rho": None if state.rho is None else a(state.rho),
        "species": [{f: a(getattr(b, f)) for f in _SPECIES_FIELDS}
                    for b in state.species],
        "rings": [{f: a(getattr(rg, f)) for f in _RING_FIELDS}
                  for rg in state.rings],
        "pending": [{f: a(getattr(p, f)) for f in _PENDING_FIELDS}
                    for p in state.pending]}


# ------------------------------------------------------- checkpoint/restore
#
# A checkpoint holds the reference's EngineState leaves under the
# reference's key paths (``pic/species/<i>/x``, ``pic/key``, ``pic/step``,
# ``pic/rho``, ``rings/<g>/slots``, ``pending/<g>/dest``, ...), so either
# package restores the other's. ``state_tree`` is that layout as nested
# dicts and tuples; ``state_shape`` / ``state_shardings`` are the same tree
# of shapes and dtypes / of devices, the ``like`` and the placement of a
# typed restore onto the same domain count; ``resplit_host`` and
# ``elastic_state`` are the elastic path onto D' != D: host-side compaction
# and re-split, then a rebuild in closed form (rings from the alive counts,
# empty pending) that never runs the init-only full free-slot scan.


def state_tree(state: EngineState) -> dict:
    """The state as the reference's ``EngineState`` pytree: nested dicts
    and tuples of the state's own tensors (no copy), with ``pic/key`` the
    host key and ``pic/step`` a 0-d int32 array. Flattened, its key paths
    are the reference's checkpoint keys. The generators are not in it."""
    pic = {"species": tuple({f: getattr(b, f) for f in _SPECIES_FIELDS}
                            for b in state.species),
           "key": state.key, "step": np.asarray(state.step, np.int32)}
    if state.rho is not None:
        pic["rho"] = state.rho
    return {"pic": pic,
            "rings": tuple({f: getattr(rg, f) for f in _RING_FIELDS}
                           for rg in state.rings),
            "pending": tuple({f: getattr(p, f) for f in _PENDING_FIELDS}
                             for p in state.pending)}


def state_from_tree(ecfg: EngineConfig, tree: dict,
                    device="cuda") -> EngineState:
    """The inverse of ``state_tree``, from numpy arrays or tensors (a
    restored checkpoint); the generators are seeded from the key rows
    (``state_from_numpy``)."""
    pic = tree["pic"]
    return state_from_numpy(ecfg, {
        "species": list(pic["species"]), "key": np.asarray(pic["key"]),
        "step": int(pic["step"]), "rho": pic.get("rho"),
        "rings": list(tree["rings"]), "pending": list(tree["pending"])},
        device=device)


def _spec(shape, dtype) -> np.ndarray:
    """A leaf of ``state_shape``: an array of this shape and dtype that
    holds no memory (a broadcast zero)."""
    return np.broadcast_to(np.zeros((), dtype), shape)


def state_shape(ecfg: EngineConfig) -> dict:
    """The ``state_tree`` of this config with memoryless arrays of each
    leaf's shape and dtype: the ``like`` of a bitwise checkpoint
    restore."""
    cfg = ecfg.pic
    d = ecfg.num_domains()
    f32, i32 = np.float32, np.int32
    species = []
    for sc in cfg.species:
        cap = ecfg.local_cap(sc)
        species.append({"x": _spec((d, cap), f32),
                        "v": _spec((d, cap, 3), f32),
                        "w": _spec((d, cap), f32),
                        "alive": _spec((d, cap), bool)})
    pic = {"species": tuple(species), "key": _spec((d, 2), np.uint32),
           "step": _spec((), i32)}
    if _carries_rho(ecfg):
        pic["rho"] = _spec((d, ecfg.local_nc() + 1), f32)
    rings, pending = [], []
    if ecfg.use_ring:
        groups = _capacity_groups(ecfg)
        for idxs, m in zip(groups, _group_pending_rows(ecfg, groups)):
            s, cap = len(idxs), ecfg.local_cap(cfg.species[idxs[0]])
            rings.append({"slots": _spec((d, s, cap), i32),
                          "head": _spec((d, s), i32),
                          "count": _spec((d, s), i32)})
            pending.append({"x": _spec((d, s, m), f32),
                            "v": _spec((d, s, m, 3), f32),
                            "w": _spec((d, s, m), f32),
                            "alive": _spec((d, s, m), bool),
                            "dest": _spec((d, s, m), i32)})
    return {"pic": pic, "rings": tuple(rings), "pending": tuple(pending)}


def state_shardings(ecfg: EngineConfig, device="cuda") -> dict:
    """The device of each leaf of ``state_shape`` (the reference's
    NamedShardings): the port has no mesh to map onto, since its D domains
    are rows of tensors on one device, so every buffer lies on ``device``,
    and the key and the step, which the port keeps on the host, on the
    CPU."""
    dev = resolve_device(device)
    host = torch.device("cpu")

    def place(tree, on):
        if isinstance(tree, dict):
            return {k: place(v, host if k in ("key", "step") else on)
                    for k, v in tree.items()}
        if isinstance(tree, tuple):
            return tuple(place(v, on) for v in tree)
        return on

    return place(state_shape(ecfg), dev)


def retarget_state(old: EngineConfig, new: EngineConfig,
                   state: EngineState) -> EngineState:
    """Carry a live EngineState across an engine-knob change (auto-tuner).

    Knobs that leave the state's layout alone (``async_n``,
    ``rebalance_every``, ``rebalance_skew``, ``cell_order``, ``metrics``)
    return the state itself. The budget knobs (``max_migration``,
    ``max_births``) size ``EngineState.pending``, so those retunes flush
    the in-flight arrivals into their pre-claimed slots (the scatter the
    next ingest would have done), rebuild the free-slot rings from the
    alive masks (the one full scan the ring design allows outside init),
    and attach empty pending blocks sized for the new config. The carried
    rho already includes the pending rows' deposits, so it carries over
    untouched. The physics config must be identical, and so must the
    domains and local capacities (another domain count is the elastic
    restore's work).
    """
    if old.pic != new.pic:
        raise ValueError(
            "retarget_state only retunes engine knobs; the physics config "
            "(EngineConfig.pic) must be identical")
    if (old.domains != new.domains
            or old.species_capacity_local != new.species_capacity_local):
        raise ValueError(
            "retarget_state keeps the domains and local capacities; a new "
            "domain count goes through the elastic restore "
            "(resplit_host + elastic_state)")
    groups_old = _capacity_groups(old)
    groups_new = _capacity_groups(new)
    if (old.use_ring == new.use_ring and groups_old == groups_new
            and _group_pending_rows(old, groups_old)
            == _group_pending_rows(new, groups_new)):
        return state  # same layout: the next step takes it as it is
    sts = [_flush_pending(st, p, inplace=False)
           for st, p in zip(state.groups, state.pending)] \
        if old.use_ring else list(state.groups)
    species = dataclasses.replace(state, groups=tuple(sts)).species
    return _assemble(new, species, state.key, state.step, state.rho,
                     gens=state.gens)


def resplit_host(ecfg: EngineConfig, flat: dict, *, d_old: int):
    """Host-side elastic re-split of a checkpointed EngineState.

    ``flat`` is the ``{keypath: host array}`` dict of a checkpoint taken at
    ``d_old`` domains (``Checkpointer.restore_flat``); ``ecfg.domains`` is
    the new count. On host numpy: flush every in-flight pending row into
    its pre-claimed slot (the scatter the next ingest would have done),
    globalize positions, reassign each alive particle to its new domain by
    position, and compact per new domain (alive first, checkpoint order
    within a domain).

    Returns ``(species, counts)``: per-species dicts of ``(D', cap')``
    host arrays plus a ``(D', S)`` alive-count matrix, the closed-form
    inputs ``elastic_state`` rebuilds rings from without a full-capacity
    scan. Raises ``ValueError`` if a new domain's population exceeds its
    local capacity (re-split cannot invent headroom).
    """
    cfg = ecfg.pic
    d_new = ecfg.num_domains()
    if cfg.nc % d_old != 0 or cfg.nc % d_new != 0:
        raise ValueError(
            f"nc={cfg.nc} must divide both the checkpoint domains "
            f"({d_old}) and the current domains ({d_new})")
    old = dataclasses.replace(ecfg, domains=d_old)
    l_old = (cfg.nc // d_old) * cfg.dx
    l_new = (cfg.nc // d_new) * cfg.dx
    nsp = len(cfg.species)

    # typed host buffers, one per species, with pending flushed in
    bufs = [{f: np.array(flat[f"pic/species/{i}/{f}"])
             for f in _SPECIES_FIELDS} for i in range(nsp)]
    for g, idxs in enumerate(_capacity_groups(old)):
        if f"pending/{g}/dest" not in flat:
            continue                      # legacy (use_ring=False) ckpt
        pend = {f: np.asarray(flat[f"pending/{g}/{f}"])
                for f in _PENDING_FIELDS}
        for j, i in enumerate(idxs):
            cap_old = bufs[i]["x"].shape[1]
            ok = pend["alive"][:, j] & (pend["dest"][:, j] < cap_old)
            for r in range(d_old):
                dst = pend["dest"][r, j][ok[r]]
                bufs[i]["x"][r, dst] = pend["x"][r, j][ok[r]]
                bufs[i]["v"][r, dst] = pend["v"][r, j][ok[r]]
                bufs[i]["w"][r, dst] = pend["w"][r, j][ok[r]]
                bufs[i]["alive"][r, dst] = True

    species_out, counts = [], np.zeros((d_new, nsp), np.int32)
    for i, sc in enumerate(cfg.species):
        cap_new = ecfg.local_cap(sc)
        b = bufs[i]
        alive = b["alive"].astype(bool)
        # globalize in f64 (exact for f32 inputs), localize, cast back
        off = l_old * np.arange(d_old, dtype=np.float64)[:, None]
        xs = (b["x"].astype(np.float64) + off)[alive]
        vs, ws = b["v"][alive], b["w"][alive]
        r_new = np.clip(np.floor(xs / l_new).astype(np.int64), 0, d_new - 1)
        xdt = b["x"].dtype
        xl = (xs - r_new * l_new).astype(xdt)
        xl = np.clip(xl, xdt.type(0),
                     np.nextafter(xdt.type(l_new), xdt.type(0)))
        nx = np.zeros((d_new, cap_new), xdt)
        nv = np.zeros((d_new, cap_new, 3), b["v"].dtype)
        nw = np.zeros((d_new, cap_new), b["w"].dtype)
        na = np.zeros((d_new, cap_new), bool)
        for r in range(d_new):
            sel = r_new == r             # keeps the checkpoint order
            n_r = int(sel.sum())
            if n_r > cap_new:
                raise ValueError(
                    f"species {i}: {n_r} particles land on domain {r} but "
                    f"the local capacity at D={d_new} is {cap_new}")
            nx[r, :n_r], nv[r, :n_r] = xl[sel], vs[sel]
            nw[r, :n_r], na[r, :n_r] = ws[sel], True
            counts[r, i] = n_r
        species_out.append({"x": nx, "v": nv, "w": nw, "alive": na})
    return species_out, counts


def elastic_state(ecfg: EngineConfig, species, counts, key0, step: int = 0,
                  device="cuda") -> EngineState:
    """An EngineState from host-compacted per-domain buffers.

    ``species``/``counts`` come from ``resplit_host``. Rings are rebuilt in
    closed form from the alive counts (``ring_from_counts``: compaction
    makes the free set a contiguous tail, so no full-capacity scan),
    pending starts empty, the carried rho is deposited anew, and the
    per-domain generators and key are derived from ``key0`` (its 64-bit
    integer as the seed) as ``init_engine_state`` derives them from its
    seed. An elastic restart is therefore deterministic given the
    checkpoint, but not bitwise-continuous with the streams before it.
    """
    dev = resolve_device(device)
    f32 = torch.float32
    bufs = [SpeciesBuffer(
        x=torch.tensor(s["x"], dtype=f32, device=dev),
        v=torch.tensor(s["v"], dtype=f32, device=dev),
        w=torch.tensor(s["w"], dtype=f32, device=dev),
        alive=torch.tensor(s["alive"], dtype=torch.bool, device=dev))
        for s in species]
    key = _domain_keys(_key_seed(key0), ecfg.num_domains())
    rings = None
    if ecfg.use_ring:
        cnt = torch.tensor(np.asarray(counts), dtype=torch.int32, device=dev)
        rings = [ring_from_counts(cnt[:, list(idxs)],
                                  ecfg.local_cap(ecfg.pic.species[idxs[0]]))
                 for idxs in _capacity_groups(ecfg)]
    return _assemble(ecfg, bufs, key, step, None, rings)
