"""Fixed-capacity SoA particle buffers (the port of ``repro.core.particles``).

A species is a dense structure of arrays with a fixed capacity and an
``alive`` mask: birth writes into dead slots found by a prefix sum, death
clears the mask. Dead slots carry ``w == 0``. Functions return new buffers
and leave their inputs unchanged, as the reference's do.

Monte-Carlo functions take ``draws=``: a dict of the raw random arrays they
would otherwise draw from their ``torch.Generator`` (``"uniform"`` in
[0, 1), ``"normal"`` standard normal). Tests hand in the reference's draws.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch


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
