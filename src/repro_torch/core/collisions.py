"""Monte-Carlo ionization, the paper's §3.3 source (the ionization half of
``repro.core.collisions``), and the collision-menu configuration.

Electron-impact ionization depletes neutrals as dn/dt = -n n_e R. Per
macro-neutral per step, P = 1 - exp(-n_e(x) R dt) with n_e gathered from
the deposited electron density; an ionized neutral dies and spawns an
(e-, D+) pair at its position: the ion inherits its velocity, the electron
samples a Maxwellian. A pair is born only when both buffers have a free
slot; a refused neutral survives and retries (``birth_overflow``).

The binary-collision operators are not ported yet: ``CollisionConfig`` and
``validate_menu`` are here so that ``PICConfig`` validates as the
reference's does, and the cycle refuses a non-empty menu.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import torch

from repro_torch.core.grid import Grid1D, deposit_density, gather
from repro_torch.core.particles import SpeciesBuffer, inject_masked, kill


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
           ) -> tuple[SpeciesBuffer, SpeciesBuffer, SpeciesBuffer, dict,
                      IonizationBirths]:
    """One MC ionization step over the full buffers.

    Returns (neutrals, electrons, ions, diag, births).
    """
    if ne is None:
        ne = deposit_density(grid, electrons)
    ne_at = gather(grid, ne, neutrals.x)
    hit, ve = ionization_events(gen, neutrals.x, neutrals.alive, ne_at,
                                params, dt, draws)

    # the k-th hit is allowed iff both buffers still have a k-th free slot,
    # so inject_masked cannot drop an allowed birth
    rank = torch.cumsum(hit, 0) - 1
    free_e = (~electrons.alive).sum()
    free_i = (~ions.alive).sum()
    allowed = hit & (rank < torch.minimum(free_e, free_i))

    electrons, dropped_e, _ = inject_masked(electrons, neutrals.x, ve,
                                            neutrals.w, allowed)
    ions, dropped_i, _ = inject_masked(ions, neutrals.x, neutrals.v,
                                       neutrals.w, allowed)
    births = IonizationBirths(x=neutrals.x, v_electron=ve, v_ion=neutrals.v,
                              w=neutrals.w, ok=allowed)
    neutrals = kill(neutrals, allowed)

    diag = {
        "n_ionized": allowed.sum(dtype=torch.int32),
        "ionize_dropped": dropped_e + dropped_i,      # structurally zero
        "birth_overflow": (hit & ~allowed).sum(dtype=torch.int32),
    }
    return neutrals, electrons, ions, diag, births


COLLISION_KINDS = ("elastic", "charge_exchange", "coulomb")


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
