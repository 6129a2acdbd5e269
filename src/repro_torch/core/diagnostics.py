"""Per-step diagnostics: the quantities BIT1 reports (the port of
``repro.core.diagnostics``)."""

from __future__ import annotations

import torch

from repro_torch.core.grid import Grid1D
from repro_torch.core.particles import SpeciesBuffer


def kinetic_energy(sp: SpeciesBuffer, mass: float) -> torch.Tensor:
    ke = 0.5 * mass * torch.sum(sp.v * sp.v, dim=-1)
    return torch.sum(torch.where(sp.alive, ke * sp.w, 0.0))


def field_energy(e: torch.Tensor, grid: Grid1D,
                 eps0: float = 1.0) -> torch.Tensor:
    return 0.5 * eps0 * torch.sum(e * e) * grid.dx


def total_charge(sp: SpeciesBuffer, charge: float) -> torch.Tensor:
    return charge * torch.sum(torch.where(sp.alive, sp.w, 0.0))


def momentum(sp: SpeciesBuffer, mass: float) -> torch.Tensor:
    return mass * torch.sum(
        torch.where(sp.alive[:, None], sp.v * sp.w[:, None], 0.0), dim=0)
