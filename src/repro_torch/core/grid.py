"""1D grid geometry, CIC charge deposition and field gather (the port of
``repro.core.grid``).

The grid has ``nc`` cells of width ``dx``; rho, phi and E live on the
``nc + 1`` nodes. Every deposit goes through ``deposit_windowed``, which is
the CIC deposit kernel on a CUDA tensor and its plain version on the CPU.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.particles import SpeciesBuffer
from repro_torch.kernels import ops
from repro_torch.kernels.mover import cic


@dataclasses.dataclass(frozen=True)
class Grid1D:
    nc: int          # number of cells owned by this domain
    dx: float
    x0: float = 0.0  # left edge (global coordinate of node 0)

    @property
    def ng(self) -> int:       # nodes
        return self.nc + 1

    @property
    def length(self) -> float:
        return self.nc * self.dx

    def nodes(self, device="cuda") -> torch.Tensor:
        return self.x0 + torch.arange(self.ng, device=device) * self.dx


def _cic_weights(grid: Grid1D, x: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Left node index i (int64, in [0, nc-1]) and fraction f in [0, 1], at
    s = (x - x0) * inv_dx, the kernels' cell coordinate."""
    return cic(x, grid.x0, grid.dx, grid.nc)


def deposit_windowed(grid: Grid1D, x: torch.Tensor,
                     q: torch.Tensor) -> torch.Tensor:
    """CIC deposition of charge q at x (any shape, flattened) -> (ng,)/dx.
    Flattening is how the stacked multi-species deposit becomes one pass."""
    xf = x.reshape(-1).contiguous()
    qf = q.reshape(-1).to(xf.dtype).contiguous()
    return ops.deposit(xf, qf, x0=grid.x0, dx=grid.dx, nc=grid.nc)


def deposit(grid: Grid1D, buf: SpeciesBuffer, charge: float) -> torch.Tensor:
    """Charge density on nodes from one species (CIC / linear weighting)."""
    return deposit_windowed(grid, buf.x, charge * buf.w * buf.alive)


def deposit_stacked(grid: Grid1D, x: torch.Tensor, w: torch.Tensor,
                    alive: torch.Tensor,
                    charges: torch.Tensor) -> torch.Tensor:
    """Total charge density from stacked (S, cap) species in one deposit;
    ``charges`` is (S,), and neutral species ride along at zero charge."""
    return deposit_windowed(grid, x, charges[:, None] * w * alive)


def deposit_density(grid: Grid1D, buf: SpeciesBuffer) -> torch.Tensor:
    """Number density on nodes (charge = +1), used by the MC rates."""
    return deposit(grid, buf, 1.0)


def gather(grid: Grid1D, field: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Interpolate a node field to particle positions (CIC)."""
    i, f = _cic_weights(grid, x)
    return field[i] * (1.0 - f) + field[i + 1] * f


def gather_onehot(grid: Grid1D, field: torch.Tensor,
                  x: torch.Tensor) -> torch.Tensor:
    """The same interpolation as a one-hot (N, ng) product with the field
    (the reference's matrix-unit form of the gather)."""
    i, f = _cic_weights(grid, x)
    ng = grid.ng
    left = torch.nn.functional.one_hot(i, ng).to(field.dtype)
    right = torch.nn.functional.one_hot(i + 1, ng).to(field.dtype)
    w = left * (1.0 - f)[:, None] + right * f[:, None]
    return w @ field
