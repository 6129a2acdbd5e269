"""Field solve for the 1D electrostatic cycle: smoother, Poisson, E (the
port of ``repro.core.fields``)."""

from __future__ import annotations

import torch

from repro_torch.kernels.mover import inv_dx


def reciprocal(v: float, dtype: torch.dtype) -> float:
    """1/v in ``dtype``'s precision: the float32 reciprocal for float32."""
    return inv_dx(v) if dtype == torch.float32 else 1.0 / v


def solve_poisson(rho: torch.Tensor, dx: float, eps0: float = 1.0,
                  phi_left: float = 0.0, phi_right: float = 0.0
                  ) -> torch.Tensor:
    """phi on nodes solving -phi'' = rho/eps0, Dirichlet walls.

    Exact solution of the discrete (-1, 2, -1)/dx^2 system by double
    cumulative sum: with f_i = rho_i dx^2 / eps0 and g_i = phi_{i+1} - phi_i,
    g_i = g_0 - cumsum(f)_i, so
    phi_i = phi_0 + i g_0 - cumsum(cumsum(f))_{i-1}; g_0 follows from the
    right boundary value. The sums run in rho's dtype; the cycle passes
    float64 (see ``pic.field_from_rho``).
    """
    ng = rho.shape[0]
    f = rho * (dx * dx) / eps0
    s1 = torch.cumsum(f, 0)
    inner = s1 - f[0]
    s2 = torch.cumsum(inner, 0)
    i = torch.arange(ng, dtype=rho.dtype, device=rho.device)
    s2m1 = torch.cat([torch.zeros(1, dtype=rho.dtype, device=rho.device),
                      s2[:-1]])
    n = ng - 1
    g0 = (phi_right - phi_left + s2[n - 1]) / n
    phi = phi_left + i * g0 - s2m1
    phi[0] = phi_left
    phi[-1] = phi_right
    return phi


def thomas(dl: torch.Tensor, d: torch.Tensor, du: torch.Tensor,
           b: torch.Tensor) -> torch.Tensor:
    """Generic tridiagonal solve (Thomas algorithm), in the diagonals'
    dtype. dl/d/du: sub/main/super diagonals (dl[0] and du[-1] ignored),
    b: right-hand side. Sequential in n, as the reference's ``lax.scan``:
    the substrate for non-uniform systems; the uniform Poisson system uses
    the prefix-sum solver above."""
    n = d.shape[0]
    cp = torch.empty_like(d)
    dp = torch.empty_like(d)
    cp_prev = dp_prev = torch.zeros((), dtype=d.dtype, device=d.device)
    for i in range(n):
        denom = d[i] - dl[i] * cp_prev
        cp[i] = du[i] / denom
        dp[i] = (b[i] - dl[i] * dp_prev) / denom
        cp_prev, dp_prev = cp[i], dp[i]
    xs = torch.empty_like(d)
    x_next = torch.zeros((), dtype=d.dtype, device=d.device)
    for i in range(n - 1, -1, -1):
        xs[i] = dp[i] - cp[i] * x_next
        x_next = xs[i]
    return xs


def efield(phi: torch.Tensor, dx: float) -> torch.Tensor:
    """E = -dphi/dx on nodes (centred inside, one-sided at the walls). The
    differences are multiplied by the reciprocals of 2 dx and dx, as jitted
    JAX rounds the reference's divisions (float32 reciprocals for a float32
    phi)."""
    e = torch.empty_like(phi)
    e[1:-1] = -(phi[2:] - phi[:-2]) * reciprocal(2.0 * dx, phi.dtype)
    e[0] = -(phi[1] - phi[0]) * reciprocal(dx, phi.dtype)
    e[-1] = -(phi[-1] - phi[-2]) * reciprocal(dx, phi.dtype)
    return e


def smooth_binomial(f: torch.Tensor, passes: int = 1) -> torch.Tensor:
    """BIT1's density smoother: (1/4, 1/2, 1/4) binomial filter, with a
    (3/4, 1/4) one-sided stencil at the walls to conserve the integral."""
    for _ in range(passes):
        inner = 0.25 * f[:-2] + 0.5 * f[1:-1] + 0.25 * f[2:]
        left = 0.75 * f[0] + 0.25 * f[1]
        right = 0.25 * f[-2] + 0.75 * f[-1]
        f = torch.cat([left[None], inner, right[None]])
    return f
