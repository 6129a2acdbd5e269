"""The entry to the kernels: each function picks by the tensor's device.

A CUDA tensor launches the hand-written kernel (``kernels/*.py`` +
``csrc/*.cu``), and a failed build or launch raises. A CPU tensor takes the
kernel's plain PyTorch version, because the caller asked for the CPU. Any
other device raises. Units follow the reference's ``kernels/ops.py``: rho
comes back as (nc+1,)/dx, with a carried rho added outside the kernel.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import deposit as _deposit
from repro_torch.kernels import fused_cycle as _fused
from repro_torch.kernels import mover as _mover


def _on_card(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel for tensors on {t.device}: the port runs "
                     f"on 'cuda' (kernels) or 'cpu' (plain versions)")


def mover_push(x, v, alive, e, *, x0: float, dx: float, nc: int,
               length: float, qm: float, dt: float,
               b: tuple[float, float, float] = (0.0, 0.0, 0.0),
               boundary: str = "periodic"):
    """Mover for one species. x (n,), v (n, 3), alive (n,) bool, e (nc+1,).
    Returns (x, v, alive, hit_left, hit_right)."""
    fn = _mover.mover_push if _on_card(x) else _mover.mover_push_plain
    return fn(x, v, alive, e, x0=x0, dx=dx, nc=nc, length=length,
              qm_dt=qm * dt, dt=dt, b=b, boundary=boundary)


def fused_push_deposit(x, v, w, alive, e, qm_dt, dt, charge, rho_carry=None,
                       *, x0: float, dx: float, nc: int, length: float,
                       b: tuple[float, float, float] = (0.0, 0.0, 0.0),
                       boundary: str = "periodic", deposit: bool = True):
    """Fused push + deposit over stacked species: x, w, alive (S, cap),
    v (S, cap, 3), e (nc+1,), qm_dt/dt/charge (S,) float32.

    Returns (x, v, alive, hit_left, hit_right, w, rho): rho is the post-push
    charge density (nc+1,)/dx, plus ``rho_carry`` when one is given, or None
    when ``deposit`` is False.
    """
    fn = (_fused.fused_push_deposit if _on_card(x)
          else _fused.fused_push_deposit_plain)
    *out, rho = fn(x, v, w, alive, e, qm_dt, dt, charge, x0=x0, dx=dx, nc=nc,
                   length=length, b=b, boundary=boundary, deposit=deposit)
    if rho is not None:
        rho = rho / dx
        if rho_carry is not None:
            rho = rho_carry + rho
    return (*out, rho)


def deposit(x: torch.Tensor, q: torch.Tensor, *, x0: float, dx: float,
            nc: int) -> torch.Tensor:
    """CIC deposition of charge q (n,) at positions x (n,) -> (nc+1,)/dx."""
    fn = _deposit.deposit if _on_card(x) else _deposit.deposit_plain
    return fn(x, q, x0=x0, dx=dx, nc=nc) / dx
