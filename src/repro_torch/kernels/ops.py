"""The entry to the kernels: each function picks by the tensor's device.

A CUDA tensor launches the hand-written kernel (``kernels/*.py`` +
``csrc/*.cu``), and a failed build or launch raises. A CPU tensor takes the
kernel's plain PyTorch version, because the caller asked for the CPU. Any
other device raises. Units follow the reference's ``kernels/ops.py``: rho
comes back as (nc+1,)/dx, with a carried rho added outside the kernel.
Attention takes the model's (B, S, H, D) layout, or the reference's
head-folded (bh, s, hd).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import births as _births
from repro_torch.kernels import collide as _collide
from repro_torch.kernels import deposit as _deposit
from repro_torch.kernels import flash_attention as _flash  # noqa: F401 (registers repro_torch::flash_attention)
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
        rho = rho * _mover.inv_dx(dx)
        if rho_carry is not None:
            rho = rho_carry + rho
    return (*out, rho)


def deposit(x: torch.Tensor, q: torch.Tensor, *, x0: float, dx: float,
            nc: int) -> torch.Tensor:
    """CIC deposition of charge q (n,) at positions x (n,) -> (nc+1,)/dx."""
    fn = _deposit.deposit if _on_card(x) else _deposit.deposit_plain
    return fn(x, q, x0=x0, dx=dx, nc=nc) * _mover.inv_dx(dx)


def ta_kick(u: torch.Tensor, delta: torch.Tensor,
            phi: torch.Tensor) -> torch.Tensor:
    """Takizuka-Abe deflection of pair relative velocities u (M, 3) by
    tan(theta/2) = delta (M,) about azimuth phi (M,): du (M, 3) with
    |u + du| = |u|."""
    fn = _collide.ta_kick if _on_card(u) else _collide.ta_kick_plain
    return fn(u, delta, phi)


def coulomb_pairs(order: torch.Tensor, cell: torch.Tensor, v: torch.Tensor,
                  n_cell: torch.Tensor, nrm: torch.Tensor, phi: torch.Tensor,
                  rate, dt) -> tuple[torch.Tensor, torch.Tensor]:
    """Takizuka-Abe Coulomb pairs of a cell-shuffled ``order`` (n,): rows
    at even offsets of their cell's segment pair with their successor,
    deflect by tan(theta/2) = sqrt(rate n_cell dt / |u|^3) ``nrm`` about
    azimuth ``phi``, and take half the kick each. ``cell`` (n,) int32 parks
    ineligible rows at nc = len(``n_cell``). Returns (v (n, 3), n_pairs)."""
    fn = (_collide.coulomb_pairs if _on_card(v)
          else _collide.coulomb_pairs_plain)
    return fn(order, cell, v, n_cell, nrm, phi, rate, dt)


def cell_density(x: torch.Tensor, alive: torch.Tensor, w: torch.Tensor, *,
                 dx: float, nc: int, length: float) -> torch.Tensor:
    """Per-cell density (nc,)/dx: the sum of the weights w (n,) of the rows
    alive inside [0, length), by cell floor(x * inv_dx(dx)) clamped to
    [0, nc - 1]."""
    fn = (_collide.cell_density if _on_card(x)
          else _collide.cell_density_plain)
    return fn(x, alive, w, dx=dx, nc=nc, length=length) * _mover.inv_dx(dx)


def place_births_(mask: torch.Tensor, dests, srcs, kill=None
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Land the ``mask``-selected candidates (M,) in place: the k-th in
    index order goes to the k-th dead slot of each target of ``dests``
    ((x, v, w, alive) each, one or two), from the matching rows of ``srcs``
    ((x, v, w) each), for k below min(hits, each target's free count);
    ``kill`` ((alive, w) of the candidates' own buffer) loses the landed
    rows. Returns (ok (M,) bool, n () int32 landed, dropped () int32)."""
    fn = (_births.place_births if _on_card(mask)
          else _births.place_births_plain)
    return fn(mask, dests, srcs, kill)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Masked online-softmax attention, the function of the reference's
    ``chunked_attention``: q (B, Sq, H, D) against k, v (B, Skv, KVH, D),
    H a multiple of KVH; or the reference kernel's head-folded signature,
    q (bh, sq, hd) against k, v (bh, skv, hd). Returns q's shape and dtype.

    The call goes through the registered operator
    ``torch.ops.repro_torch.flash_attention``, which a DTensor (by its
    sharding rule) and a fake tensor (by its fake implementation) can enter
    too; a CUDA tensor reaches the kernel, a CPU tensor its plain version."""
    _on_card(q)
    fn = torch.ops.repro_torch.flash_attention
    if q.dim() == 3:
        return fn(q.unsqueeze(2), k.unsqueeze(2), v.unsqueeze(2), causal,
                  window).squeeze(2)
    return fn(q, k, v, causal, window)
