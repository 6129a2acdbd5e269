"""The particle mover (the port of ``repro.core.mover``).

Strategies, as in the reference:

* ``unified``  — plain PyTorch push (``_push_core`` with ``apply_boundary``);
* ``explicit`` — the mover kernel, one launch per species;
* ``async_batched`` — the unified push over particle batches;
* ``fused``    — push + post-push deposit in one pass: the fused kernel.

``push_stacked`` (the cycle's path when all species share one capacity,
serving ``unified`` and ``fused``) and ``push_fused`` run the fused kernel,
``push_explicit`` the mover kernel; on CPU tensors each takes the kernel's
plain version (``kernels/ops.py``). The kernels wrap a periodic position as
x - floor(x * float32(1/L)) * L (jitted JAX's rounding of x/L) and park absorbed particles at L*(1-1e-7), as the
reference's kernels do; ``apply_boundary`` keeps the reference's mod and
nextafter. Every strategy returns a ``PushResult`` with the wall-hit masks
of this push, which the wall-emission source consumes.

Physics: non-relativistic Boris push, 1D3V. E = (Ex(x), 0, 0) gathered from
the node field; an optional constant background B rotates the velocity.
"""

from __future__ import annotations

import dataclasses
from typing import Literal, NamedTuple

import torch

from repro_torch.core.grid import Grid1D, gather, gather_onehot
from repro_torch.core.particles import SpeciesBuffer, StackedSpecies
from repro_torch.kernels import ops

Strategy = Literal["unified", "explicit", "async_batched", "fused"]
# 'open': leave positions raw (a decomposed step routes crossers elsewhere)
Boundary = Literal["periodic", "absorb", "open"]

STRATEGIES = ("unified", "explicit", "async_batched", "fused")
BOUNDARIES = ("periodic", "absorb", "open")


class PushResult(NamedTuple):
    """What one mover invocation produces: the pushed buffer, per-slot wall
    masks (all False unless ``boundary='absorb'``), the wall diagnostics and
    the post-push charge density (fused strategy with a deposit only)."""

    buf: SpeciesBuffer
    hit_left: torch.Tensor
    hit_right: torch.Tensor
    diag: dict
    rho: torch.Tensor | None = None


def boris_kick(v: torch.Tensor, e_x: torch.Tensor, qm_dt,
               b=(0.0, 0.0, 0.0)) -> torch.Tensor:
    """Boris rotation push. v: (N, 3); e_x: (N,) field at particles. ``b``
    is a (bx, by, bz) tuple (all zero skips the rotation) or a (3,) tensor."""
    half = 0.5 * qm_dt
    vm = v.clone()
    vm[:, 0] = vm[:, 0] + half * e_x              # half electric kick
    if isinstance(b, torch.Tensor) or any(c != 0.0 for c in b):
        t = torch.as_tensor(b, dtype=v.dtype, device=v.device) * half
        t2 = torch.dot(t, t)
        s = 2.0 * t / (1.0 + t2)
        vprime = vm + torch.linalg.cross(vm, t.expand_as(vm), dim=-1)
        vp = vm + torch.linalg.cross(vprime, s.expand_as(vm), dim=-1)
    else:
        vp = vm
    vp[:, 0] = vp[:, 0] + half * e_x              # second half kick
    return vp


def apply_boundary(x: torch.Tensor, alive: torch.Tensor, length: float,
                   boundary: Boundary):
    """Returns (x, alive, absorbed_left, absorbed_right masks)."""
    none = torch.zeros_like(alive)
    if boundary == "open":
        return x, alive, none, none
    if boundary == "periodic":
        return torch.remainder(x, length), alive, none, none
    hit_l = alive & (x < 0.0)
    hit_r = alive & (x >= length)
    new_alive = alive & ~(hit_l | hit_r)
    # park dead particles inside the domain so cell indices stay valid
    top = torch.nextafter(torch.tensor(length, dtype=x.dtype),
                          torch.tensor(0.0, dtype=x.dtype)).item()
    return torch.clamp(x, 0.0, top), new_alive, hit_l, hit_r


def _wall_diag(v: torch.Tensor, w: torch.Tensor, hl: torch.Tensor,
               hr: torch.Tensor) -> dict:
    """Divertor diagnostics: particle and energy flux absorbed at each wall.
    ``w`` is the weight before the push: an absorbed particle's w is zero
    after it."""
    ke = 0.5 * torch.sum(v * v, dim=-1) * w
    return {
        "absorbed_left": hl.sum(dim=-1, dtype=torch.int32),
        "absorbed_right": hr.sum(dim=-1, dtype=torch.int32),
        "power_left": torch.where(hl, ke, 0.0).sum(dim=-1),
        "power_right": torch.where(hr, ke, 0.0).sum(dim=-1),
    }


def _push_core(x, v, alive, e, grid: Grid1D, qm_dt, dt, b, boundary,
               gather_mode: str):
    """Gather + Boris + drift + boundary on raw tensors (plain PyTorch)."""
    g = gather_onehot if gather_mode == "onehot" else gather
    e_x = g(grid, e, x) * alive
    v = boris_kick(v, e_x, qm_dt, b)
    x = x + v[:, 0] * dt
    x, alive, hl, hr = apply_boundary(x, alive, grid.length, boundary)
    return x, v, alive, hl, hr


def push_unified(buf: SpeciesBuffer, e: torch.Tensor, grid: Grid1D,
                 qm: float, dt, b=(0.0, 0.0, 0.0),
                 boundary: Boundary = "periodic",
                 gather_mode: str = "take",
                 qm_dt: torch.Tensor | None = None) -> PushResult:
    """Plain PyTorch mover (the 'unified' strategy). ``qm_dt`` (optional)
    replaces the host product ``qm * dt``: the runtime-parameter path hands
    it in formed on the host, so the step stays bit-identical to the
    static one."""
    x, v, alive, hl, hr = _push_core(buf.x, buf.v, buf.alive, e, grid,
                                     qm * dt if qm_dt is None else qm_dt,
                                     dt, b, boundary, gather_mode)
    diag = _wall_diag(v, buf.w, hl, hr)
    out = dataclasses.replace(buf, x=x, v=v, alive=alive, w=buf.w * alive)
    return PushResult(out, hl, hr, diag)


def push_explicit(buf: SpeciesBuffer, e: torch.Tensor, grid: Grid1D,
                  qm: float, dt: float, b=(0.0, 0.0, 0.0),
                  boundary: Boundary = "periodic") -> PushResult:
    """The mover kernel (the 'explicit' strategy)."""
    x, v, alive, hl, hr = ops.mover_push(
        buf.x, buf.v, buf.alive, e, x0=grid.x0, dx=grid.dx, nc=grid.nc,
        length=grid.length, qm=qm, dt=dt, b=b, boundary=boundary)
    diag = _wall_diag(v, buf.w, hl, hr)
    out = dataclasses.replace(buf, x=x, v=v, alive=alive, w=buf.w * alive)
    return PushResult(out, hl, hr, diag)


def push_fused(buf: SpeciesBuffer, e: torch.Tensor, grid: Grid1D, qm: float,
               dt, b=(0.0, 0.0, 0.0), boundary: Boundary = "periodic",
               gather_mode: str = "take",
               deposit_charge: float | None = None,
               rho_carry: torch.Tensor | None = None,
               qm_dt: torch.Tensor | None = None) -> PushResult:
    """Single-pass push + deposit (the 'fused' strategy): the fused kernel
    with one species. With ``deposit_charge``, the post-push charge density
    ``deposit_charge * w * alive`` (plus ``rho_carry``) lands in
    ``PushResult.rho``. ``dt`` is a float or a 0-d tensor; ``qm_dt``
    (optional) replaces ``qm * dt``, as in ``push_unified``. The kernel's
    gather is CIC; ``gather_mode`` is accepted for the reference's
    signature."""
    del gather_mode
    dev = buf.x.device
    x, v, alive, hl, hr, w, rho = ops.fused_push_deposit(
        buf.x[None], buf.v[None], buf.w[None], buf.alive[None], e,
        _vec1(qm * dt if qm_dt is None else qm_dt, dev), _vec1(dt, dev),
        _vec1(deposit_charge or 0.0, dev), rho_carry, x0=grid.x0,
        dx=grid.dx, nc=grid.nc, length=grid.length,
        b=b, boundary=boundary, deposit=deposit_charge is not None)
    diag = _wall_diag(v[0], buf.w, hl[0], hr[0])
    out = SpeciesBuffer(x=x[0], v=v[0], w=w[0], alive=alive[0])
    return PushResult(out, hl[0], hr[0], diag, rho)


def _vec1(a, dev) -> torch.Tensor:
    """A float or 0-d tensor as the (1,) float32 tensor the fused kernel
    takes a per-species scalar in."""
    if isinstance(a, torch.Tensor):
        return a.to(device=dev, dtype=torch.float32).reshape(1)
    return torch.tensor([a], dtype=torch.float32, device=dev)


def push_async_batched(buf: SpeciesBuffer, e: torch.Tensor, grid: Grid1D,
                       qm: float, dt: float, num_batches: int = 4,
                       b=(0.0, 0.0, 0.0), boundary: Boundary = "periodic",
                       gather_mode: str = "take") -> PushResult:
    """The unified push over ``num_batches`` equal particle batches."""
    cap = buf.capacity
    if cap % num_batches != 0:
        raise ValueError(
            f"strategy='async_batched' needs the species capacity ({cap}) "
            f"to be divisible by num_batches ({num_batches}); pick a batch "
            f"count that divides every species capacity or pad the buffers")
    bs = cap // num_batches
    outs, diag = [], None
    for k in range(num_batches):
        sl = slice(k * bs, (k + 1) * bs)
        sub = SpeciesBuffer(x=buf.x[sl], v=buf.v[sl], w=buf.w[sl],
                            alive=buf.alive[sl])
        res = push_unified(sub, e, grid, qm, dt, b, boundary, gather_mode)
        outs.append(res)
        diag = (res.diag if diag is None
                else {n: diag[n] + res.diag[n] for n in diag})
    out = SpeciesBuffer(*(torch.cat([getattr(r.buf, f) for r in outs])
                          for f in ("x", "v", "w", "alive")))
    return PushResult(out, torch.cat([r.hit_left for r in outs]),
                      torch.cat([r.hit_right for r in outs]), diag)


def push_stacked(st: StackedSpecies, e: torch.Tensor, grid: Grid1D,
                 qm: torch.Tensor, dt: torch.Tensor, b=(0.0, 0.0, 0.0),
                 boundary: Boundary = "periodic", gather_mode: str = "take",
                 charges: torch.Tensor | None = None,
                 rho_carry: torch.Tensor | None = None):
    """Push every species of a StackedSpecies in one fused-kernel launch.

    ``qm`` and ``dt`` are (S,) per-species tensors (q/m and dt*stride);
    q/m*dt is formed in float32 on the device. When ``charges`` (S,) is
    given, the post-push total charge density of all species is deposited
    in the same pass and returned as ``rho`` (plus ``rho_carry``); None
    skips the deposit. The kernel's gather is CIC; ``gather_mode`` is
    accepted for the reference's signature.

    Returns (stacked, hit_left (S, cap), hit_right (S, cap), diag dict of
    (S,) tensors, rho | None).
    """
    del gather_mode
    x, v, alive, hl, hr, w, rho = ops.fused_push_deposit(
        st.x, st.v, st.w, st.alive, e, qm * dt, dt,
        charges if charges is not None else torch.zeros_like(qm), rho_carry,
        x0=grid.x0, dx=grid.dx, nc=grid.nc, length=grid.length, b=b,
        boundary=boundary, deposit=charges is not None)
    diag = _wall_diag(v, st.w, hl, hr)
    return StackedSpecies(x=x, v=v, w=w, alive=alive), hl, hr, diag, rho


PUSH = {
    "unified": push_unified,
    "explicit": push_explicit,
    "async_batched": push_async_batched,
    "fused": push_fused,
}


def push(buf: SpeciesBuffer, e: torch.Tensor, grid: Grid1D, qm: float,
         dt: float, strategy: Strategy = "unified", **kw) -> PushResult:
    if strategy not in PUSH:
        raise ValueError(
            f"unknown mover strategy {strategy!r}; valid: {STRATEGIES}")
    return PUSH[strategy](buf, e, grid, qm, dt, **kw)
