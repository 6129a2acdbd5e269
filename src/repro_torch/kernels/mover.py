"""The mover kernel (``csrc/mover.cu``) and its plain PyTorch version.

Replaces the TPU kernel ``src/repro/kernels/mover.py::_mover_kernel``
(launched by ``mover_push_pallas``): CIC gather of E, Boris push, drift and
boundary for one species, returning the wall-hit masks. It serves
``strategy='explicit'``, one launch per species, with q/m*dt, dt and b passed
at run time (the TPU kernel baked them in at compile time).

Bound on the H100: bytes, 36 B a slot (read x, v, alive; write x, v, alive
and both masks). One thread per slot on flat (cap,) arrays with v in the
reference's (cap, 3) layout; E is read through L2 (see the source's note).

The plain version below repeats the kernel's arithmetic operation by
operation; ``cic``, ``clamp_hi`` and ``push_plain`` are shared with the
plain versions of the fused and deposit kernels.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build

BOUNDARY_CODES = {"periodic": 0, "absorb": 1, "open": 2}

_P = ctypes.c_void_p
_ARGTYPES = [_P] * 9 + [ctypes.c_longlong, ctypes.c_float, ctypes.c_float,
                        ctypes.c_int, ctypes.c_float, ctypes.c_float,
                        ctypes.c_float, ctypes.c_float, ctypes.c_float,
                        ctypes.c_float, ctypes.c_float, ctypes.c_int, _P]


def clamp_hi(length: float) -> float:
    """Where the kernels park absorbed particles: float32(length) times
    float32(1 - 1e-7), as ``src/repro/kernels/ref.py`` computes it."""
    return float(np.float32(length) * np.float32(1.0 - 1e-7))


def inv_dx(dx: float) -> float:
    """float32(1 / float32(dx)). Every path multiplies by it where the
    reference divides by dx: jitted JAX makes a division by a constant a
    multiply by its float32 reciprocal, and PyTorch on CUDA does the same
    with a Python scalar, while an IEEE division (PyTorch on the CPU, the
    kernels before) rounds an ulp apart whenever dx is no power of two."""
    return float(np.float32(1.0) / np.float32(dx))


def cic(x: torch.Tensor, x0: float, dx: float, nc: int):
    """Left node index (int64, clipped to [0, nc-1]) and fraction (clipped
    to [0, 1]) of cloud-in-cell weighting, at s = (x - x0) * inv_dx(dx)."""
    s = (x - x0) * inv_dx(dx)
    fl = torch.clamp(torch.floor(s), 0, nc - 1)
    return fl.long(), torch.clamp(s - fl, 0.0, 1.0)


def push_plain(x, vx, vy, vz, alive, e, *, x0, dx, nc, length, half, dt, b,
               boundary):
    """Gather + Boris + drift + boundary on planes of any one shape.
    ``half`` (0.5*q/m*dt) and ``dt`` are float32 tensors broadcast against
    the planes. Returns (x, vx, vy, vz, alive, hit_left, hit_right)."""
    i, f = cic(x, x0, dx, nc)
    ex = (e[i] * (1.0 - f) + e[i + 1] * f) * alive.to(x.dtype)
    vx = vx + half * ex
    bx, by, bz = b
    if bx != 0.0 or by != 0.0 or bz != 0.0:
        tx, ty, tz = bx * half, by * half, bz * half
        t2 = tx * tx + ty * ty + tz * tz
        sx, sy, sz = (2.0 * tx / (1.0 + t2), 2.0 * ty / (1.0 + t2),
                      2.0 * tz / (1.0 + t2))
        vpx = vx + (vy * tz - vz * ty)
        vpy = vy + (vz * tx - vx * tz)
        vpz = vz + (vx * ty - vy * tx)
        vx, vy, vz = (vx + (vpy * sz - vpz * sy), vy + (vpz * sx - vpx * sz),
                      vz + (vpx * sy - vpy * sx))
    vx = vx + half * ex
    xn = x + vx * dt
    hl = torch.zeros_like(alive)
    hr = torch.zeros_like(alive)
    if boundary == "periodic":
        xn = xn - torch.floor(xn / length) * length
    elif boundary == "absorb":
        hl = alive & (xn < 0.0)
        hr = alive & (xn >= length)
        alive = alive & ~(hl | hr)
        xn = torch.clamp(xn, 0.0, clamp_hi(length))
    return xn, vx, vy, vz, alive, hl, hr


def check_boundary(boundary: str) -> None:
    if boundary not in BOUNDARY_CODES:
        raise ValueError(f"unknown boundary {boundary!r}")


def mover_push_plain(x, v, alive, e, *, x0, dx, nc, length, qm_dt, dt, b,
                     boundary):
    """Plain version: x (n,), v (n, 3), alive (n,) bool, e (nc+1,).
    Returns (x, v, alive, hit_left, hit_right)."""
    check_boundary(boundary)
    half = torch.tensor(0.5 * qm_dt, dtype=x.dtype, device=x.device)
    dt_t = torch.tensor(dt, dtype=x.dtype, device=x.device)
    xn, vx, vy, vz, an, hl, hr = push_plain(
        x, v[:, 0], v[:, 1], v[:, 2], alive, e, x0=x0, dx=dx, nc=nc,
        length=length, half=half, dt=dt_t, b=b, boundary=boundary)
    return xn, torch.stack([vx, vy, vz], dim=-1), an, hl, hr


def mover_push(x, v, alive, e, *, x0, dx, nc, length, qm_dt, dt, b,
               boundary):
    """CUDA kernel: same arguments and results as ``mover_push_plain``.
    Launches on the current stream; raises on a refused launch."""
    _build.require_cuda(x, "mover_push")
    check_boundary(boundary)
    n = x.shape[0]
    dev = x.device
    _build.require(x, "x", torch.float32, (n,), dev)
    _build.require(v, "v", torch.float32, (n, 3), dev)
    _build.require(alive, "alive", torch.bool, (n,), dev)
    _build.require(e, "e", torch.float32, (nc + 1,), dev)
    xo, vo = torch.empty_like(x), torch.empty_like(v)
    ao, hl, hr = (torch.empty_like(alive) for _ in range(3))
    if n == 0:
        return xo, vo, ao, hl, hr
    fn = _build.function("mover", "mover_push", _ARGTYPES)
    err = fn(x.data_ptr(), v.data_ptr(), alive.data_ptr(), e.data_ptr(),
             xo.data_ptr(), vo.data_ptr(), ao.data_ptr(), hl.data_ptr(),
             hr.data_ptr(), n, x0, inv_dx(dx), nc, length, clamp_hi(length),
             qm_dt, dt, *(float(c) for c in b), BOUNDARY_CODES[boundary],
             _build.stream_of(x))
    mover_push.launches += 1
    _build.check_launch(err, "mover_push")
    return xo, vo, ao, hl, hr


mover_push.launches = 0
