"""The fused push + deposit kernel (``csrc/fused_cycle.cu``) and its plain
PyTorch version: the hot loop of the PIC cycle.

Replaces the TPU kernel ``src/repro/kernels/fused_cycle.py::_fused_kernel``
(launched by ``fused_push_deposit_pallas``). Where the TPU kernel moved one
species through (rows, 128) planes with its scalars baked in, this one moves
a stack of S species, (S, cap), in the reference's layout (x, w, alive
(S, cap); v (S, cap, 3)), with q/m*dt, dt and charge as (S,) float32 device
arrays: it computes ``core.mover.push_stacked`` and its deposit in one pass,
and ``push_fused`` is its S = 1 case.

Bound on the H100: bytes, 44 B a slot (read x, v, w, alive; write x, v, w,
alive and both masks). With a deposit, the kernel runs in the form
``deposit.deposit_form`` gives: on a grid that fits one block's shared
memory, persistent blocks that hold the accumulator on chip and flush it
once each; above that (the paper's 102,401 nodes), one thread a slot and
one float2 reduction in L2 a charged slot into node pairs (half the
atomics of two float adds), then a finishing pass. ``kernels/deposit.py``
gives the measurements behind the rule. Without a deposit, one thread a
slot.

Both versions return the deposit in raw (times dx) units; ``ops`` divides by
dx and adds a carried rho outside, as the reference's ``ops.py`` does.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import deposit as _deposit
from repro_torch.kernels.deposit import deposit_plain
from repro_torch.kernels.mover import (BOUNDARY_CODES, check_boundary,
                                      clamp_hi, inv_dx, push_plain)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_GRID = [ctypes.c_longlong, _I, _F, _F, _I, _F, _F, _F, _F, _F, _I]
_ARGTYPES = [_P] * 16 + _GRID + [_P]
_BLOCK_ARGTYPES = [_P] * 16 + _GRID + [_I, _P]


def fused_push_deposit_plain(x, v, w, alive, e, qm_dt, dt, charge, *, x0,
                             dx, nc, length, b, boundary, deposit):
    """Plain version. Returns (x, v, alive, hit_left, hit_right, w,
    raw rho (nc+1,) or None when ``deposit`` is False)."""
    check_boundary(boundary)
    half = 0.5 * qm_dt[:, None]
    xn, vx, vy, vz, an, hl, hr = push_plain(
        x, v[..., 0], v[..., 1], v[..., 2], alive, e, x0=x0, dx=dx, nc=nc,
        length=length, half=half, dt=dt[:, None], b=b, boundary=boundary)
    wn = w * an.to(w.dtype)
    rho = None
    if deposit:
        rho = deposit_plain(xn.reshape(-1), (charge[:, None] * wn).reshape(-1),
                            x0=x0, dx=dx, nc=nc)
    return xn, torch.stack([vx, vy, vz], dim=-1), an, hl, hr, wn, rho


def fused_push_deposit(x, v, w, alive, e, qm_dt, dt, charge, *, x0, dx, nc,
                       length, b, boundary, deposit):
    """CUDA kernel: same arguments and results as
    ``fused_push_deposit_plain``; with ``deposit``, in the form
    ``deposit.deposit_form(nc + 1)`` gives. Launches on the current stream
    and allocates fresh outputs (the input w must survive for the
    wall-power diagnostic); raises on a refused launch. Counts its launches
    in ``launches`` and, with a deposit, by form in ``launches_block`` and
    ``launches_pair``."""
    _build.require_cuda(x, "fused_push_deposit")
    check_boundary(boundary)
    if x.dim() != 2:
        raise ValueError(f"x must be (S, cap), got {tuple(x.shape)}")
    s, cap = x.shape
    dev = x.device
    f32 = torch.float32
    _build.require(x, "x", f32, (s, cap), dev)
    _build.require(v, "v", f32, (s, cap, 3), dev)
    _build.require(w, "w", f32, (s, cap), dev)
    _build.require(alive, "alive", torch.bool, (s, cap), dev)
    _build.require(e, "e", f32, (nc + 1,), dev)
    for name, t in (("qm_dt", qm_dt), ("dt", dt), ("charge", charge)):
        _build.require(t, name, f32, (s,), dev)
    xo, vo, wo = torch.empty_like(x), torch.empty_like(v), torch.empty_like(w)
    ao, hl, hr = (torch.empty_like(alive) for _ in range(3))
    if s * cap == 0:
        rho = torch.zeros(nc + 1, dtype=f32, device=dev) if deposit else None
        return xo, vo, ao, hl, hr, wo, rho
    ng = nc + 1
    form = _deposit.deposit_form(ng) if deposit else None
    code = BOUNDARY_CODES[boundary]
    bf = tuple(float(c) for c in b)
    ptrs = (x.data_ptr(), v.data_ptr(), w.data_ptr(), alive.data_ptr(),
            e.data_ptr(), qm_dt.data_ptr(), dt.data_ptr(), charge.data_ptr(),
            xo.data_ptr(), vo.data_ptr(), wo.data_ptr(), ao.data_ptr(),
            hl.data_ptr(), hr.data_ptr())
    grid = (cap, s, x0, inv_dx(dx), nc, length, clamp_hi(length), *bf,
            code)
    stream = _build.stream_of(x)
    rho = None
    if form == "block":
        nb = _deposit.n_blocks("fused_cycle", (code, int(any(bf))), ng)
        rho, rows = _deposit.accumulators(form, nb, ng, dev)
        fn = _build.function("fused_cycle", "fused_push_deposit_block",
                             _BLOCK_ARGTYPES)
        err = fn(*ptrs, rows.data_ptr(), rho.data_ptr(), *grid, nb, stream)
    else:
        pair = None
        if form == "pair":
            rho, pair = _deposit.accumulators(form, 0, ng, dev)
        fn = _build.function("fused_cycle", "fused_push_deposit", _ARGTYPES)
        err = fn(*ptrs, rho.data_ptr() if rho is not None else None,
                 pair.data_ptr() if pair is not None else None, *grid, stream)
    _deposit.count_launch(fused_push_deposit, form)
    _build.check_launch(err, f"fused_push_deposit ({form or 'no deposit'})")
    return xo, vo, ao, hl, hr, wo, rho


_deposit.reset_launches(fused_push_deposit)
