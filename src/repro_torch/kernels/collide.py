"""The Takizuka-Abe deflection kernel (``csrc/collide.cu``) and its plain
PyTorch version.

Replaces the TPU kernel ``src/repro/kernels/collide.py::_ta_kernel``
(launched by ``ta_kick_pallas``): from each pair's relative velocity u
(M, 3), delta = tan(theta/2) (M,) and azimuth phi (M,), the deflection
du = u' - u (M, 3) with |u + du| = |u|; u along z takes the degenerate-frame
branch, and delta = 0 gives du = 0 exactly. It serves
``collisions.coulomb_intra(use_kernel=True)`` (``PICConfig.collide_kernel``).

Bound on the H100: bytes, 32 B a row (u 12, delta 4, phi 4, du 12): at the
§3.3 electron capacity of 16,777,216 rows, 0.160 ms at 3.35 TB/s. One
thread per row on the (M, 3) layout; the TPU's (rows, 128) planes are not
built.

``ta_kick_plain`` repeats the kernel's arithmetic operation by operation
(it multiplies by 1/(1+delta^2) where ``collisions.ta_kick_ref`` divides);
the two are distinct on purpose, as the reference keeps its kernel and its
``ta_kick_ref`` apart.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_P = ctypes.c_void_p
_ARGTYPES = [_P, _P, _P, _P, ctypes.c_longlong, _P]


def ta_kick_plain(u: torch.Tensor, delta: torch.Tensor,
                  phi: torch.Tensor) -> torch.Tensor:
    """Plain version: the kernel's arithmetic on u (M, 3), delta, phi (M,)."""
    ux, uy, uz = u[:, 0], u[:, 1], u[:, 2]
    d2 = delta * delta
    inv = 1.0 / (1.0 + d2)
    cos_t = (1.0 - d2) * inv
    sin_t = 2.0 * delta * inv
    one_m = 1.0 - cos_t
    uperp2 = ux * ux + uy * uy
    uperp = torch.sqrt(uperp2)
    umag = torch.sqrt(uperp2 + uz * uz)
    cphi, sphi = torch.cos(phi), torch.sin(phi)
    safe = uperp > 1e-12 * torch.clamp(umag, min=1.0)
    up = torch.where(safe, uperp, 1.0)
    dux = (ux / up) * uz * sin_t * cphi - (uy / up) * umag * sin_t * sphi \
        - ux * one_m
    duy = (uy / up) * uz * sin_t * cphi + (ux / up) * umag * sin_t * sphi \
        - uy * one_m
    duz = -up * sin_t * cphi - uz * one_m
    dux0 = uz * sin_t * cphi
    duy0 = uz * sin_t * sphi
    duz0 = -uz * one_m
    return torch.stack([torch.where(safe, dux, dux0),
                        torch.where(safe, duy, duy0),
                        torch.where(safe, duz, duz0)], dim=-1)


def ta_kick(u: torch.Tensor, delta: torch.Tensor,
            phi: torch.Tensor) -> torch.Tensor:
    """CUDA kernel: same arguments and result as ``ta_kick_plain``."""
    _build.require_cuda(u, "ta_kick")
    m = u.shape[0]
    _build.require(u, "u", torch.float32, (m, 3), u.device)
    _build.require(delta, "delta", torch.float32, (m,), u.device)
    _build.require(phi, "phi", torch.float32, (m,), u.device)
    du = torch.empty_like(u)
    if m == 0:
        return du
    fn = _build.function("collide", "ta_kick", _ARGTYPES)
    err = fn(u.data_ptr(), delta.data_ptr(), phi.data_ptr(), du.data_ptr(),
             m, _build.stream_of(u))
    ta_kick.launches += 1
    _build.check_launch(err, "ta_kick")
    return du


ta_kick.launches = 0
