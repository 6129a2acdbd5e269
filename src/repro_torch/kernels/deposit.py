"""The CIC deposit kernel (``csrc/deposit.cu``) and its plain PyTorch version.

Replaces the TPU kernel ``src/repro/kernels/deposit.py::_deposit_kernel``
(launched by ``deposit_pallas``): the charge q of every element lands on its
two CIC nodes, in raw (times dx) units; ``ops.deposit`` divides by dx. On
the card each element is one thread with two float atomicAdds into L2; the
TPU's one-hot reduction was a workaround for a missing scatter.

Bound on the H100: bytes, 8 B an element (x, q) and one (nc+1,) write.
Float atomics add in an order that changes from run to run, so the kernel
agrees with the plain version to rounding, not bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.mover import cic

_P = ctypes.c_void_p
_ARGTYPES = [_P, _P, _P, ctypes.c_longlong, ctypes.c_float, ctypes.c_float,
             ctypes.c_int, _P]


def deposit_plain(x: torch.Tensor, q: torch.Tensor, *, x0: float, dx: float,
                  nc: int) -> torch.Tensor:
    """Plain version: x, q (n,) -> raw node charge (nc+1,), times dx."""
    i, f = cic(x, x0, dx, nc)
    rho = torch.zeros(nc + 1, dtype=x.dtype, device=x.device)
    rho.index_add_(0, i, q * (1.0 - f))
    rho.index_add_(0, i + 1, q * f)
    return rho


def deposit(x: torch.Tensor, q: torch.Tensor, *, x0: float, dx: float,
            nc: int) -> torch.Tensor:
    """CUDA kernel: same arguments and result as ``deposit_plain``."""
    _build.require_cuda(x, "deposit")
    n = x.shape[0]
    _build.require(x, "x", torch.float32, (n,), x.device)
    _build.require(q, "q", torch.float32, (n,), x.device)
    rho = torch.zeros(nc + 1, dtype=x.dtype, device=x.device)
    if n == 0:
        return rho
    fn = _build.function("deposit", "deposit", _ARGTYPES)
    err = fn(x.data_ptr(), q.data_ptr(), rho.data_ptr(), n, x0, dx, nc,
             _build.stream_of(x))
    deposit.launches += 1
    _build.check_launch(err, "deposit")
    return rho


deposit.launches = 0
