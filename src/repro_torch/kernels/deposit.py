"""The CIC deposit kernel (``csrc/deposit.cu``), its plain PyTorch version,
and the rule by which both deposit kernels (this one and the fused
kernel's) pick their form.

Replaces the TPU kernel ``src/repro/kernels/deposit.py::_deposit_kernel``
(launched by ``deposit_pallas``): the charge q of every element lands on its
two CIC nodes, in raw (times dx) units; ``ops.deposit`` divides by dx. The
TPU kernel keeps its (1, ng) accumulator in VMEM across the grid.

Bound on the H100: bytes, q (4 B an element), x where q != 0, and one
(nc+1,) write; what holds a deposit back is its float adds. ``deposit_form``
picks one of two forms by grid size, before the launch:

- "block" where the (ng,) accumulator fits one block's shared memory
  (ng <= 58,112, an engine domain's grid): persistent blocks, each adding
  its share of the elements into its own copy on chip and flushing it once.
- "pair" above (the paper's 102,401 nodes, 400 KB): one 8-byte float2
  reduction a charged element into node pairs P[i] += (q(1-f), q f) in L2,
  then rho[j] = P[j].x + P[j-1].y.

On the H100 (PERF.md) the block form beat the pair form at 25,601 nodes.
The pair form beat two float atomics a charged element on every dense
deposit (on the sparse births of one ionization step it is 5 % slower),
and a thread-block cluster's distributed shared memory at 102,401 nodes
(sm_90 has no float add for shared memory: each add is a compare-and-swap
loop).
Float atomics add in an order that changes from run to run, so the kernels
agree with the plain version to rounding, not bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.mover import cic, inv_dx

# the shared memory a block of an sm_90 card may use (227 KB, after
# cudaFuncAttributeMaxDynamicSharedMemorySize)
BLOCK_SMEM = 232_448
BLOCK_THREADS = 1024            # csrc/pic_common.cuh kBlockThreads
FORMS = ("block", "pair")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_ARGTYPES = [_P, _P, _P, _P, ctypes.c_longlong, _F, _F, _I, _P]
_BLOCK_ARGTYPES = [_P, _P, _P, _P, ctypes.c_longlong, _F, _F, _I, _I, _P]


def deposit_form(ng: int) -> str:
    """The form every deposit onto ``ng`` nodes runs in: "block" where the
    nodes fit one block's shared memory, else "pair"."""
    return "block" if 4 * ng <= BLOCK_SMEM else "pair"


def block_info(source: str, key: tuple, ng: int) -> dict:
    """Registers, local bytes (spills and stack), static shared bytes and
    the blocks that fit on the card at once, for the block instance ``key``
    of ``csrc/<source>.cu`` at ``ng`` nodes of dynamic shared memory (needs
    the card)."""
    name = {"deposit": "deposit_block_info",
            "fused_cycle": "fused_block_info"}[source]
    fn = _build.function(source, name, [_I] * (len(key) + 1)
                         + [ctypes.POINTER(_I)])
    out = (_I * 4)()
    _build.check_launch(fn(*key, ng, out), name)
    return dict(zip(("registers", "local_bytes", "static_smem",
                     "max_blocks"), out))


_max_blocks: dict[tuple, int] = {}


def n_blocks(source: str, key: tuple, ng: int) -> int:
    """Persistent blocks to launch: as many as fit on the card at once
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor times the SMs), asked
    once per instance and grid. Raises if none fits."""
    k = (source, key, ng)
    if k not in _max_blocks:
        n = block_info(source, key, ng)["max_blocks"]
        if n < 1:
            raise RuntimeError(f"{source}: no block with {4 * ng} B of "
                               f"shared memory fits on the card")
        _max_blocks[k] = n
    return _max_blocks[k]


def accumulators(form: str, n_rows: int, ng: int, device):
    """(rho, scratch) for a launch in ``form``: the blocks' rows
    (n_rows, ng), or the zeroed node pairs (ng, 2); rho is written whole
    from either."""
    f32 = torch.float32
    rho = torch.empty(ng, dtype=f32, device=device)
    if form == "block":
        return rho, torch.empty(n_rows, ng, dtype=f32, device=device)
    return rho, torch.zeros(ng, 2, dtype=f32, device=device)


def count_launch(fn, form: str | None) -> None:
    """One more launch of the wrapper ``fn``, and of its ``form``."""
    fn.launches += 1
    if form is not None:
        name = f"launches_{form}"
        setattr(fn, name, getattr(fn, name) + 1)


def reset_launches(fn) -> None:
    """Set a deposit wrapper's launch counts, total and by form, to 0."""
    fn.launches = 0
    for form in FORMS:
        setattr(fn, f"launches_{form}", 0)


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
    """CUDA kernel: same arguments and result as ``deposit_plain``, in the
    form ``deposit_form(nc + 1)`` gives. Counts its launches in
    ``deposit.launches`` and by form in ``launches_block`` and
    ``launches_pair``."""
    _build.require_cuda(x, "deposit")
    n = x.shape[0]
    _build.require(x, "x", torch.float32, (n,), x.device)
    _build.require(q, "q", torch.float32, (n,), x.device)
    if n == 0:
        return torch.zeros(nc + 1, dtype=x.dtype, device=x.device)
    ng = nc + 1
    form = deposit_form(ng)
    stream = _build.stream_of(x)
    if form == "block":
        nb = n_blocks("deposit", (), ng)
        rho, rows = accumulators(form, nb, ng, x.device)
        fn = _build.function("deposit", "deposit_block", _BLOCK_ARGTYPES)
        err = fn(x.data_ptr(), q.data_ptr(), rows.data_ptr(), rho.data_ptr(),
                 n, x0, inv_dx(dx), nc, nb, stream)
    else:
        rho, pair = accumulators(form, 0, ng, x.device)
        fn = _build.function("deposit", "deposit", _ARGTYPES)
        err = fn(x.data_ptr(), q.data_ptr(), rho.data_ptr(), pair.data_ptr(),
                 n, x0, inv_dx(dx), nc, stream)
    count_launch(deposit, form)
    _build.check_launch(err, f"deposit ({form})")
    return rho


reset_launches(deposit)
