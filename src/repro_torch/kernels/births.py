"""The births kernel (``csrc/births.cu``): masked candidates written into
the dead slots of their target buffers in place, with its plain PyTorch
version.

``place_births`` is the landing of the MC sources' births:
``collisions.ionize`` lands each ionized neutral's (e-, D+) pair in the
electrons and the ions and kills the neutral, and
``particles.inject_masked`` (wall emission's secondaries, the engine's
legacy merge) lands one candidate row in one buffer. The rule is the
reference's ``inject_masked``: the k-th masked candidate, in index order,
lands in the k-th dead slot, in slot order, of every target, for k below
n = min(hits, each target's free count); later candidates are dropped and
counted, and no bound is needed. It replaces no TPU kernel. The port ran
the reference's form, a free-slot scan (a prefix sum and a scatter of all
the slots), then per target field a copy of the whole buffer and a scatter
of all M candidate rows, each row that does not land aimed at a scratch
row: at the §3.3 capacity of 16,777,216 slots, a few thousand births a
step moved 16.8 M rows eight times.

Design: three inclusive int32 prefix sums (``torch.cumsum``): the hits'
rank over the M candidates, and each target's alive count over its slots.
Then ``ok`` is zeroed and one launch of a fixed grid strides over the
births k < n, n read on the card from the sums' last entries: a thread
binary-searches the candidate i (the first rank above k) and each
target's slot j (the first j with (j + 1) - alive_rank[j] above k), the
searches in lockstep so that their loads overlap, copies the row, sets
alive and ``ok[i]``, and with a kill buffer kills row i (alive False,
w * 0, as ``kill``'s w * alive). Nothing waits for the card. Rows are
copies, so the kernel gives the plain version's bits; the kill writes the
same bits as ``kill`` wherever dead rows hold w = 0, as every buffer's
do.

Bound on the H100: bytes, ``mask`` 1 B a candidate and ``alive`` 1 B a
slot a target, plus each birth's rows (x, v, w read, and written with
alive: 41 B a target; the kill's alive and w: 9 B): at the §3.3 step's
16,777,216 neutrals and two targets of 16,777,216 slots, 15.0 µs at
3.35 TB/s before the births. The prefix sums are not in the bound: they
write 4 B a slot and are most of the path's time.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from repro_torch.kernels import _build

MAX_TARGETS = 2
_P = ctypes.c_void_p
_ARGTYPES = [_P, ctypes.c_longlong, ctypes.c_int, _P, _P, _P, _P, _P, _P,
             ctypes.c_int, _P]
# the place kernel's grid: enough threads for the births of a step, fewer
# than the candidates; the threads stride over any more
_THREADS, _MAX_BLOCKS = 256, 1024

Dest = tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]
Src = tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def place_births_plain(mask: torch.Tensor, dests: Sequence[Dest],
                       srcs: Sequence[Src],
                       kill: tuple[torch.Tensor, torch.Tensor] | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version: the landing candidates and each target's first dead
    slots by ``nonzero``, the rows by indexing. Same arguments and result
    as ``place_births``."""
    rank = torch.cumsum(mask, 0, dtype=torch.int32)
    hits = mask.sum(dtype=torch.int32)
    n = hits
    for _, _, _, alive in dests:
        n = torch.minimum(n, (~alive).sum(dtype=torch.int32))
    ok = mask & (rank <= n)
    src = torch.nonzero(ok).squeeze(1)
    for (x, v, w, alive), (sx, sv, sw) in zip(dests, srcs):
        slot = torch.nonzero(~alive).squeeze(1)[:src.shape[0]]
        x[slot] = sx[src]
        v[slot] = sv[src]
        w[slot] = sw[src]
        alive[slot] = True
    if kill is not None:
        alive, w = kill
        alive.logical_and_(~ok)
        w.mul_(alive)
    return ok, n, hits - n


def place_births(mask: torch.Tensor, dests: Sequence[Dest],
                 srcs: Sequence[Src],
                 kill: tuple[torch.Tensor, torch.Tensor] | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """CUDA kernel. ``mask`` (M,) bool selects the candidates; ``dests``
    holds one to two targets, each (x (cap,), v (cap, 3), w (cap,),
    alive (cap,) bool), written in place; ``srcs`` the matching candidate
    rows (x (M,), v (M, 3), w (M,)); ``kill`` the candidates' own
    (alive, w) (M,), whose landed rows die, or None. A source may be the
    kill buffer's w: each row is read before it is killed.

    Returns (ok (M,) bool: the candidates that landed, n () int32 landed,
    dropped () int32: hits - n)."""
    _build.require_cuda(mask, "place_births")
    m, dev = mask.shape[0], mask.device
    _build.require(mask, "mask", torch.bool, (m,), dev)
    if not 1 <= len(dests) == len(srcs) <= MAX_TARGETS:
        raise ValueError(f"place_births takes 1 to {MAX_TARGETS} targets "
                         f"and one source each, got {len(dests)} and "
                         f"{len(srcs)}")
    if m >= 2**31:
        raise ValueError(f"{m} candidates: the ranks are int32")
    for t, ((x, v, w, alive), (sx, sv, sw)) in enumerate(zip(dests, srcs)):
        cap = x.shape[0]
        if cap >= 2**31:
            raise ValueError(f"target {t}: {cap} slots, the ranks are int32")
        for name, a, dtype, shape in (
                ("x", x, torch.float32, (cap,)),
                ("v", v, torch.float32, (cap, 3)),
                ("w", w, torch.float32, (cap,)),
                ("alive", alive, torch.bool, (cap,)),
                ("src x", sx, torch.float32, (m,)),
                ("src v", sv, torch.float32, (m, 3)),
                ("src w", sw, torch.float32, (m,))):
            _build.require(a, f"target {t} {name}", dtype, shape, dev)
    if kill is not None:
        _build.require(kill[0], "kill alive", torch.bool, (m,), dev)
        _build.require(kill[1], "kill w", torch.float32, (m,), dev)
    if m == 0:
        counts = torch.zeros(2, dtype=torch.int32, device=dev)
        return mask.clone(), counts[0], counts[1]
    counts = torch.empty(2, dtype=torch.int32, device=dev)
    hit_rank = torch.cumsum(mask, 0, dtype=torch.int32)
    ranks = [torch.cumsum(d[3], 0, dtype=torch.int32) for d in dests]
    ptrs = []
    for rank, (x, v, w, alive), (sx, sv, sw) in zip(ranks, dests, srcs):
        ptrs += [a.data_ptr() for a in (rank, x, v, w, alive, sx, sv, sw)]
    caps = [d[0].shape[0] for d in dests]
    most = min([m] + caps)
    blocks = max(1, min(_MAX_BLOCKS, -(-most // _THREADS)))
    ok = torch.empty(m, dtype=torch.bool, device=dev)
    fn = _build.function("births", "place_births", _ARGTYPES)
    err = fn(hit_rank.data_ptr(), m, len(dests),
             (ctypes.c_longlong * len(caps))(*caps),
             (ctypes.c_void_p * len(ptrs))(*ptrs),
             None if kill is None else kill[0].data_ptr(),
             None if kill is None else kill[1].data_ptr(),
             counts.data_ptr(), ok.data_ptr(), blocks, _build.stream_of(mask))
    place_births.launches += 1
    _build.check_launch(err, "place_births")
    return ok, counts[0], counts[1]


place_births.launches = 0
