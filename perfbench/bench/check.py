"""The numbers that decide ``correct``: the program's rows against the
reference's, and the checks on the window's own counters.

Each number is a gap that is 0 where the two sides agree: position and
velocity gaps of the rows both sides hold, rows only one side holds, count
and event-count gaps, the carried charge's gap. A cell's workload file
gives each number's limit; ``judge`` prints each number beside it.
"""

from __future__ import annotations

import sys

import torch


def _key(v: torch.Tensor) -> torch.Tensor:
    """(vy, vz) of each row as one int64: the bits of both float32s."""
    b = v[:, 1:3].float().contiguous().view(torch.int32).long() & 0xFFFFFFFF
    return (b[:, 0] << 32) | b[:, 1]


def _vgap(vp: torch.Tensor, vr: torch.Tensor, vth: float) -> float:
    """Largest |v_p - v_r| over |v_r| + vth, rows paired."""
    if vr.numel() == 0:
        return 0.0
    vp, vr = vp.double(), vr.double()
    return float((torch.linalg.vector_norm(vp - vr, dim=-1)
                  / (torch.linalg.vector_norm(vr, dim=-1) + vth)).max())


def _xgap(xp: torch.Tensor, xr: torch.Tensor, period: float | None) -> float:
    if xr.numel() == 0:
        return 0.0
    dx = (xp.double() - xr.double()).abs()
    if period is not None:
        dx = torch.minimum(dx, period - dx)
    return float(dx.max())


def slots(p: dict, r: dict, mask: torch.Tensor, vth: float,
          period: float | None) -> dict:
    """Slot by slot over ``mask``: rows alive on one side only, and the
    gaps of the rows alive on both. ``p`` and ``r`` hold x, v, alive."""
    pa, ra = p["alive"] & mask, r["alive"] & mask
    both = pa & ra
    return {"row_miss": int((pa ^ ra).sum()),
            "x_err": _xgap(p["x"][both], r["x"][both], period),
            "v_err": _vgap(p["v"][both], r["v"][both], vth)}


def _found(keys: torch.Tensor, among: torch.Tensor):
    """For each of ``keys``: whether ``among`` holds it, and where."""
    if among.numel() == 0:
        z = torch.zeros(keys.numel(), dtype=torch.long, device=keys.device)
        return torch.zeros_like(keys, dtype=torch.bool), z
    srt, order = torch.sort(among)
    j = torch.searchsorted(srt, keys).clamp(max=among.numel() - 1)
    return srt[j] == keys, order[j]


def multiset(p: dict, r: dict, vth: float, period: float | None) -> dict:
    """Rows matched by their exact (vy, vz): rows on one side only, and
    the gaps of the matched ones. ``p`` and ``r`` hold x (M,), v (M, 3)."""
    kp, kr = _key(p["v"]), _key(r["v"])
    hit_p, at = _found(kp, kr)
    hit_r, _ = _found(kr, kp)
    ip = torch.nonzero(hit_p).flatten()
    ir = at[ip]
    return {"row_miss": int((~hit_p).sum()) + int((~hit_r).sum()),
            "x_err": _xgap(p["x"][ip], r["x"][ir], period),
            "v_err": _vgap(p["v"][ip], r["v"][ir], vth)}


def rel_gap(p: torch.Tensor, r: torch.Tensor) -> float:
    """max |p - r| over max |r|."""
    r = r.double()
    return float((p.double() - r).abs().max() / r.abs().max().clamp(
        min=1e-300))


def merge(into: dict, new: dict) -> dict:
    """Worst of each number: the max of gaps, the sum of row counts."""
    for k, v in new.items():
        if k in ("row_miss", "count_err", "ionized_err", "coll_err",
                 "landing_err"):
            into[k] = into.get(k, 0) + v
        else:
            into[k] = max(into.get(k, 0.0), v)
    return into


def judge(numbers: dict, limits: dict, out=sys.stderr) -> bool:
    """Every number at or under its limit. Prints each number beside its
    limit on ``out`` as the run's last lines; a number without a limit
    fails."""
    ok = True
    for name in sorted(numbers):
        lim = limits.get(name)
        good = lim is not None and numbers[name] <= lim
        ok &= good
        print(f"check {name} {numbers[name]!r} limit {lim!r} "
              f"{'ok' if good else 'FAIL'}", file=out)
    return ok
