"""Plain PyTorch reference of one step of the §3.3 plasma between grounded
absorbing walls: the field from the carried charge density, the push,
absorption at both walls, secondary electron emission (SEE) and the next
carried charge density. The field, the push and the deposit are
``pic_ref``'s; this file adds the walls and the emission.

It imports nothing of the program. ``dtype`` is the precision of the
state, as in ``pic_ref``: float32 as the configuration states, bfloat16
for the control; grid sums run in float64 for a float32 state.

Conventions that the configuration's semantics fix, and that the
reference therefore follows:

- a live particle whose pushed x is below 0 is absorbed at the left wall,
  one at or beyond L at the right wall; it dies where it lands, with its
  weight zeroed and its x clamped into [0, float32(L) * float32(1 - 1e-7)]
  (a dead row stays inside the domain, so its cell index is valid);
- a primary absorbed in slot k emits a secondary where element k of the
  uniform draw is below the yield; the secondary starts float32(L) * 1e-6
  inside its wall, with velocity vth times element k of the normal draw,
  its x component turned into the domain, and the emission weight;
- the j-th emitting primary (in slot order) takes the j-th dead slot of
  the target after the absorption; one with no dead slot left is dropped
  and counted.
"""

from __future__ import annotations

import torch

from perfbench.reference import pic_ref
from perfbench.reference.pic_ref import Species


def park_hi(length: float) -> float:
    """float32(L) * float32(1 - 1e-7): where an absorbed row is parked."""
    return float(torch.tensor(length, dtype=torch.float32)
                 * torch.tensor(1.0 - 1e-7, dtype=torch.float32))


def absorb(sp: Species, length: float):
    """Absorption at both walls of the pushed ``sp``: (species, hit_left,
    hit_right)."""
    hl = sp.alive & (sp.x < 0.0)
    hr = sp.alive & (sp.x >= length)
    alive = sp.alive & ~(hl | hr)
    x = torch.clamp(sp.x, 0.0, park_hi(length))
    return Species(x, sp.v, sp.w * alive.to(sp.x.dtype), alive), hl, hr


def emit(target: Species, hl: torch.Tensor, hr: torch.Tensor,
         yield_: float, vth: float, weight: float, length: float,
         draws: dict) -> tuple[Species, int, int]:
    """The secondaries of the primaries that ``hl`` / ``hr`` mark, into
    ``target``. Returns (target, emitted, dropped)."""
    dtype = target.x.dtype
    dev = target.x.device
    want = (hl | hr) & (draws["uniform"].to(dtype) < yield_)
    v = vth * draws["normal"].to(dtype)
    vx = v[:, 0].abs()
    v[:, 0] = torch.where(hl, vx, -vx)
    eps = torch.tensor(length, dtype=dtype, device=dev) * 1e-6
    x = torch.where(hl, eps, length - eps).to(dtype)
    src = torch.nonzero(want).flatten()
    dead = torch.nonzero(~target.alive).flatten()
    n = min(src.numel(), dead.numel())
    src, dest = src[:n], dead[:n]
    out = target.clone()
    out.x[dest] = x[src]
    out.v[dest] = v[src]
    out.w[dest] = weight
    out.alive[dest] = True
    return out, n, int(want.sum()) - n


def wall_step(sps: list[Species], rho: torch.Tensor, cfg: dict,
              draws: list[dict]) -> tuple[list[Species], torch.Tensor, dict]:
    """One step from the species ``sps`` and the carried charge density
    ``rho``. ``cfg`` is a configuration file's dict (its ``wall_emission``
    pairs (primary, target) in order); ``draws`` one dict a pair, each
    with ``uniform`` (cap,) and ``normal`` (cap, 3) of the primary's
    capacity. Returns (species, next rho, counts by the program's
    diagnostic names)."""
    nc, dx, dt = cfg["nc"], cfg["dx"], cfg["dt"]
    specs = cfg["species"]
    length = nc * dx
    dtype = sps[0].x.dtype
    e = pic_ref.efield(rho, dx, cfg["eps0"], cfg["smoothing_passes"], dtype)
    info: dict = {}
    hits = []
    out = []
    for sp, sc in zip(sps, specs):
        pushed = pic_ref.push(sp, e, sc["charge"], sc["mass"], dt, nc, dx,
                              "open")
        pushed, hl, hr = absorb(pushed, length)
        out.append(pushed)
        hits.append((hl, hr))
        info[f"{sc['name']}/absorbed_left"] = int(hl.sum())
        info[f"{sc['name']}/absorbed_right"] = int(hr.sum())
    for (p, t), d in zip(cfg["wall_emission"], draws):
        out[t], n, dropped = emit(out[t], *hits[p], cfg["emission_yield"],
                                  cfg["emission_vth"],
                                  cfg["emission_weight"], length, d)
        name = specs[t]["name"]
        info[f"{name}/emitted"] = info.get(f"{name}/emitted", 0) + n
        info[f"{name}/emission_dropped"] = \
            info.get(f"{name}/emission_dropped", 0) + dropped
    rho = pic_ref.charge_density(out, specs, nc, dx, pic_ref.acc_dtype(dtype))
    return out, rho, info
