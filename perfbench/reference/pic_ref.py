"""Plain PyTorch reference of one §3.3 PIC cycle: CIC gather and deposit,
the push with its wall or periodic wrap, the binomial smoother, the
Poisson solve and E, MC ionization and the binary-collision menu.

It imports nothing of the program. Every function takes whole particle
arrays and runs on their device. ``dtype`` is the precision the state is
computed in: float32 as the configuration states, bfloat16 for the
control. Grid sums accumulate in float64 where the state is float32
(rounding the program's float32 atomics do not have to match), and in the
state's dtype otherwise.

Conventions that the configuration's semantics fix, and that the
reference therefore follows:

- a division by dx or by the length L is a multiply by float32(1/x), the
  rounding of the published package (``inv``);
- q/m*dt is float32(q/m) times float32(dt), and the half kick 0.5 of it;
- a periodic position wraps as x - floor(x/L)*L, a domain slab leaves its
  positions raw;
- the k-th ionized neutral (in slot order) takes the k-th dead slot of the
  electrons and of the ions, and a birth needs a slot in both;
- the collision menu reads its draws through the occupancy rank (the k-th
  eligible row reads element k), orders a cell's rows by (cell, shuffle
  draw, slot), and pairs rows 0-1, 2-3, ... of each cell;
- a Takizuka-Abe angle's cos and sin multiply by 1/(1 + delta^2), the
  deflection kernel's order of operations.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch


def inv(v: float) -> float:
    """float32(1 / float32(v))."""
    return float(np.float32(1.0) / np.float32(v))


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.float32 else dtype


@dataclass
class Species:
    x: torch.Tensor       # (cap,)
    v: torch.Tensor       # (cap, 3)
    w: torch.Tensor       # (cap,)
    alive: torch.Tensor   # (cap,) bool

    def to(self, dtype) -> "Species":
        return Species(self.x.to(dtype), self.v.to(dtype), self.w.to(dtype),
                       self.alive.clone())

    def clone(self) -> "Species":
        return Species(self.x.clone(), self.v.clone(), self.w.clone(),
                       self.alive.clone())


def cic(x: torch.Tensor, nc: int, dx: float):
    """Left node (clipped to [0, nc-1]) and fraction (clipped to [0, 1])."""
    s = x * inv(dx)
    i = torch.floor(s).long().clamp(0, nc - 1)
    return i, torch.clamp(s - i.to(s.dtype), 0.0, 1.0)


def deposit(x: torch.Tensor, q: torch.Tensor, nc: int, dx: float,
            acc: torch.dtype) -> torch.Tensor:
    """CIC charge q at x onto the nc+1 nodes, over dx, summed in ``acc``."""
    i, f = cic(x, nc, dx)
    q = q.to(acc)
    f = f.to(acc)
    rho = torch.zeros(nc + 1, dtype=acc, device=x.device)
    rho.index_add_(0, i, q * (1.0 - f))
    rho.index_add_(0, i + 1, q * f)
    return rho * inv(dx)


def gather(field: torch.Tensor, x: torch.Tensor, nc: int, dx: float):
    i, f = cic(x, nc, dx)
    field = field.to(x.dtype)
    return field[i] * (1.0 - f) + field[i + 1] * f


def smooth(f: torch.Tensor, passes: int) -> torch.Tensor:
    """(1/4, 1/2, 1/4) with the one-sided (3/4, 1/4) stencil at the walls."""
    for _ in range(passes):
        out = torch.empty_like(f)
        out[1:-1] = 0.25 * f[:-2] + 0.5 * f[1:-1] + 0.25 * f[2:]
        out[0] = 0.75 * f[0] + 0.25 * f[1]
        out[-1] = 0.25 * f[-2] + 0.75 * f[-1]
        f = out
    return f


def efield(rho: torch.Tensor, dx: float, eps0: float, passes: int,
           dtype: torch.dtype) -> torch.Tensor:
    """E on the nodes from rho: smooth, then the exact solution of
    -(phi[i+1] - 2 phi[i] + phi[i-1]) / dx^2 = rho[i] / eps0 for the
    interior nodes with phi = 0 at both walls, then E = -dphi/dx (centred
    inside, one-sided at the walls). The solve is two running sums:
    phi[i] = i*g0 - sum_{j<i} sum_{k=1..j} f[k], g0 from phi[n] = 0."""
    rho = smooth(rho.to(dtype), passes)
    acc = acc_dtype(dtype)
    f = rho.to(acc) * (dx * dx) / eps0
    n = f.shape[0] - 1
    inner = torch.cumsum(f, 0) - f[0]
    s2 = torch.cumsum(inner, 0)
    g0 = s2[n - 1] / n
    i = torch.arange(n + 1, dtype=acc, device=f.device)
    phi = i * g0 - torch.cat([s2.new_zeros(1), s2[:-1]])
    phi[0] = 0.0
    phi[n] = 0.0
    e = torch.empty_like(phi)
    e[1:-1] = -(phi[2:] - phi[:-2]) / (2.0 * dx)
    e[0] = -(phi[1] - phi[0]) / dx
    e[-1] = -(phi[-1] - phi[-2]) / dx
    return e.to(dtype)


def push(sp: Species, e: torch.Tensor, charge: float, mass: float,
         dt: float, nc: int, dx: float, boundary: str) -> Species:
    """Gather, two half kicks along x (no magnetic field), drift, and the
    periodic wrap (``boundary='periodic'``) or none (``'open'``)."""
    dtype = sp.x.dtype
    dt_t = torch.tensor(dt, dtype=torch.float32)
    qm_dt = torch.tensor(charge / mass, dtype=torch.float32) * dt_t
    half = (0.5 * qm_dt).to(dtype).to(sp.x.device)
    dt_d = dt_t.to(dtype).to(sp.x.device)
    ex = gather(e, sp.x, nc, dx) * sp.alive.to(dtype)
    vx = sp.v[:, 0] + half * ex
    vx = vx + half * ex
    x = sp.x + vx * dt_d
    if boundary == "periodic":
        length = nc * dx
        x = x - torch.floor(x * inv(length)) * length
    elif boundary != "open":
        raise ValueError(f"reference push has no boundary {boundary!r}")
    v = sp.v.clone()
    v[:, 0] = vx
    return Species(x, v, sp.w * sp.alive.to(dtype), sp.alive.clone())


def ionization_hits(neutrals: Species, ne: torch.Tensor, rate: float,
                    dt: float, u: torch.Tensor, nc: int, dx: float,
                    inside_only: bool = False) -> torch.Tensor:
    """Which neutrals ionize: u < 1 - exp(-n_e(x) rate dt)."""
    dtype = neutrals.x.dtype
    ne_at = gather(ne.to(dtype), neutrals.x, nc, dx)
    p = 1.0 - torch.exp(-ne_at * rate * dt)
    ok = neutrals.alive
    if inside_only:
        ok = ok & (neutrals.x >= 0.0) & (neutrals.x < nc * dx)
    return ok & (u.to(dtype) < p)


def ionize(electrons: Species, ions: Species, neutrals: Species,
           rate: float, vth_e: float, dt: float, nc: int, dx: float,
           draws: dict) -> tuple[Species, Species, Species, int, int]:
    """MC ionization of the single-domain cycle, on the pushed buffers.
    The electron density is the pushed electrons' CIC number density.
    Returns (electrons, ions, neutrals, ionized, refused)."""
    dtype = neutrals.x.dtype
    acc = acc_dtype(dtype)
    ne = deposit(electrons.x, electrons.w * electrons.alive.to(dtype), nc,
                 dx, acc).to(dtype)
    hit = ionization_hits(neutrals, ne, rate, dt, draws["uniform"], nc, dx)
    src = torch.nonzero(hit).flatten()
    dead_e = torch.nonzero(~electrons.alive).flatten()
    dead_i = torch.nonzero(~ions.alive).flatten()
    n = min(src.numel(), dead_e.numel(), dead_i.numel())
    src = src[:n]
    de, di = dead_e[:n], dead_i[:n]
    vel_e = vth_e * draws["normal"].to(dtype)[src]
    electrons, ions, neutrals = (electrons.clone(), ions.clone(),
                                 neutrals.clone())
    for sp, dest, vel in ((electrons, de, vel_e), (ions, di,
                                                   neutrals.v[src])):
        sp.x[dest] = neutrals.x[src]
        sp.v[dest] = vel
        sp.w[dest] = neutrals.w[src]
        sp.alive[dest] = True
    neutrals.alive[src] = False
    neutrals.w[src] = 0.0
    return electrons, ions, neutrals, n, int(hit.sum()) - n


# ---- the binary-collision menu ----------------------------------------------

def _eligible(sp: Species, nc: int, dx: float) -> torch.Tensor:
    return sp.alive & (sp.x >= 0.0) & (sp.x < nc * dx)


def _cell(sp: Species, ok: torch.Tensor, nc: int, dx: float):
    """Cell of each row, ``nc`` for a row that may not collide."""
    c = torch.floor(sp.x * inv(dx)).long().clamp(0, nc - 1)
    return torch.where(ok, c, nc)


def _rank(ok: torch.Tensor) -> torch.Tensor:
    """Occupancy rank: the k-th eligible row reads element k of a draw."""
    return (torch.cumsum(ok, 0) - 1).clamp(0, ok.numel() - 1)


def cell_density(sp: Species, nc: int, dx: float) -> torch.Tensor:
    """Weight of the eligible rows in each cell, over dx: (nc,)."""
    ok = _eligible(sp, nc, dx)
    c = _cell(sp, ok, nc, dx)
    acc = acc_dtype(sp.x.dtype)
    h = torch.zeros(nc + 1, dtype=acc, device=sp.x.device)
    h.index_add_(0, c, torch.where(ok, sp.w, 0.0).to(acc))
    return (h[:nc] * inv(dx)).to(sp.x.dtype)


def _at(n_cell: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    return torch.cat([n_cell, n_cell.new_zeros(1)])[c]


def _prob(n_at: torch.Tensor, rate: float, dt: float) -> torch.Tensor:
    return -torch.expm1(-n_at * rate * dt)


def _cell_order(c: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Rows by (cell, u, slot): one stable sort of one integer key. A
    float32 in [0, 1) orders as its bit pattern does (a bfloat16 widens to
    float32 exactly)."""
    bits = u.float().contiguous().view(torch.int32).long()
    return torch.sort(c * (1 << 31) + bits, stable=True).indices


def _seg_start(cs: torch.Tensor, nc: int) -> torch.Tensor:
    counts = torch.bincount(cs, minlength=nc + 1)
    return (torch.cumsum(counts, 0) - counts)[cs]


def elastic(sp: Species, n_cell: torch.Tensor, rate: float, dt: float,
            nc: int, dx: float, d: dict) -> tuple[Species, int]:
    """Isotropic scattering at constant speed off a partner density."""
    dtype = sp.x.dtype
    ok = _eligible(sp, nc, dx)
    c = _cell(sp, ok, nc, dx)
    rows = _rank(ok)
    p = _prob(_at(n_cell, c).to(dtype), rate, dt)
    u, cos_t, phi = (d[k].to(dtype)[rows] for k in ("uniform", "cos", "phi"))
    hit = ok & (u < p)
    vx, vy, vz = sp.v[:, 0], sp.v[:, 1], sp.v[:, 2]
    speed = torch.sqrt(vx * vx + vy * vy + vz * vz)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    new = speed[:, None] * torch.stack(
        [cos_t, sin_t * torch.cos(phi), sin_t * torch.sin(phi)], -1)
    v = torch.where(hit[:, None], new, sp.v)
    return replace(sp, v=v), int(hit.sum())


def charge_exchange(ions: Species, neutrals: Species, nn_cell: torch.Tensor,
                    rate: float, dt: float, nc: int, dx: float, d: dict
                    ) -> tuple[Species, Species, int]:
    """The r-th event ion of a cell (in slot order) swaps velocities with
    the r-th neutral of the cell (in shuffled order), where it has one."""
    dtype = ions.x.dtype
    ok_i = _eligible(ions, nc, dx)
    c_i = _cell(ions, ok_i, nc, dx)
    p = _prob(_at(nn_cell, c_i).to(dtype), rate, dt)
    hit = ok_i & (d["uniform"].to(dtype)[_rank(ok_i)] < p)
    ok_n = _eligible(neutrals, nc, dx)
    c_n = _cell(neutrals, ok_n, nc, dx)
    order_n = _cell_order(c_n, d["shuffle"].to(dtype)[_rank(ok_n)])
    counts_n = torch.bincount(c_n, minlength=nc + 1)
    starts_n = torch.cumsum(counts_n, 0) - counts_n
    ev = torch.nonzero(hit).flatten()               # slot order
    ce = c_i[ev]
    ev_sorted = torch.sort(ce, stable=True).indices
    ev, ce = ev[ev_sorted], ce[ev_sorted]
    r = torch.arange(ev.numel(), device=ev.device) - _seg_start(ce, nc)
    has = r < counts_n[ce]
    ev, ce, r = ev[has], ce[has], r[has]
    partner = order_n[starts_n[ce] + r]
    iv, nv = ions.v.clone(), neutrals.v.clone()
    iv[ev] = neutrals.v[partner]
    nv[partner] = ions.v[ev]
    return replace(ions, v=iv), replace(neutrals, v=nv), int(ev.numel())


def ta_deflect(u: torch.Tensor, delta: torch.Tensor,
               phi: torch.Tensor) -> torch.Tensor:
    """Takizuka-Abe: rotate u through theta, tan(theta/2) = delta, about
    azimuth phi; returns du = u' - u."""
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
    up = torch.where(safe, uperp, torch.ones_like(uperp))
    dux = ((ux / up) * uz * sin_t * cphi - (uy / up) * umag * sin_t * sphi
           - ux * one_m)
    duy = ((uy / up) * uz * sin_t * cphi + (ux / up) * umag * sin_t * sphi
           - uy * one_m)
    duz = -up * sin_t * cphi - uz * one_m
    return torch.stack([torch.where(safe, dux, uz * sin_t * cphi),
                        torch.where(safe, duy, uz * sin_t * sphi),
                        torch.where(safe, duz, -uz * one_m)], -1)


def coulomb(sp: Species, n_cell: torch.Tensor, rate: float, dt: float,
            nc: int, dx: float, d: dict) -> tuple[Species, int]:
    """Takizuka-Abe intra-species pairs: rows 0-1, 2-3, ... of each cell
    in shuffled order; tan(theta/2) ~ N(0, rate n dt / |u|^3), and
    v1 += du/2, v2 -= du/2. The normal and azimuth draws are read at the
    pair head's position in the (cell, shuffle) order."""
    dtype = sp.x.dtype
    ok = _eligible(sp, nc, dx)
    c = _cell(sp, ok, nc, dx)
    order = _cell_order(c, d["shuffle"].to(dtype)[_rank(ok)])
    cs = c[order]
    n = cs.numel()
    t = torch.arange(n, device=cs.device)
    local = t - _seg_start(cs, nc)
    succ = torch.clamp(t + 1, max=n - 1)
    ia, ib = order, order[succ]
    valid = ((local % 2 == 0) & (t + 1 < n) & (cs[succ] == cs) & ok[ia]
             & ok[ib])
    u = sp.v[ia] - sp.v[ib]
    umag = torch.sqrt(u[:, 0] * u[:, 0] + u[:, 1] * u[:, 1]
                      + u[:, 2] * u[:, 2])
    n_at = _at(n_cell, c[ia]).to(dtype)
    var = rate * n_at * dt / torch.clamp(umag * umag * umag, min=1e-12)
    delta = torch.sqrt(var) * d["normal"].to(dtype)
    du = ta_deflect(u, delta, d["phi"].to(dtype))
    a, b, du = ia[valid], ib[valid], du[valid]
    v = sp.v.clone()
    v[a] = v[a] + 0.5 * du
    v[b] = v[b] - 0.5 * du
    return replace(sp, v=v), int(valid.sum())


KIND_DIAG = {"elastic": "coll_elastic", "charge_exchange": "coll_cx",
             "coulomb": "coll_coulomb"}


def menu(sps: list[Species], start: list[Species], entries: list[dict],
         dt: float, nc: int, dx: float, draws: list[dict]
         ) -> tuple[list[Species], dict]:
    """The collision menu in order on the pushed species ``sps``; the
    rates read the cell densities of the start-of-step species ``start``.
    Returns (species, event counts by diagnostic name)."""
    sps = list(sps)
    dens: dict = {}

    def density(i):
        if i not in dens:
            dens[i] = cell_density(start[i], nc, dx)
        return dens[i]

    counts: dict = {}
    for cc, d in zip(entries, draws):
        kind, s, p, rate = (cc["kind"], cc["species"], cc.get("partner"),
                            cc["rate"])
        if kind == "elastic":
            sps[s], n = elastic(sps[s], density(p), rate, dt, nc, dx, d)
        elif kind == "charge_exchange":
            sps[s], sps[p], n = charge_exchange(sps[s], sps[p], density(p),
                                                rate, dt, nc, dx, d)
        elif kind == "coulomb":
            sps[s], n = coulomb(sps[s], density(s), rate, dt, nc, dx, d)
        else:
            raise ValueError(f"unknown collision kind {kind!r}")
        key = KIND_DIAG[kind]
        counts[key] = counts.get(key, 0) + n
    return sps, counts


def cycle_step(sps: list[Species], cfg: dict, traffic: dict,
               draws: list[dict]) -> tuple[list[Species], dict]:
    """One cycle: field (from the start-of-step charge), push, collision
    menu, ionization. ``cfg`` is a configuration file's dict, ``traffic``
    a workload's; ``draws`` one dict per menu entry, then one for the
    ionization. Returns (species, info) with the event counts and, where
    the field is on, the carried charge density the next step reads."""
    nc, dx, dt = cfg["nc"], cfg["dx"], cfg["dt"]
    specs = cfg["species"]
    dtype = sps[0].x.dtype
    acc = acc_dtype(dtype)
    dev = sps[0].x.device
    info: dict = {}
    if traffic["field_solve"]:
        rho = charge_density(sps, specs, nc, dx, acc)
        e = efield(rho, dx, cfg["eps0"], cfg["smoothing_passes"], dtype)
    else:
        e = torch.zeros(nc + 1, dtype=dtype, device=dev)
    start = sps
    sps = [push(sp, e, sc["charge"], sc["mass"], dt, nc, dx,
                cfg["boundary"]) for sp, sc in zip(sps, specs)]
    draws = list(draws)
    entries = traffic.get("collisions", [])
    if entries:
        sps, counts = menu(sps, start, entries, dt, nc, dx,
                           draws[:len(entries)])
        info.update(counts)
        draws = draws[len(entries):]
    ion = traffic.get("ionization")
    if ion is not None:
        ni, ei, ii = ion["triple"]
        sps[ei], sps[ii], sps[ni], n, refused = ionize(
            sps[ei], sps[ii], sps[ni], ion["rate"], cfg["ionization_vth_e"],
            dt, nc, dx, draws[0])
        info["n_ionized"] = n
        info["birth_overflow"] = refused
    if traffic["field_solve"]:
        info["rho"] = charge_density(sps, specs, nc, dx, acc)
    return sps, info


def charge_density(sps, specs, nc, dx, acc) -> torch.Tensor:
    rho = None
    for sp, sc in zip(sps, specs):
        if sc["charge"] == 0.0:
            continue
        part = deposit(sp.x, sc["charge"] * sp.w * sp.alive.to(sp.x.dtype),
                       nc, dx, acc)
        rho = part if rho is None else rho + part
    return rho

