"""Plain PyTorch reference of one step of the multi-domain engine: D slabs
of a periodic 1D domain, each with async(n) queues, as the paper's
decomposition (§4) defines them.

It imports nothing of the program; it reuses the single-domain
reference's push, deposit and field. What a step does, domain by domain:

1. rows that arrived or were born last step land in the slots the input
   names (``dest``); each must land once, in a dead slot of its own
   domain (``landing_err`` counts the rows that do not);
2. the electron density of each slab, with the shared edge nodes summed
   over the neighbours, sets the ionization rate; the field is the global
   solve of the slabs' assembled charge, cut back into slabs;
3. every row is pushed in its slab's frame, with no wrap;
4. queue k of a domain holds slots k, k + n, k + 2n, ... in that order. Its
   first ``max_births / n`` ionizing neutrals inside the slab ionize while
   both the electrons and the ions have a free slot; the neutral dies, an
   electron (Maxwellian, the draw of the neutral's queue row) and an ion
   (the neutral's velocity) are born at its position;
5. its first 2 m leavers (m = ``max_migration / n``), of which at most m
   a side, leave for the neighbour slab, shifted by the slab length, the
   ring of slabs wrapping around; a leaver beyond that budget stays,
   clamped just inside its slab;
6. births and arrivals wait as pending rows of the domain that receives
   them.

Pending rows are compared as a multiset: the slots they will take are the
program's choice. A step of the engine never changes vy or vz (no
magnetic field, no collision menu), and a birth's velocity comes from a
draw, so (vy, vz) names a row on both sides exactly.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference import pic_ref
from perfbench.reference.pic_ref import Species


def _cat(rows: list[dict], dtype, dev) -> dict:
    if not rows:
        return {"x": torch.zeros(0, dtype=dtype, device=dev),
                "v": torch.zeros(0, 3, dtype=dtype, device=dev),
                "w": torch.zeros(0, dtype=dtype, device=dev)}
    return {k: torch.cat([r[k] for r in rows]) for k in ("x", "v", "w")}


def flush(dom: list[list[Species]], pending) -> tuple[list, int]:
    """Land each pending row in its ``dest`` slot. Returns (domains,
    rows that hit a live or an already used slot, or a slot outside)."""
    bad = 0
    out = []
    for r, sps in enumerate(dom):
        row = []
        for s, sp in enumerate(sps):
            sp = sp.clone()
            if pending is not None:
                p = pending[r][s]
                cap = sp.x.numel()
                ok = p["alive"]
                dest = p["dest"][ok].long()
                inside = dest < cap
                bad += int((~inside).sum())
                dest = dest[inside]
                bad += dest.numel() - torch.unique(dest).numel()
                bad += int(sp.alive[dest].sum())
                sel = torch.nonzero(ok).flatten()[inside]
                sp.x[dest] = p["x"][sel].to(sp.x.dtype)
                sp.v[dest] = p["v"][sel].to(sp.x.dtype)
                sp.w[dest] = p["w"][sel].to(sp.x.dtype)
                sp.alive[dest] = True
            row.append(sp)
        out.append(row)
    return out, bad


def step(dom: list[list[Species]], pending, cfg: dict, traffic: dict,
         draws: list[dict]) -> dict:
    """One engine step. ``dom[r][s]`` holds domain r's rows of species s
    (its local slots), ``pending[r][s]`` the rows (x, v, w, alive, dest)
    waiting to land, or None. Returns the resident rows, the pending
    multiset, the carried charge of each slab, and the counters."""
    d, n_q = cfg["domains"], cfg["async_n"]
    nc, dx, dt = cfg["nc"], cfg["dx"], cfg["dt"]
    ncl = nc // d
    length = ncl * dx
    top = float(np.nextafter(np.float32(length), np.float32(0.0)))
    m_q = cfg["max_migration"] // n_q
    b_q = cfg["max_births"] // n_q
    specs = cfg["species"]
    ns = len(specs)
    dom, landing_err = flush(dom, pending)
    dtype = dom[0][0].x.dtype
    dev = dom[0][0].x.device
    acc = pic_ref.acc_dtype(dtype)
    ion = traffic.get("ionization")

    ne = None
    if ion is not None:
        ei = ion["triple"][1]
        dens = [pic_ref.deposit(sps[ei].x, sps[ei].w * sps[ei].alive.to(dtype),
                                ncl, dx, acc) for sps in dom]
        ne = []
        for r in range(d):
            t = dens[r].clone()
            if r > 0:
                t[0] += dens[r - 1][-1]
            if r < d - 1:
                t[-1] += dens[r + 1][0]
            ne.append(t.to(dtype))

    if traffic["field_solve"]:
        rho_g = torch.zeros(nc + 1, dtype=acc, device=dev)
        for r, sps in enumerate(dom):
            rho_g[r * ncl:(r + 1) * ncl + 1] += pic_ref.charge_density(
                sps, specs, ncl, dx, acc)
        e_g = pic_ref.efield(rho_g, dx, cfg["eps0"], cfg["smoothing_passes"],
                             dtype)
        e = [e_g[r * ncl:(r + 1) * ncl + 1] for r in range(d)]
    else:
        e = [torch.zeros(ncl + 1, dtype=dtype, device=dev)] * d

    pushed = [[pic_ref.push(sp, e[r], sc["charge"], sc["mass"], dt, ncl, dx,
                            "open") for sp, sc in zip(sps, specs)]
              for r, sps in enumerate(dom)]
    arrivals = [[[] for _ in range(ns)] for _ in range(d)]
    births = [[[] for _ in range(ns)] for _ in range(d)]
    n_ionized = overflow = 0
    for r in range(d):
        sps = pushed[r]
        cap = sps[0].x.numel()
        claimed = 0
        if ion is not None:
            ni, ei, ii = ion["triple"]
            avail = min(int((~sps[ei].alive).sum()),
                        int((~sps[ii].alive).sum()))
        for k in range(n_q):
            sub = torch.arange(k, cap, n_q, device=dev)
            if ion is not None:
                nt = sps[ni]
                dq = draws[r]["ionize"][k]
                q = Species(nt.x[sub], nt.v[sub], nt.w[sub], nt.alive[sub])
                hit = pic_ref.ionization_hits(q, ne[r], ion["rate"], dt,
                                              dq["uniform"], ncl, dx,
                                              inside_only=True)
                hits = torch.nonzero(hit).flatten()
                packed = hits[:b_q]
                take = max(0, min(packed.numel(), avail - claimed))
                src = packed[:take]
                claimed += take
                n_ionized += take
                overflow += hits.numel() - take
                vel_e = cfg["ionization_vth_e"] * dq["normal"].to(dtype)[src]
                births[r][ei].append({"x": q.x[src], "v": vel_e,
                                      "w": q.w[src]})
                births[r][ii].append({"x": q.x[src], "v": q.v[src],
                                      "w": q.w[src]})
                slots = sub[src]
                nt.alive[slots] = False
                nt.w[slots] = 0.0
            for s, sp in enumerate(sps):
                x = sp.x[sub]
                leave = sp.alive[sub] & ((x < 0.0) | (x >= length))
                li = torch.nonzero(leave).flatten()[:2 * m_q]
                xl = x[li]
                went_l, went_r = xl < 0.0, xl >= length
                ok_l = went_l & (torch.cumsum(went_l, 0) - 1 < m_q)
                ok_r = went_r & (torch.cumsum(went_r, 0) - 1 < m_q)
                for okm, shift, to in ((ok_l, length, (r - 1) % d),
                                       (ok_r, -length, (r + 1) % d)):
                    rows = sub[li[okm]]
                    arrivals[to][s].append({"x": sp.x[rows] + shift,
                                            "v": sp.v[rows], "w": sp.w[rows]})
                    sp.alive[rows] = False
                    sp.w[rows] = 0.0
                stay = sub[leave]
                stay = stay[sp.alive[stay]]
                sp.x[stay] = sp.x[stay].clamp(0.0, top)
    pend = [[_cat(arrivals[r][s] + births[r][s], dtype, dev)
             for s in range(ns)] for r in range(d)]
    rho = None
    if traffic["field_solve"]:
        rho = []
        for r in range(d):
            t = pic_ref.charge_density(pushed[r], specs, ncl, dx, acc)
            for s, sc in enumerate(specs):
                if sc["charge"] != 0.0 and pend[r][s]["x"].numel():
                    t = t + pic_ref.deposit(pend[r][s]["x"],
                                            sc["charge"] * pend[r][s]["w"],
                                            ncl, dx, acc)
            rho.append(t)
        rho = torch.stack(rho)
    counts = [sum(int(pushed[r][s].alive.sum()) + pend[r][s]["x"].numel()
                  for r in range(d)) for s in range(ns)]
    return {"dom": pushed, "pending": pend, "rho": rho, "counts": counts,
            "n_ionized": n_ionized, "birth_overflow": overflow,
            "landing_err": landing_err}
