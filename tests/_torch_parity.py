"""Helpers shared by the tests that hold the PyTorch port against the JAX
reference: numpy is the only bridge between the two packages."""

import jax
import numpy as np
import torch

from repro_torch.core import pic as port_pic

# the suite runs several worker processes on one machine's cores; torch's
# own per-op thread pool in each of them oversubscribes the cores and made
# a 5 s test take minutes, so the port's tests compute single-threaded
torch.set_num_threads(1)


def t(a, dtype=None):
    """numpy / JAX array -> CPU torch tensor."""
    out = torch.from_numpy(np.array(a))
    return out if dtype is None else out.to(dtype)


def n(a):
    """torch tensor or JAX array -> numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.array(a)


def port_state(cfg, jstate):
    """The port's CPU state from a reference PICState."""
    arrays = [{"x": n(b.x), "v": n(b.v), "w": n(b.w), "alive": n(b.alive)}
              for b in jstate.species]
    rho = None if jstate.rho is None else n(jstate.rho)
    return port_pic.state_from_numpy(cfg, arrays, int(jstate.step), rho,
                                     seed=0, device="cpu")


def _source_draws(key, shape):
    ku, kv = jax.random.split(key)
    return {"uniform": n(jax.random.uniform(ku, shape, np.float32)),
            "normal": n(jax.random.normal(kv, shape + (3,), np.float32))}


def _uniform(key, shape, lo=0.0, hi=1.0):
    return n(jax.random.uniform(key, shape, np.float32, lo, hi))


def collision_draws(cc, key, caps):
    """The arrays one menu entry's operator draws from its key (see
    ``repro.core.collisions``); ``caps`` maps species index -> capacity."""
    if cc.kind == "elastic":
        kp, k1, k2 = jax.random.split(key, 3)
        cap = (caps[cc.species],)
        return {"uniform": _uniform(kp, cap), "cos": _uniform(k1, cap, -1.0,
                                                               1.0),
                "phi": _uniform(k2, cap, 0.0, 2.0 * np.pi)}
    if cc.kind == "charge_exchange":
        kp, kn = jax.random.split(key)
        return {"uniform": _uniform(kp, (caps[cc.species],)),
                "shuffle": _uniform(kn, (caps[cc.partner],))}
    kp, kd, kf = jax.random.split(key, 3)
    cap = (caps[cc.species],)
    return {"shuffle": _uniform(kp, cap),
            "normal": n(jax.random.normal(kd, cap, np.float32)),
            "phi": _uniform(kf, cap, 0.0, 2.0 * np.pi)}


def menu_draws(cfgs, key, caps):
    """One dict per menu entry, as ``apply_menu`` splits its key."""
    out = []
    for cc in cfgs:
        key, sub = jax.random.split(key)
        out.append(collision_draws(cc, sub, caps))
    return out


def step_draws(cfg, key):
    """The random arrays the reference's step_fn draws from ``key``, in its
    key order: each collision-menu entry, each wall-emission pair, then
    ionization."""
    draws = []
    if cfg.collisions:
        key, sub = jax.random.split(key)
        draws += menu_draws(cfg.collisions, sub,
                            [sc.capacity for sc in cfg.species])
    if cfg.wall_emission and cfg.boundary == "absorb":
        for primary, _ in cfg.wall_emission:
            key, sub = jax.random.split(key)
            draws.append(_source_draws(
                sub, (cfg.species[primary].capacity,)))
    if cfg.ionization is not None:
        key, sub = jax.random.split(key)
        draws.append(_source_draws(
            sub, (cfg.species[cfg.ionization[0]].capacity,)))
    return draws


def periodic_dist(a, b, length):
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return np.minimum(d, length - d)


def engine_draws(cfg, keys, n_q, m_q, caps_q, group_of):
    """The random arrays the reference engine's step draws, per domain,
    from the domains' keys ``keys`` (D, 2), in its split order
    (``repro.distributed.engine``: the MC split, folded with the rank, into
    ionization keys per queue and SEE keys per pair and queue; then the
    collision split, folded with the rank, into keys per queue, each
    folded with the capacity group). ``caps_q`` maps species index ->
    queue capacity, ``group_of`` species index -> capacity group.

    Returns (draws for the port's step, the reference's keys after it)."""
    ion = cfg.ionization
    see = (tuple(cfg.wall_emission)
           if cfg.wall_emission and cfg.boundary == "absorb" else ())
    coll = tuple(cfg.collisions)
    draws, nxt = [], []
    for r, key in enumerate(np.asarray(keys)):
        key = jax.numpy.asarray(key)
        dr = {"ionize": [], "see": [], "collide": []}
        if ion is not None or see:
            key, k_mc = jax.random.split(key)
            k_mc = jax.random.fold_in(k_mc, r)
            k_ion, k_see = jax.random.split(k_mc)
            ion_keys = jax.random.split(k_ion, n_q)
            if ion is not None:
                dr["ionize"] = [_source_draws(ion_keys[k], (caps_q[ion[0]],))
                                for k in range(n_q)]
            if see:
                see_keys = jax.random.split(k_see, len(see) * n_q).reshape(
                    (len(see), n_q, -1))
                dr["see"] = [[_source_draws(see_keys[p, k], (2 * m_q,))
                              for k in range(n_q)] for p in range(len(see))]
        if coll:
            key, k_coll = jax.random.split(key)
            k_coll = jax.random.fold_in(k_coll, r)
            coll_keys = jax.random.split(k_coll, n_q)
            groups = sorted({group_of[cc.species] for cc in coll})
            dr["collide"] = [{
                g: menu_draws([cc for cc in coll if group_of[cc.species] == g],
                              jax.random.fold_in(coll_keys[k], g), caps_q)
                for g in groups} for k in range(n_q)]
        draws.append(dr)
        nxt.append(n(key))
    return draws, np.stack(nxt)
