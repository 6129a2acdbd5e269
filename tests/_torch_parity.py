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


def step_draws(cfg, key):
    """The random arrays the reference's step_fn draws from ``key``, in its
    key order: each wall-emission pair, then ionization."""
    draws = []
    if cfg.collisions:
        raise NotImplementedError("collision menu draws")
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
