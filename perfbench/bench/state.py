"""Inputs made from ``--seed`` on the device: the initial particles and
the Monte-Carlo draws of the check. Both sides get the same tensors."""

from __future__ import annotations

import math

import torch

SALT_INIT, SALT_PROGRAM, SALT_CHECK = 1, 2, 3


def mix(seed: int, salt: int) -> int:
    """A 63-bit generator seed from the run's seed and a salt."""
    return (int(seed) * 0x9E3779B97F4A7C15 + salt * 0xBF58476D1CE4E5B9) \
        % (1 << 63)


def generator(seed: int, salt: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(mix(seed, salt))


def species(gen: torch.Generator, rows: int, cap: int, n: int,
            length: float, vth: float, weight: float) -> dict:
    """``rows`` slabs of ``cap`` slots, the first ``n`` of each alive:
    x uniform over [0, length), v Maxwellian of spread vth, weight on the
    live rows. Two draws, on the generator's device."""
    dev = gen.device
    x = torch.rand(rows, cap, generator=gen, device=dev) * length
    v = torch.randn(rows, cap, 3, generator=gen, device=dev) * vth
    alive = (torch.arange(cap, device=dev) < n).expand(rows, cap).clone()
    w = alive.float() * weight
    return {"x": x, "v": v, "w": w, "alive": alive}


def uniform(gen, shape, lo=0.0, hi=1.0):
    u = torch.rand(shape, generator=gen, device=gen.device)
    return u if (lo, hi) == (0.0, 1.0) else lo + (hi - lo) * u


def menu_draws(gen, entry: dict, caps: list[int]) -> dict:
    """The arrays one collision-menu entry reads, bounded uniforms already
    scaled to their bounds."""
    kind = entry["kind"]
    cap = caps[entry["species"]]
    if kind == "elastic":
        return {"uniform": uniform(gen, cap), "cos": uniform(gen, cap, -1, 1),
                "phi": uniform(gen, cap, 0.0, 2 * math.pi)}
    if kind == "charge_exchange":
        return {"uniform": uniform(gen, cap),
                "shuffle": uniform(gen, caps[entry["partner"]])}
    if kind == "coulomb":
        return {"shuffle": uniform(gen, cap),
                "normal": torch.randn(cap, generator=gen, device=gen.device),
                "phi": uniform(gen, cap, 0.0, 2 * math.pi)}
    raise ValueError(f"unknown collision kind {kind!r}")


def ionize_draws(gen, n: int) -> dict:
    return {"uniform": uniform(gen, n),
            "normal": torch.randn(n, 3, generator=gen, device=gen.device)}
