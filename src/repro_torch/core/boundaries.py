"""Plasma-wall interaction: secondary emission (the port of
``repro.core.boundaries``).

Each primary absorbed at a wall (the mover's wall-hit masks) re-emits a
secondary with probability ``yield_``, at the wall, with a half-Maxwellian
velocity directed into the domain.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.particles import SpeciesBuffer, inject_masked


class EmissionParams(NamedTuple):
    yield_: float          # secondaries per absorbed primary (<= 1)
    vth_emit: float        # thermal speed of emitted particles
    weight: float = 1.0


class EmissionRows(NamedTuple):
    """Emission candidates over one set of hit masks; ``ok`` marks the
    secondaries that landed (what a carried rho must deposit)."""

    x: torch.Tensor       # (M,)
    v: torch.Tensor       # (M, 3)
    w: torch.Tensor       # (M,)
    ok: torch.Tensor      # (M,) bool


def emission_candidates(gen: torch.Generator, hit_left: torch.Tensor,
                        hit_right: torch.Tensor, params: EmissionParams,
                        length: float, dtype, draws: dict | None = None):
    """Sample secondary-emission candidates from wall-hit masks (M,).
    ``draws``: ``"uniform"`` (M,) and ``"normal"`` (M, 3).

    Returns (emit mask, x, v, w); x/v are valid only where ``emit``.
    """
    dev = hit_left.device
    hit = hit_left | hit_right
    if draws is None:
        u = torch.rand(hit.shape, generator=gen, device=dev)
        nrm = torch.randn(hit.shape + (3,), generator=gen, dtype=dtype,
                          device=dev)
    else:
        u = torch.as_tensor(draws["uniform"], dtype=torch.float32,
                            device=dev)
        nrm = torch.as_tensor(draws["normal"], dtype=dtype, device=dev)
    emit = hit & (u < params.yield_)

    v = params.vth_emit * nrm
    vx = v[:, 0].abs()
    v[:, 0] = torch.where(hit_left, vx, -vx)
    eps = torch.full((), length, dtype=dtype, device=dev) * 1e-6
    x = torch.where(hit_left, eps, length - eps).to(dtype)
    w = torch.full(hit.shape, params.weight, dtype=dtype, device=dev)
    return emit, x, v, w


def wall_emission(gen: torch.Generator, absorbed: SpeciesBuffer,
                  hit_left: torch.Tensor, hit_right: torch.Tensor,
                  target: SpeciesBuffer, params: EmissionParams,
                  length: float, draws: dict | None = None
                  ) -> tuple[SpeciesBuffer, dict, EmissionRows]:
    """Re-emit secondaries into ``target`` for each absorbed primary.
    ``emitted`` counts the secondaries that landed; candidates refused by a
    full buffer are ``emission_dropped``."""
    emit, x, v, w = emission_candidates(gen, hit_left, hit_right, params,
                                        length, absorbed.x.dtype, draws)
    target, dropped, ok = inject_masked(target, x, v, w, emit)
    diag = {
        "emitted": ok.sum(dtype=torch.int32),
        "emission_dropped": dropped,
    }
    return target, diag, EmissionRows(x=x, v=v, w=w, ok=ok)
