"""The paper's own benchmark configuration (§3.3), BIT1 ionization test
(the port of ``repro.configs.pic_bit1``).

Scenario: unbounded unmagnetized plasma of (e-, D+, D); electron-impact
ionization depletes neutrals, dn/dt = -n n_e R. One-dimensional grid of
~100K cells, three species, ~10M macro-particles per species (30M total),
field solver and smoother disabled (the paper's test); mover + MC
ionization dominate.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core import pic

NC_GLOBAL = 102_400            # ~100K cells
N_PER_SPECIES = 10_485_760     # ~10M macro-particles (x3 species = ~30M)
CAPACITY = 16_777_216          # 16Mi slots: 1.6x headroom for births


def make_config(scale: int = 1, *, mover_strategy: str = "unified",
                boundary: str = "periodic",
                diag_every: int = 1) -> pic.PICConfig:
    """The published §3.3 configuration. ``scale`` only asserts
    divisibility (the reference's domain decomposition divides the sizes)."""
    assert NC_GLOBAL % max(scale, 1) == 0
    # weight 1.0 everywhere: without the field solve, macro-weights only set
    # the MC collision rates (n_e in P_ionize)
    species = (
        pic.SpeciesConfig("e", -1.0, 1.0, CAPACITY, N_PER_SPECIES, vth=1.0),
        pic.SpeciesConfig("D+", 1.0, 3672.0, CAPACITY, N_PER_SPECIES,
                          vth=0.016),
        pic.SpeciesConfig("D", 0.0, 3672.0, CAPACITY, N_PER_SPECIES,
                          vth=0.016),
    )
    return pic.PICConfig(
        nc=NC_GLOBAL, dx=1.0, dt=0.2, species=species,
        field_solve=False,                  # the paper's test disables it
        boundary=boundary,
        strategy=mover_strategy,
        ionization=(2, 0, 1), ionization_rate=1e-4, ionization_vth_e=1.0,
        diag_every=diag_every,
    )


def make_bench_config(nc: int = 4096, n: int = 262_144,
                      strategy: str = "unified",
                      diag_every: int = 1) -> pic.PICConfig:
    """Small version of the same physics (capacity 2n per species)."""
    cap = 2 * n
    species = (
        pic.SpeciesConfig("e", -1.0, 1.0, cap, n, vth=1.0),
        pic.SpeciesConfig("D+", 1.0, 3672.0, cap, n, vth=0.016),
        pic.SpeciesConfig("D", 0.0, 3672.0, cap, n, vth=0.016),
    )
    return pic.PICConfig(
        nc=nc, dx=1.0, dt=0.2, species=species, field_solve=False,
        boundary="periodic", strategy=strategy,
        ionization=(2, 0, 1), ionization_rate=1e-4, ionization_vth_e=1.0,
        diag_every=diag_every,
    )


def make_see_config(nc: int = 4096, n: int = 262_144,
                    strategy: str = "unified", emission_yield: float = 0.5,
                    emission_weight: float = 1.0,
                    diag_every: int = 1) -> pic.PICConfig:
    """Bounded-plasma variant: absorbing walls + secondary electron emission
    (electrons re-emit electrons) on top of the ionization scenario."""
    cfg = make_bench_config(nc=nc, n=n, strategy=strategy,
                            diag_every=diag_every)
    return dataclasses.replace(
        cfg, boundary="absorb", wall_emission=((0, 0),),
        emission_yield=emission_yield, emission_vth=0.5,
        emission_weight=emission_weight)
