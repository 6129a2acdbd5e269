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
from repro_torch.core.collisions import CollisionConfig

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


def make_resilience_config(nc: int = 64, n: int = 1024,
                           strategy: str = "fused",
                           emission_yield: float = 0.7,
                           field_solve: bool = True,
                           diag_every: int = 1) -> pic.PICConfig:
    """The full-churn workload: absorbing walls + secondary electron
    emission + MC ionization + the whole collision menu, equal species
    capacities, and the field solve on, so that ``strategy='fused'`` carries
    rho."""
    cap = 2 * n
    species = (
        pic.SpeciesConfig("e", -1.0, 1.0, cap, n, vth=1.0),
        pic.SpeciesConfig("D+", 1.0, 3672.0, cap, n, vth=0.02),
        pic.SpeciesConfig("D", 0.0, 3672.0, cap, n, vth=0.05),
    )
    return pic.PICConfig(
        nc=nc, dx=1.0, dt=0.5, species=species, field_solve=field_solve,
        boundary="absorb", strategy=strategy,
        collisions=make_collision_menu(),
        ionization=(2, 0, 1), ionization_rate=5e-3, ionization_vth_e=1.0,
        wall_emission=((0, 0),), emission_yield=emission_yield,
        emission_vth=0.5, diag_every=diag_every,
    )


# the menu aliases the launcher's --collisions flag accepts
COLLISION_MENU = ("elastic", "cx", "coulomb")


def make_collision_menu(menu=COLLISION_MENU, *, rate_elastic: float = 2e-3,
                        rate_cx: float = 2e-3, rate_coulomb: float = 1e-3
                        ) -> tuple[CollisionConfig, ...]:
    """The binary-collision menu over the (e-, D+, D) species triple:

    * ``elastic``: electrons scatter elastically off the neutrals;
    * ``cx``: resonant D+ <-> D charge exchange;
    * ``coulomb``: intra-species e-e Coulomb scattering (Takizuka-Abe).

    The default rates give a few-percent collision probability per step
    at the bench-scale densities.
    """
    out = []
    for m in menu:
        if m == "elastic":
            out.append(CollisionConfig("elastic", 0, 2, rate_elastic))
        elif m in ("cx", "charge_exchange"):
            out.append(CollisionConfig("charge_exchange", 1, 2, rate_cx))
        elif m == "coulomb":
            out.append(CollisionConfig("coulomb", 0, None, rate_coulomb))
        else:
            raise ValueError(
                f"unknown collision menu entry {m!r}; valid entries are "
                f"{COLLISION_MENU + ('charge_exchange',)}")
    return tuple(out)


def make_collision_config(nc: int = 4096, n: int = 262_144,
                          menu=COLLISION_MENU, strategy: str = "unified",
                          diag_every: int = 1, **rates) -> pic.PICConfig:
    """The ``collisions`` scenario: the collision menu on the bench-scale
    (e-, D+, D) plasma with MC ionization off."""
    cfg = make_bench_config(nc=nc, n=n, strategy=strategy,
                            diag_every=diag_every)
    return dataclasses.replace(
        cfg, ionization=None, collisions=make_collision_menu(menu, **rates))


def make_engine_config(pic_cfg: pic.PICConfig | None = None, *,
                       domains: int = 1, async_n: int = 1,
                       max_migration: int = 8192, rebalance_every: int = 0,
                       rebalance_skew: int = 0, max_births: int = 8192,
                       use_ring: bool = True, cell_order: bool = False,
                       metrics: bool = False, **bench_kw):
    """EngineConfig of the multi-domain engine with the knobs the launcher
    shares (the reference's, with ``domains`` for its mesh axes); with no
    ``pic_cfg`` the bench config is built from ``bench_kw``."""
    from repro_torch.distributed import engine  # deferred: configs stay light

    if pic_cfg is None:
        pic_cfg = make_bench_config(**bench_kw)
    return engine.EngineConfig(
        pic=pic_cfg, domains=domains, async_n=async_n,
        max_migration=max_migration, max_births=max_births,
        rebalance_every=rebalance_every, rebalance_skew=rebalance_skew,
        use_ring=use_ring, cell_order=cell_order, metrics=metrics)
