"""The program's configuration objects, built straight from the numbers of
a configuration file and a workload file (never from the program's own
preset configurations, which a later change may alter). The program is
imported inside each function, so the benchmark's files import without
it."""

from __future__ import annotations


def pic_config(cfg: dict, traffic: dict):
    """``repro_torch.core.pic.PICConfig`` of a cell."""
    from repro_torch.core import pic
    from repro_torch.core.collisions import CollisionConfig

    species = tuple(
        pic.SpeciesConfig(s["name"], float(s["charge"]), float(s["mass"]),
                          int(s["capacity"]), int(s["n_init"]),
                          vth=float(s["vth"]), weight=float(s["weight"]))
        for s in cfg["species"])
    ion = traffic.get("ionization")
    menu = tuple(CollisionConfig(e["kind"], int(e["species"]),
                                 e.get("partner"), float(e["rate"]))
                 for e in traffic.get("collisions", []))
    return pic.PICConfig(
        nc=int(cfg["nc"]), dx=float(cfg["dx"]), dt=float(cfg["dt"]),
        species=species, field_solve=bool(traffic["field_solve"]),
        smoothing_passes=int(cfg["smoothing_passes"]),
        strategy=cfg["strategy"], boundary=cfg["boundary"],
        eps0=float(cfg["eps0"]),
        ionization=None if ion is None else tuple(ion["triple"]),
        ionization_rate=0.0 if ion is None else float(ion["rate"]),
        ionization_vth_e=float(cfg["ionization_vth_e"]),
        collisions=menu,
        collide_kernel=bool(traffic.get("collide_kernel", False)),
        diag_every=1)


def engine_config(cfg: dict, traffic: dict):
    """``repro_torch.distributed.engine.EngineConfig`` of a cell."""
    from repro_torch.distributed import engine

    return engine.EngineConfig(
        pic=pic_config(cfg, traffic), domains=int(cfg["domains"]),
        async_n=int(cfg["async_n"]), max_migration=int(cfg["max_migration"]),
        max_births=int(cfg["max_births"]), use_ring=bool(cfg["use_ring"]),
        rebalance_every=0, rebalance_skew=0, cell_order=False, metrics=False)


def build() -> tuple[float, int]:
    """Build the program's CUDA kernels now, as their first launch would:
    (seconds, sources compiled). Nothing compiles where a build of the
    same sources is already in the checkout."""
    import time

    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build()
    return time.perf_counter() - t0, _build.builds
