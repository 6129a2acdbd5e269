"""The reference side of ``tests/test_torch_engine.py``: runs the JAX
engine on emulated host devices and writes each case's states and
diagnostics, step by step, to an npz file.

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/_torch_engine_ref.py OUT.npz [--params]

The port side reads the file; the reference's keys in it give the random
draws (``_torch_parity.engine_draws``). With ``--params`` it runs the
reference's ``make_engine_step(with_params=True)`` instead, on
``PARAMS_CASE`` at ``PARAMS_POINT`` and the samples ``PARAMS_SAMPLES``
(``tests/test_torch_params.py``).
"""

import sys

import numpy as np

STEPS = 3
SAMPLES = ((1, 1), (2, 2), (4, 1), (4, 4))   # (domains, async_n)
NC, CAP, N0 = 64, 1024, 512                   # global sizes
MAX_MIGRATION, MAX_BIRTHS, SEED = 64, 64, 3


def case_config(pic, name):
    """The two parity configurations, on either package's ``pic``."""
    if name == "periodic_field":
        sp = (pic.SpeciesConfig("e", -1.0, 1.0, CAP, N0, vth=1.0,
                                weight=0.02),
              pic.SpeciesConfig("D+", 1.0, 3672.0, CAP, N0, vth=0.02,
                                weight=0.02))
        return pic.PICConfig(nc=NC, dx=1.0, dt=0.2, species=sp,
                             field_solve=True, boundary="periodic",
                             strategy="fused")
    sp = (pic.SpeciesConfig("e", -1.0, 1.0, CAP, N0, vth=1.5),
          pic.SpeciesConfig("D+", 1.0, 3672.0, CAP, N0, vth=0.02),
          pic.SpeciesConfig("D", 0.0, 3672.0, CAP, N0, vth=0.05))
    return pic.PICConfig(
        nc=NC, dx=1.0, dt=0.4, species=sp, field_solve=False,
        boundary="absorb", strategy="fused", ionization=(2, 0, 1),
        ionization_rate=5e-2, ionization_vth_e=1.0, wall_emission=((0, 0),),
        emission_yield=0.7, emission_vth=0.5)


CASES = ("periodic_field", "absorb_see_ionize")

# the runtime-parameter run: the absorbing case with the collision menu and
# a magnetic field on, stepped at a parameter point other than its own
PARAMS_CASE = "absorb_see_ionize_menu"
PARAMS_SAMPLES = ((1, 1), (2, 2))
PARAMS_POINT = dict(dt=0.3, ionization_rate=8e-2, emission_yield=0.5,
                    b_field=(0.0, 0.0, 0.08),
                    collision_rates=(4e-2, 3e-2, 2e-2))


def params_config(pic, cfgs):
    """``PARAMS_CASE`` on either package's ``pic`` and ``configs.pic_bit1``
    (``cfgs``)."""
    import dataclasses

    return dataclasses.replace(case_config(pic, "absorb_see_ionize"),
                               collisions=cfgs.make_collision_menu(),
                               b_field=(0.0, 0.01, 0.05))


def export(est):
    """{name: array} of a reference EngineState."""
    out = {"step": np.asarray(est.pic.step), "key": np.asarray(est.pic.key)}
    if est.pic.rho is not None:
        out["rho"] = np.asarray(est.pic.rho)
    for i, b in enumerate(est.pic.species):
        for f in ("x", "v", "w", "alive"):
            out[f"species/{i}/{f}"] = np.asarray(getattr(b, f))
    for g, rg in enumerate(est.rings):
        for f in ("slots", "head", "count"):
            out[f"rings/{g}/{f}"] = np.asarray(getattr(rg, f))
    for g, p in enumerate(est.pending):
        for f in ("x", "v", "w", "alive", "dest"):
            out[f"pending/{g}/{f}"] = np.asarray(getattr(p, f))
    return out


def main(path):
    from repro.core import pic
    from repro.distributed import engine
    from repro.launch.mesh import make_debug_mesh

    arrays = {}
    for case in CASES:
        cfg = case_config(pic, case)
        for d, an in SAMPLES:
            mesh = make_debug_mesh(data=d, model=1)
            ecfg = engine.EngineConfig(
                pic=cfg, axis_names=("data",), async_n=an,
                max_migration=MAX_MIGRATION, max_births=MAX_BIRTHS)
            est = engine.init_engine_state(ecfg, mesh, SEED)
            step = engine.make_engine_step(ecfg, mesh)
            tag = f"{case}/{d}x{an}"
            for t in range(STEPS + 1):
                for k, v in export(est).items():
                    arrays[f"{tag}/s{t}/{k}"] = v
                if t == STEPS:
                    break
                est, diag = step(est)
                for k, v in diag.items():
                    arrays[f"{tag}/d{t}/{k}"] = np.asarray(v)
    np.savez(path, **arrays)


def main_params(path):
    from repro.configs import pic_bit1
    from repro.core import pic
    from repro.core.params import runtime_params
    from repro.distributed import engine
    from repro.launch.mesh import make_debug_mesh

    cfg = params_config(pic, pic_bit1)
    point = dict(PARAMS_POINT)
    rp = runtime_params(cfg, collision_rates=point.pop("collision_rates"),
                        **point)
    arrays = {}
    for d, an in PARAMS_SAMPLES:
        mesh = make_debug_mesh(data=d, model=1)
        ecfg = engine.EngineConfig(
            pic=cfg, axis_names=("data",), async_n=an,
            max_migration=MAX_MIGRATION, max_births=MAX_BIRTHS)
        est = engine.init_engine_state(ecfg, mesh, SEED)
        step = engine.make_engine_step(ecfg, mesh, with_params=True)
        tag = f"{PARAMS_CASE}/{d}x{an}"
        for t in range(STEPS + 1):
            for k, v in export(est).items():
                arrays[f"{tag}/s{t}/{k}"] = v
            if t == STEPS:
                break
            est, diag = step(est, rp)
            for k, v in diag.items():
                arrays[f"{tag}/d{t}/{k}"] = np.asarray(v)
    np.savez(path, **arrays)


if __name__ == "__main__":
    if "--params" in sys.argv[2:]:
        main_params(sys.argv[1])
    else:
        main(sys.argv[1])
