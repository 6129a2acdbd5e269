"""The §3.3 configuration with the field solve on is past the leapfrog's
stability limit, in the port and in the reference alike.

The paper's §3.3 test runs with the field solve off. With it on, the
electrons' plasma frequency at the §3.3 density (102.4 electrons a cell of
dx = 1, unit charge, mass and eps0) is sqrt(102.4) = 10.12, and
omega_p * dt = 2.024 at dt = 0.2: past 2, where the leapfrog push stops
oscillating and grows. These tests hold that reading at a cut scale (200
cells at the same density, so the same omega_p): the electrons' kinetic
energy grows ~2.7x a step in both packages, and at the bench
configuration's density (64 a cell, omega_p * dt = 1.6) it does not.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import pytest

import _torch_parity  # noqa: F401  (one torch thread a test process)
from repro.configs import pic_bit1 as ref_configs
from repro.core import pic as ref_pic
from repro_torch.configs import pic_bit1 as configs
from repro_torch.core import pic

NC = 200
STEPS = 8


def omega_p_dt(cfg) -> float:
    """The electrons' plasma frequency times dt at the mean density."""
    e = cfg.species[0]
    n = e.n_init * e.weight / (cfg.nc * cfg.dx)
    return math.sqrt(n * e.charge ** 2 / (cfg.eps0 * e.mass)) * cfg.dt


def test_bit1_density_puts_omega_p_dt_past_the_leapfrog_limit():
    for make_config, make_bench in (
            (configs.make_config, configs.make_bench_config),
            (ref_configs.make_config, ref_configs.make_bench_config)):
        assert omega_p_dt(make_config()) == pytest.approx(
            math.sqrt(10_485_760 / 102_400) * 0.2, rel=1e-12)
        assert omega_p_dt(make_config()) > 2.0
        assert omega_p_dt(make_bench()) == pytest.approx(1.6, rel=1e-12)


def _cut(cfg, per_cell: float):
    """``cfg`` on NC cells at ``per_cell`` particles a cell of each
    species, field solve on."""
    n = int(per_cell * NC)
    species = tuple(dataclasses.replace(s, capacity=2 * n, n_init=n)
                    for s in cfg.species)
    return dataclasses.replace(cfg, nc=NC, species=species,
                               field_solve=True)


def _ke_growth(init, make_step, cfg) -> np.ndarray:
    """The electrons' kinetic energy's ratio from each step to the next."""
    state, step = init(cfg), make_step(cfg)
    ke = []
    for _ in range(STEPS):
        state, diag = step(state)
        ke.append(float(diag["e/ke"]))
    ke = np.array(ke)
    return ke[1:] / ke[:-1]


@pytest.mark.parametrize("per_cell, grows", [(102.4, True), (64.0, False)])
def test_field_on_growth_matches_the_reference(per_cell, grows):
    port = _ke_growth(lambda c: pic.init_state(c, 0, device="cpu"),
                      pic.make_step,
                      _cut(configs.make_config(mover_strategy="fused"),
                           per_cell))
    ref = _ke_growth(lambda c: ref_pic.init_state(c, 0), ref_pic.make_step,
                     _cut(ref_configs.make_config(mover_strategy="fused"),
                          per_cell))
    gm_port = float(np.exp(np.log(port).mean()))
    gm_ref = float(np.exp(np.log(ref).mean()))
    print(f"{per_cell} a cell: e- KE ratio a step, port {np.round(port, 3)} "
          f"(geometric mean {gm_port:.3f}), reference {np.round(ref, 3)} "
          f"({gm_ref:.3f})")
    if grows:
        assert gm_port > 2.0 and gm_ref > 2.0
        assert gm_port == pytest.approx(gm_ref, rel=0.1)
    else:
        assert gm_port < 1.2 and gm_ref < 1.2
