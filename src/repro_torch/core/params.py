"""Runtime parameters: the scalars a step may vary without changing its
shape (the port of ``repro.core.params``).

``PICConfig`` fixes the structure of a run: species, capacities, strategy,
the collision menu. ``RuntimeParams`` carries the values a step may take
anew at every call: dt, the per-species dt*stride and (q/m)*dt*stride
products, the magnetic field b, the ionization rate, the SEE yield and one
rate per collision-menu entry. The products are formed on the host in
Python float64 and cast once, as the static path forms them, so a step with
params is bit-identical to the step with the same values taken from the
config.

The kernels take b as host floats (the fused kernel picks its rotation
instance from them), so the params keep b twice: as a (3,) tensor, and as
the float32-rounded host triple ``b_host``, made once with the params; a
step reads ``b_host`` and never reads the tensor back from the card.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device

# PICConfig fields a RuntimeParams override may touch; everything else is a
# structural knob and needs a new config
RUNTIME_FIELDS = ("dt", "ionization_rate", "emission_yield", "b_field")


@dataclasses.dataclass(frozen=True)
class RuntimeParams:
    """The runtime scalars of one parameter point, as tensors on the run's
    device.

    dt              () — the base timestep
    dts             (S,) — dt * stride per species (host-formed)
    qm_dts          (S,) — (charge/mass) * dt * stride per species
    b_field         (3,) — uniform magnetic field vector
    ionization_rate () — MC ionization coefficient
    emission_yield  () — wall secondary-emission yield
    collision_rates tuple of () — one rate per collision-menu entry

    ``b_host`` is b as three float32-rounded Python floats (what the
    kernels take); pass ``host_b`` to skip reading ``b_field`` back.
    """
    dt: torch.Tensor
    dts: torch.Tensor
    qm_dts: torch.Tensor
    b_field: torch.Tensor
    ionization_rate: torch.Tensor
    emission_yield: torch.Tensor
    collision_rates: tuple[torch.Tensor, ...]
    host_b: dataclasses.InitVar[tuple[float, float, float] | None] = None

    def __post_init__(self, host_b):
        if host_b is None:
            host_b = self.b_field.tolist()
        object.__setattr__(self, "b_host", _f32_triple(host_b))

    @classmethod
    def from_config(cls, cfg, dtype=torch.float32,
                    device="cuda") -> "RuntimeParams":
        """The runtime point a config describes. Every product is formed
        in Python float64 before the one cast, as the static path forms
        it."""
        dev = resolve_device(device)
        dts = [float(cfg.dt) * sc.stride for sc in cfg.species]
        qm_dts = [(sc.charge / sc.mass) * float(cfg.dt) * sc.stride
                  for sc in cfg.species]

        def t(v):
            return torch.tensor(v, dtype=dtype, device=dev)

        return cls(dt=t(cfg.dt), dts=t(dts), qm_dts=t(qm_dts),
                   b_field=t(list(cfg.b_field)),
                   ionization_rate=t(cfg.ionization_rate),
                   emission_yield=t(cfg.emission_yield),
                   collision_rates=tuple(t(cc.rate) for cc in cfg.collisions),
                   host_b=tuple(cfg.b_field))


def _f32_triple(b) -> tuple[float, float, float]:
    return tuple(float(np.float32(c)) for c in b)


def runtime_params(cfg, dtype=torch.float32, collision_rates=None,
                   device="cuda", **overrides) -> RuntimeParams:
    """RuntimeParams for ``cfg`` with selected values overridden.

    Only the fields of ``RUNTIME_FIELDS`` may be overridden: another nc,
    strategy or menu structure changes the step's shape and needs a new
    config. ``collision_rates`` replaces the per-entry coefficients (its
    length must match the menu).
    """
    bad = sorted(set(overrides) - set(RUNTIME_FIELDS))
    if bad:
        raise ValueError(
            f"not runtime parameters: {bad}; traced overrides are limited to "
            f"{RUNTIME_FIELDS} (+ collision_rates). Static knobs (nc, "
            f"capacities, strategy, menu structure, ...) need a new config "
            f"and a fresh compile.")
    cfg2 = dataclasses.replace(cfg, **overrides) if overrides else cfg
    rp = RuntimeParams.from_config(cfg2, dtype, device)
    if collision_rates is not None:
        if len(collision_rates) != len(cfg.collisions):
            raise ValueError(
                f"collision_rates has {len(collision_rates)} entries for a "
                f"{len(cfg.collisions)}-entry menu")
        rp = dataclasses.replace(
            rp, collision_rates=tuple(
                torch.tensor(float(r), dtype=dtype, device=rp.dt.device)
                for r in collision_rates),
            host_b=rp.b_host)
    return rp


def b_active(cfg) -> bool:
    """Structural gate: does this config rotate velocities in b at all?
    Zero against nonzero b is structure; the value within the rotating
    branch is a runtime parameter."""
    return any(float(c) != 0.0 for c in cfg.b_field)
