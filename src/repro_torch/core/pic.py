"""PIC cycle assembly, single domain (the port of ``repro.core.pic``).

One step: [deposit -> smooth -> Poisson -> E] -> push -> binary
collisions -> wall emission -> MC ionization -> diagnostics. The paper's
§3.3 configuration turns the field phase off. When every species shares
one capacity the species are stacked and pushed by one launch of the fused
kernel; ``strategy='fused'`` with the field solve on deposits the
post-push charge in that launch and carries it to the next step's field
solve (``PICState.rho``), with the births of the MC sources deposited into
it as they land.

The port runs eagerly: ``run`` is a Python loop over ``step_fn``. The
state carries a ``torch.Generator`` where the reference carries a key;
``step_fn(draws=...)`` takes the random arrays of its Monte-Carlo phases
instead, in the reference's key order: one entry per collision-menu entry,
then one per wall-emission pair, then one for ionization. Entry points run
on ``cuda`` unless the caller passes ``device='cpu'``; with no card they
raise.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import collisions, diagnostics, fields, mover
from repro_torch.core.boundaries import EmissionParams, wall_emission
from repro_torch.core.grid import (Grid1D, deposit, deposit_stacked,
                                   deposit_windowed)
from repro_torch.core.particles import (SpeciesBuffer, init_uniform,
                                        stack_species, unstack_species)
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class SpeciesConfig:
    name: str
    charge: float          # in units of e
    mass: float            # in units of m_e
    capacity: int
    n_init: int
    vth: float
    drift: float = 0.0
    weight: float = 1.0
    stride: int = 1        # sub-cycling: push every `stride` steps, dt*stride


@dataclasses.dataclass(frozen=True)
class PICConfig:
    nc: int = 1024
    dx: float = 1.0
    dt: float = 0.1
    species: Sequence[SpeciesConfig] = ()
    field_solve: bool = True
    smoothing_passes: int = 1
    strategy: mover.Strategy = "unified"
    gather_mode: str = "take"          # 'take' | 'onehot'
    boundary: mover.Boundary = "periodic"
    b_field: tuple[float, float, float] = (0.0, 0.0, 0.0)
    eps0: float = 1.0
    # ionization triple: indices into `species` (neutral, electron, ion)
    ionization: tuple[int, int, int] | None = None
    ionization_rate: float = 0.0
    ionization_vth_e: float = 1.0
    num_batches: int = 4               # for strategy='async_batched'
    # plasma-wall interaction (boundary='absorb'): (primary, target) pairs;
    # absorbed primaries re-emit secondaries into target
    wall_emission: tuple[tuple[int, int], ...] = ()
    emission_yield: float = 0.0
    emission_vth: float = 1.0
    emission_weight: float = 1.0       # macro-weight of emitted secondaries
    # binary-collision menu, run right after the push; collide_kernel
    # deflects the Coulomb pairs through kernels.ops.ta_kick
    collisions: tuple[collisions.CollisionConfig, ...] = ()
    collide_kernel: bool = False
    # full-buffer diagnostics every k-th step; off-steps report zeros
    diag_every: int = 1

    def __post_init__(self):
        # normalize to tuples so configs stay hashable
        object.__setattr__(self, "species", tuple(self.species))
        object.__setattr__(self, "wall_emission",
                           tuple(tuple(p) for p in self.wall_emission))
        object.__setattr__(self, "collisions", tuple(self.collisions))
        object.__setattr__(self, "b_field", tuple(self.b_field))
        if self.ionization is not None:
            object.__setattr__(self, "ionization", tuple(self.ionization))
        collisions.validate_menu(self.collisions, self.species)
        over = [f"{sc.name} (n_init={sc.n_init} > capacity={sc.capacity})"
                for sc in self.species if sc.n_init > sc.capacity]
        if over:
            raise ValueError(
                "species initial population exceeds buffer capacity: "
                + ", ".join(over))
        if self.strategy not in mover.STRATEGIES:
            raise ValueError(
                f"unknown mover strategy {self.strategy!r}; valid strategies"
                f" are {mover.STRATEGIES}")
        if self.boundary not in mover.BOUNDARIES:
            raise ValueError(
                f"unknown boundary {self.boundary!r}; valid boundaries are "
                f"{mover.BOUNDARIES}")
        if self.diag_every < 1:
            raise ValueError(
                f"diag_every must be >= 1, got {self.diag_every}")
        if self.strategy == "async_batched":
            bad = [sc.name for sc in self.species
                   if sc.capacity % self.num_batches != 0]
            if bad:
                raise ValueError(
                    f"strategy='async_batched' needs num_batches "
                    f"({self.num_batches}) to divide every species capacity;"
                    f" offending species: {bad}")

    @property
    def grid(self) -> Grid1D:
        return Grid1D(nc=self.nc, dx=self.dx)

    @property
    def length(self) -> float:
        return self.nc * self.dx


@dataclasses.dataclass
class PICState:
    species: tuple[SpeciesBuffer, ...]
    gen: torch.Generator
    step: int
    # post-push charge density carried by the fused strategy (None
    # otherwise): deposited in the push of step k, read by the field solve
    # of step k+1
    rho: torch.Tensor | None = None


def _stackable(cfg: PICConfig) -> bool:
    """All species share one capacity -> the (S, cap) fused-kernel path."""
    return len(cfg.species) > 0 and len(
        {sc.capacity for sc in cfg.species}) == 1


def _carries_rho(cfg: PICConfig) -> bool:
    """The fused strategy carries its in-pass deposit to the next field
    solve when every post-push charge change is accounted for: births are
    deposited as they land, an ionized neutral must carry zero charge, and
    no species is sub-cycled."""
    return (cfg.strategy == "fused" and cfg.field_solve
            and (cfg.ionization is None
                 or cfg.species[cfg.ionization[0]].charge == 0.0)
            and all(sc.stride == 1 for sc in cfg.species))


def init_state(cfg: PICConfig, seed: int = 0, device="cuda") -> PICState:
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    bufs = tuple(
        init_uniform(gen, sc.capacity, sc.n_init, cfg.length, sc.vth,
                     sc.drift, sc.weight)
        for sc in cfg.species)
    rho = compute_rho(cfg, bufs) if _carries_rho(cfg) else None
    return PICState(species=bufs, gen=gen, step=0, rho=rho)


def state_from_numpy(cfg: PICConfig, species_arrays, step: int,
                     rho=None, seed: int = 0, device="cuda") -> PICState:
    """A state from numpy arrays, e.g. a reference ``PICState`` exported
    with ``np.asarray``. ``species_arrays`` holds one mapping per species
    with ``x``, ``v``, ``w`` and ``alive``. A JAX key cannot become a
    torch.Generator, so the state gets a fresh generator seeded ``seed``."""
    dev = resolve_device(device)
    if len(species_arrays) != len(cfg.species):
        raise ValueError(f"{len(species_arrays)} species arrays for "
                         f"{len(cfg.species)} configured species")
    bufs = []
    for sc, a in zip(cfg.species, species_arrays):
        buf = SpeciesBuffer(
            x=torch.tensor(np.asarray(a["x"]), dtype=torch.float32,
                           device=dev),
            v=torch.tensor(np.asarray(a["v"]), dtype=torch.float32,
                           device=dev),
            w=torch.tensor(np.asarray(a["w"]), dtype=torch.float32,
                           device=dev),
            alive=torch.tensor(np.asarray(a["alive"]), dtype=torch.bool,
                               device=dev))
        if buf.x.shape != (sc.capacity,) or buf.v.shape != (sc.capacity, 3):
            raise ValueError(f"species {sc.name}: arrays do not match "
                             f"capacity {sc.capacity}")
        bufs.append(buf)
    rho_t = (None if rho is None else
             torch.tensor(np.asarray(rho), dtype=torch.float32, device=dev))
    return PICState(species=tuple(bufs),
                    gen=torch.Generator(device=dev).manual_seed(seed),
                    step=int(step), rho=rho_t)


def compute_rho(cfg: PICConfig,
                species: Sequence[SpeciesBuffer]) -> torch.Tensor:
    """Total charge density: one flattened deposit when the species stack,
    a per-species loop otherwise."""
    grid = cfg.grid
    if _stackable(cfg):
        st = stack_species(species)
        charges = torch.tensor([sc.charge for sc in cfg.species],
                               dtype=st.x.dtype, device=st.x.device)
        return deposit_stacked(grid, st.x, st.w, st.alive, charges)
    rho = torch.zeros(grid.ng, dtype=torch.float32,
                      device=species[0].x.device)
    for sc, buf in zip(cfg.species, species):
        if sc.charge != 0.0:
            rho = rho + deposit(grid, buf, sc.charge)
    return rho


def field_from_rho(cfg: PICConfig, rho: torch.Tensor) -> torch.Tensor:
    """smooth -> Poisson -> E (the field phase after deposition).

    Poisson and E run in float64 and E returns in rho's dtype. phi is a
    double prefix sum, and E a difference of neighbouring phi: in float32
    at the paper's 102,401 nodes that difference keeps few digits, and a
    card and a CPU, which add in different orders, would disagree on E far
    beyond the deposit's rounding. The reference computes both in float32.
    """
    rho = fields.smooth_binomial(rho, cfg.smoothing_passes)
    phi = fields.solve_poisson(rho.double(), cfg.dx, cfg.eps0)
    return fields.efield(phi, cfg.dx).to(rho.dtype)


def compute_field(cfg: PICConfig,
                  species: Sequence[SpeciesBuffer]) -> torch.Tensor:
    """deposit rho -> smooth -> Poisson -> E (the field phase of the cycle)."""
    return field_from_rho(cfg, compute_rho(cfg, species))


def _push_all(state: PICState, cfg: PICConfig, e: torch.Tensor):
    """Push every species exactly once; returns (species list,
    per-species (hit_l, hit_r) masks, diag dict, fused rho | None)."""
    grid = cfg.grid
    diag: dict = {}
    hits = []
    new_rho = None
    carried = _carries_rho(cfg)
    dev = e.device

    if _stackable(cfg) and cfg.strategy in ("unified", "fused"):
        st = stack_species(state.species)
        dtype = st.x.dtype
        qm = torch.tensor([sc.charge / sc.mass for sc in cfg.species],
                          dtype=dtype, device=dev)
        dts = torch.tensor([cfg.dt * sc.stride for sc in cfg.species],
                           dtype=dtype, device=dev)
        charges = (torch.tensor([sc.charge for sc in cfg.species],
                                dtype=dtype, device=dev)
                   if carried else None)
        out, hl, hr, pdiag, new_rho = mover.push_stacked(
            st, e, grid, qm, dts, b=cfg.b_field, boundary=cfg.boundary,
            gather_mode=cfg.gather_mode, charges=charges)
        strides = [sc.stride for sc in cfg.species]
        if any(s > 1 for s in strides):
            # sub-cycling: a species pushes every `stride` steps with
            # dt*stride; frozen species keep their state
            do = torch.tensor([state.step % s == 0 for s in strides],
                              device=dev)

            def freeze(new, old):
                return torch.where(do.reshape((-1,) + (1,) * (new.dim() - 1)),
                                   new, old)

            out = type(out)(*(freeze(getattr(out, f), getattr(st, f))
                              for f in ("x", "v", "w", "alive")))
            hl = hl & do[:, None]
            hr = hr & do[:, None]
            pdiag = {k: torch.where(do, v, torch.zeros_like(v))
                     for k, v in pdiag.items()}
        species = list(unstack_species(out))
        for si, sc in enumerate(cfg.species):
            hits.append((hl[si], hr[si]))
            diag.update({f"{sc.name}/{k}": v[si] for k, v in pdiag.items()})
        return species, hits, diag, new_rho

    # per-species loop: explicit / async_batched, or unequal capacities
    species = []
    for sc, buf in zip(cfg.species, state.species):
        qm = sc.charge / sc.mass
        kw = dict(b=cfg.b_field, boundary=cfg.boundary)
        if cfg.strategy == "async_batched":
            kw["num_batches"] = cfg.num_batches
        if cfg.strategy != "explicit":
            kw["gather_mode"] = cfg.gather_mode
        if cfg.strategy == "fused" and carried and sc.charge != 0.0:
            kw["deposit_charge"] = sc.charge    # neutrals deposit nothing
        res = mover.push(buf, e, grid, qm, cfg.dt * sc.stride,
                         strategy=cfg.strategy, **kw)
        pushed, hl, hr, d = res.buf, res.hit_left, res.hit_right, res.diag
        if res.rho is not None:
            new_rho = res.rho if new_rho is None else new_rho + res.rho
        if sc.stride > 1 and state.step % sc.stride != 0:
            pushed = buf
            d = {k: torch.zeros_like(v) for k, v in d.items()}
            hl = torch.zeros_like(hl)
            hr = torch.zeros_like(hr)
        species.append(pushed)
        hits.append((hl, hr))
        diag.update({f"{sc.name}/{k}": v for k, v in d.items()})
    return species, hits, diag, new_rho


def step_fn(state: PICState, cfg: PICConfig,
            draws: Sequence[dict] | None = None) -> tuple[PICState, dict]:
    """One PIC cycle. ``draws`` (optional) replaces the generator for the
    Monte-Carlo phases: one dict per phase in the reference's key order
    (each collision-menu entry, each wall-emission pair, then ionization),
    each with the arrays that phase would draw (see ``collisions`` and
    ``boundaries``)."""
    grid = cfg.grid
    dev = state.species[0].x.device
    carried = _carries_rho(cfg)
    draws = list(draws) if draws is not None else None

    def next_draws():
        return None if draws is None else draws.pop(0)

    if not cfg.field_solve:
        e = torch.zeros(grid.ng, dtype=torch.float32, device=dev)
    elif carried and state.rho is not None:
        e = field_from_rho(cfg, state.rho)
    else:
        e = compute_field(cfg, state.species)

    species, hits, diag, new_rho = _push_all(state, cfg, e)

    if cfg.collisions:
        # rates from the start-of-step cell densities; pairing and
        # scattering act on the pushed velocities. Collisions change only
        # v, so the carried rho needs no correction.
        dens = {i: collisions.cell_density(grid, state.species[i])
                for i in collisions.density_species(cfg.collisions)}
        bufs = {i: species[i]
                for i in collisions.involved_species(cfg.collisions)}
        menu_draws = (None if draws is None else
                      [next_draws() for _ in cfg.collisions])
        bufs, cdiag = collisions.apply_menu(
            state.gen, bufs, cfg.collisions, dens, grid, cfg.dt,
            cfg.collide_kernel, menu_draws)
        for i, b in bufs.items():
            species[i] = b
        diag.update(cdiag)

    if cfg.wall_emission and cfg.boundary == "absorb":
        eparams = EmissionParams(yield_=cfg.emission_yield,
                                 vth_emit=cfg.emission_vth,
                                 weight=cfg.emission_weight)
        for primary, target in cfg.wall_emission:
            hl, hr = hits[primary]
            species[target], d, erows = wall_emission(
                state.gen, species[primary], hl, hr, species[target],
                eparams, cfg.length, draws=next_draws())
            q_t = cfg.species[target].charge
            if carried and new_rho is not None and q_t != 0.0:
                # birth charge folds into the carried in-pass deposit
                new_rho = new_rho + deposit_windowed(
                    grid, erows.x, q_t * erows.w * erows.ok)
            diag.update({f"{cfg.species[target].name}/{k}": v
                         for k, v in d.items()})

    if cfg.ionization is not None:
        ni, ei, ii = cfg.ionization
        iparams = collisions.IonizationParams(
            rate=cfg.ionization_rate, vth_electron=cfg.ionization_vth_e)
        neu, ele, ion, d, births = collisions.ionize(
            state.gen, species[ni], species[ei], species[ii], grid, iparams,
            cfg.dt, draws=next_draws())
        species[ni], species[ei], species[ii] = neu, ele, ion
        if carried and new_rho is not None:
            # one deposit for both halves of every born pair; the killed
            # neutral carries no charge (see _carries_rho)
            q_e = cfg.species[ei].charge
            q_i = cfg.species[ii].charge
            bw = births.w * births.ok
            new_rho = new_rho + deposit_windowed(
                grid, torch.stack([births.x, births.x]),
                torch.stack([q_e * bw, q_i * bw]))
        diag.update(d)

    species = tuple(species)
    # the full-buffer reductions run only every diag_every-th step
    on = state.step % cfg.diag_every == 0
    zero_i = torch.zeros((), dtype=torch.int32, device=dev)
    zero_f = torch.zeros((), dtype=torch.float32, device=dev)
    for sc, buf in zip(cfg.species, species):
        diag[f"{sc.name}/count"] = buf.count() if on else zero_i
        diag[f"{sc.name}/ke"] = (diagnostics.kinetic_energy(buf, sc.mass)
                                 if on else zero_f)
    if cfg.field_solve:
        diag["field_energy"] = (diagnostics.field_energy(e, grid, cfg.eps0)
                                if on else zero_f)

    out = PICState(species=species, gen=state.gen, step=state.step + 1,
                   rho=new_rho if carried else state.rho)
    return out, diag


def make_step(cfg: PICConfig):
    """``step(state, draws=None) -> (state, diag)`` for a fixed config."""
    def step(state: PICState, draws: Sequence[dict] | None = None):
        return step_fn(state, cfg, draws)

    return step


def run(cfg: PICConfig, steps: int, seed: int = 0,
        state: PICState | None = None,
        device="cuda") -> tuple[PICState, dict]:
    """Run ``steps`` steps; returns the final state and the diagnostics
    stacked over steps. ``device`` applies when no ``state`` is given."""
    if state is None:
        state = init_state(cfg, seed, device)
    if _carries_rho(cfg) and state.rho is None:
        # warm start of a fused run from a non-fused state
        state = dataclasses.replace(
            state, rho=compute_rho(cfg, state.species))
    diags = []
    for _ in range(steps):
        state, d = step_fn(state, cfg)
        diags.append(d)
    stacked = ({k: torch.stack([d[k] for d in diags]) for k in diags[0]}
               if diags else {})
    return state, stacked
