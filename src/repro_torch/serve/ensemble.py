"""Ensemble engine: one call steps W independent parameter points of one
configuration (the port of ``repro.serve.ensemble``).

Every member shares the configuration (shapes, capacities, strategy, menu
structure) and differs only in its ``RuntimeParams`` (dt, rates, yield, b)
and its seed. Members live in fixed slots, which the serving layer reuses
as sessions finish (``service.py``):

* ``init_ensemble``      — W parked slots holding zero states
* ``make_member_init``   — seed -> fresh member state
* ``make_member_insert`` — put a member and its params into slot s
* ``make_member_release``— park slot s
* ``make_ensemble_step`` — advance every active member one cycle; parked
                           slots launch nothing, keep their tensors as they
                           were and report zero diagnostics

The reference vmaps ``pic.step_fn`` over a stacked member axis and jit
compiles it once. The port runs eagerly, and its kernels have no batching
rule, so the step loops over the active slots on the host: each member
runs ``pic.step_fn`` with its own params and its own ``torch.Generator``
on the current stream. A slot holds its own ``PICState``, which each step
replaces by the step's outputs: no member is copied into or out of a
stacked layout. A member stepped in the ensemble is therefore the same
computation as the member stepped alone: bitwise on the CPU, and on the
card wherever no float atomics run (the reference's contract is exact
events with close floats). ``active`` is a host tensor: the loop reads it
without a device sync.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import torch

from repro_torch.core import pic
from repro_torch.core.params import RuntimeParams
from repro_torch.device import resolve_device


@dataclasses.dataclass
class EnsembleState:
    """W slots: ``pic[s]`` and ``params[s]`` are slot s's state and
    parameter point; ``active`` (W,) bool, on the host, marks the live
    slots."""
    pic: list[pic.PICState]
    params: list[RuntimeParams]
    active: torch.Tensor

    @property
    def width(self) -> int:
        return self.active.shape[0]


def _check_cfg(cfg: pic.PICConfig) -> None:
    if cfg.strategy in ("explicit", "async_batched"):
        raise NotImplementedError(
            f"strategy={cfg.strategy!r} does not support runtime "
            f"parameters (see core/pic.py) — the ensemble engine needs "
            f"'unified' or 'fused'")


def init_ensemble(cfg: pic.PICConfig, width: int,
                  device="cuda") -> EnsembleState:
    """W parked slots holding zero states (no launch, no random draw)."""
    _check_cfg(cfg)
    if width < 1:
        raise ValueError(f"ensemble width must be >= 1, got {width}")
    dev = resolve_device(device)
    rp = RuntimeParams.from_config(cfg, device=dev)
    return EnsembleState(
        pic=[pic.zero_state(cfg, dev) for _ in range(width)],
        params=[rp] * width,
        active=torch.zeros(width, dtype=torch.bool))


def make_member_init(cfg: pic.PICConfig, device="cuda"):
    """``seed -> PICState``: a fresh member on ``device``."""
    _check_cfg(cfg)
    dev = resolve_device(device)

    def init(seed: int) -> pic.PICState:
        return pic.init_state(cfg, int(seed), dev)

    return init


def make_member_insert(cfg: pic.PICConfig):
    """``(es, member, params, slot) -> es``: slot ``slot`` takes the
    member's state (its tensors, not a copy) and params and becomes
    active. Updates ``es`` in place and returns it."""
    _check_cfg(cfg)

    def insert(es: EnsembleState, member: pic.PICState,
               params: RuntimeParams, slot: int) -> EnsembleState:
        slot = int(slot)
        es.pic[slot] = member
        es.params[slot] = params
        es.active[slot] = True
        return es

    return insert


def make_member_release(cfg: pic.PICConfig):
    """``(es, slot) -> es``: park a slot. Its state stays as it is, frozen
    by the step, until the next insert replaces it. Updates ``es`` in
    place and returns it."""
    _check_cfg(cfg)

    def release(es: EnsembleState, slot: int) -> EnsembleState:
        es.active[int(slot)] = False
        return es

    return release


def member_view(es: EnsembleState, slot: int) -> pic.PICState:
    """Slot ``slot``'s state (the slot's own tensors)."""
    return es.pic[int(slot)]


def _clone_gen(gen: torch.Generator) -> torch.Generator:
    out = torch.Generator(device=gen.device)
    out.set_state(gen.get_state())
    return out


def make_ensemble_step(cfg: pic.PICConfig, donate: bool = True):
    """``step(es, draws=None) -> (es, diag)``: every active member one PIC
    cycle with its own params; parked slots launch nothing and keep their
    tensors bit for bit.

    ``diag`` holds ``pic.step_fn``'s keys, each a (W,) tensor with zeros
    in the parked slots; it exists with no slot active too
    (``pic.diag_spec``). ``draws`` (optional) maps a slot to that member's
    ``step_fn`` draws (a mapping, or a sequence of W entries).
    With ``donate`` (the default) the step updates ``es`` in place, slot by
    slot, so a member's old state is freed before the next member runs;
    ``donate=False`` returns a new EnsembleState and leaves ``es``, its
    generators included, as it was.
    """
    _check_cfg(cfg)
    spec = pic.diag_spec(cfg)
    zeros: dict = {}

    def step(es: EnsembleState,
             draws: Mapping[int, Sequence[dict]] | Sequence | None = None):
        w = es.width
        out = es if donate else EnsembleState(
            pic=list(es.pic), params=list(es.params),
            active=es.active.clone())
        per: list = [None] * w
        for slot in range(w):
            if not bool(es.active[slot]):
                continue
            st = es.pic[slot]
            if not donate:
                st = dataclasses.replace(st, gen=_clone_gen(st.gen))
            dr = None
            if draws is not None:
                dr = (draws.get(slot) if isinstance(draws, Mapping)
                      else draws[slot])
            out.pic[slot], per[slot] = pic.step_fn(st, cfg, es.params[slot],
                                                   dr)
        dev = es.pic[0].species[0].x.device
        if dev not in zeros:
            zeros[dev] = {dt: torch.zeros((), dtype=dt, device=dev)
                          for dt in set(spec.values())}
        z = zeros[dev]
        diag = {k: torch.stack([z[dt] if d is None else d[k] for d in per])
                for k, dt in spec.items()}
        return out, diag

    return step
