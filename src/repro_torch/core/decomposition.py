"""Back-compat shim over ``repro_torch.distributed`` (the port of
``repro.core.decomposition``): the seed's ``DomainConfig`` /
``make_distributed_step`` / ``init_distributed_state`` API, delegating to
the engine with async_n = 1. Where the reference takes a mesh, the port
takes the domain count in ``DomainConfig.domains``.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.pic import PICConfig
from repro_torch.distributed import engine as _engine


@dataclasses.dataclass(frozen=True)
class DomainConfig:
    """Decomposition of a global PICConfig into ``domains`` slabs."""
    pic: PICConfig                       # pic.nc == GLOBAL cell count
    domains: int = 1
    max_migration: int = 2048            # per species/direction/step
    species_capacity_local: int | None = None  # default: global cap / D

    def to_engine(self, async_n: int = 1) -> _engine.EngineConfig:
        return _engine.EngineConfig(
            pic=self.pic, domains=self.domains, async_n=async_n,
            max_migration=self.max_migration,
            species_capacity_local=self.species_capacity_local)

    def num_domains(self) -> int:
        return self.domains

    def local_nc(self) -> int:
        return self.to_engine().local_nc()

    def local_cap(self, sc) -> int:
        return self.to_engine().local_cap(sc)


def make_distributed_step(dcfg: DomainConfig):
    """The engine step for ``dcfg`` (async_n = 1)."""
    return _engine.make_engine_step(dcfg.to_engine())


def init_distributed_state(dcfg: DomainConfig, seed: int = 0,
                           device="cuda") -> _engine.EngineState:
    """Per-domain init of the engine state."""
    return _engine.init_engine_state(dcfg.to_engine(), seed, device)
