"""Simulation-as-a-service: the ensemble engine and the session layer
(the port of ``repro.serve``).

``ensemble`` steps W independent parameter points of one configuration a
call, each in its own slot; ``service`` puts a submit/step/poll session API
with slot reuse on top (init/insert/step over a fixed batch of simulation
slots, as an inference server runs prefill/insert/generate over its decode
slots).
"""

from repro_torch.serve.ensemble import (EnsembleState, init_ensemble,
                                        make_ensemble_step, make_member_init,
                                        make_member_insert,
                                        make_member_release, member_view)
from repro_torch.serve.service import SimService, enable_compilation_cache

__all__ = [
    "EnsembleState", "init_ensemble", "make_ensemble_step",
    "make_member_init", "make_member_insert", "make_member_release",
    "member_view", "SimService", "enable_compilation_cache",
]
