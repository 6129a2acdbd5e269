"""Driver of the multi-domain engine with the field on:
``repro_torch.distributed.engine.make_engine_step``, called as
``launch/pic_run.py --scenario field --domains D --async-n n`` calls it.

The engine driver (``drivers/engine.py``) with the configuration's
quasi-neutral load (``load_at``: in each domain the ions start at that
domain's electrons' positions, as ``configs/pic_bit1.field_engine_state``
loads them) applied to the slots before the engine takes them, so the
carried charge starts from the loaded rows. The window's pair accounting,
the work a step does and the check (rows, counts and the carried charge
``rho_err`` against ``reference/engine_ref.py``'s global field solve) are
the engine driver's.
"""

from __future__ import annotations

from pathlib import Path

from perfbench.bench import files, program, state

engine = files.driver("engine", Path(__file__).resolve().parent.parent)


class Driver(engine.Driver):
    def setup(self) -> None:
        from repro_torch.core.particles import SpeciesBuffer
        from repro_torch.core.pic import PICState
        from repro_torch.distributed import engine as program_engine

        self.ecfg = program.engine_config(self.cfg, self.traffic)
        gen = state.generator(self.seed, state.SALT_INIT, self.dev)
        self.s0 = [state.species(gen, self.d, sc["capacity"] // self.d,
                                 sc["n_init"] // self.d, self.length,
                                 sc["vth"], sc["weight"])
                   for sc in self.specs]
        # each (species, source) pair puts the species' rows of every
        # domain at the source's positions in that domain
        for s, src in self.cfg["load_at"]:
            self.s0[s]["x"] = self.s0[src]["x"].clone()
        bufs = tuple(SpeciesBuffer(**{k: a[k].clone() for k in
                                      ("x", "v", "w", "alive")})
                     for a in self.s0)
        self.e0 = program_engine.attach_engine_state(
            self.ecfg, PICState(species=bufs, gen=None, step=0, rho=None),
            seed=state.mix(self.seed, state.SALT_PROGRAM))
        self.gens = self.e0.gens
        self.step_fn = program_engine.make_engine_step(self.ecfg)
        self.restore()
