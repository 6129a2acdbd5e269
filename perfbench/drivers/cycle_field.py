"""Driver of the single-domain cycle with the field solved every step:
``repro_torch.core.pic.make_step``, called as ``launch/pic_run.py
--scenario field`` calls it on one domain.

The cycle driver (``drivers/cycle.py``) with the configuration's
quasi-neutral load (``load_at``: the ions start at the electrons'
positions, as ``configs/pic_bit1.wall_state`` loads them) applied to the
snapshot's rows before the program makes the carried charge density of
the snapshot. The window's pair accounting, the work a step does and the
check (rows, counts and the carried charge ``rho_err`` against
``reference/pic_ref.py``'s charge of the rows) are the cycle driver's.
"""

from __future__ import annotations

from pathlib import Path

from perfbench.bench import files, program, state

cycle = files.driver("cycle", Path(__file__).resolve().parent.parent)


class Driver(cycle.Driver):
    def setup(self) -> None:
        from repro_torch.core import pic

        self.pic = pic
        self.pcfg = program.pic_config(self.cfg, self.traffic)
        gen = state.generator(self.seed, state.SALT_INIT, self.dev)
        self.s0 = [{k: t[0] for k, t in state.species(
            gen, 1, sc["capacity"], sc["n_init"], self.length, sc["vth"],
            sc["weight"]).items()} for sc in self.specs]
        # each (species, source) pair puts the species' rows at the
        # source's positions
        for s, src in self.cfg["load_at"]:
            self.s0[s]["x"] = self.s0[src]["x"].clone()
        self.gen = state.generator(self.seed, state.SALT_PROGRAM, self.dev)
        self.step_fn = pic.make_step(self.pcfg)
        st0, _ = pic.run(self.pcfg, 0, state=self._fresh(None))
        self.rho0 = st0.rho
        self.restore()
