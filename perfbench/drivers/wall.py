"""Driver of the §3.3 plasma between grounded absorbing walls:
``repro_torch.core.pic.make_step`` with the field on and secondary electron
emission (SEE), called as ``launch/pic_run.py --scenario wall`` calls it.

Set-up, restore and step are the cycle driver's (``drivers/cycle.py``),
with the configuration's SEE keys on the program's configuration, and the
configuration's quasi-neutral load (``load_at``: the ions start at the
electrons' positions, as ``configs/pic_bit1.wall_state`` loads them). The
window's own counters are held to exact wall accounting: in each episode
each species' count moves by what was emitted into it less what the walls
absorbed from it, and no secondary is dropped. The check runs
``check_steps`` steps through the same step function from the snapshot,
with the SEE draws the benchmark makes, and holds each step's rows, counts
and carried charge density against ``reference/wall_ref.py``'s.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import torch

from perfbench.bench import check, files, program, state, work
from perfbench.reference import pic_ref, wall_ref

cycle = files.driver("cycle", Path(__file__).resolve().parent.parent)

# the bytes of one secondary written into its dead slot: x, v, w, alive
SECONDARY = 21


class Driver(cycle.Driver):
    # ---- the timed path ----------------------------------------------------
    def setup(self) -> None:
        from repro_torch.core import pic

        self.pic = pic
        self.pairs = [tuple(p) for p in self.cfg["wall_emission"]]
        self.pcfg = dataclasses.replace(
            program.pic_config(self.cfg, self.traffic),
            wall_emission=tuple(self.pairs),
            emission_yield=float(self.cfg["emission_yield"]),
            emission_vth=float(self.cfg["emission_vth"]),
            emission_weight=float(self.cfg["emission_weight"]))
        gen = state.generator(self.seed, state.SALT_INIT, self.dev)
        self.s0 = [{k: t[0] for k, t in state.species(
            gen, 1, sc["capacity"], sc["n_init"], self.length, sc["vth"],
            sc["weight"]).items()} for sc in self.specs]
        # the configuration's quasi-neutral load: each (species, source)
        # pair puts the species' rows at the source's positions
        for s, src in self.cfg["load_at"]:
            self.s0[s]["x"] = self.s0[src]["x"].clone()
        self.gen = state.generator(self.seed, state.SALT_PROGRAM, self.dev)
        self.step_fn = pic.make_step(self.pcfg)
        st0, _ = pic.run(self.pcfg, 0, state=self._fresh(None))
        self.rho0 = st0.rho
        self.restore()

    def _targets(self) -> list[str]:
        return sorted({self.specs[t]["name"] for _, t in self.pairs})

    def _wall_keys(self) -> list[str]:
        return ([f"{sc['name']}/absorbed_{side}" for sc in self.specs
                 for side in ("left", "right")]
                + [f"{name}/{k}" for name in self._targets()
                   for k in ("emitted", "emission_dropped")])

    # ---- what the window's own counters must show -------------------------
    def window_checks(self, episodes: list[list[dict]]
                      ) -> tuple[dict, dict, int]:
        """Exact wall accounting in each episode: ``wall_err`` sums over
        the species |count change - (emitted into it - absorbed from it)|,
        ``overflow`` the secondaries dropped for want of a slot."""
        keys = self._wall_keys()
        nums = {"wall_err": 0, "overflow": 0}
        sums: dict = {}
        bad = 0
        for ep in episodes:
            if not ep:
                continue
            tot = {k: int(torch.stack([d[k] for d in ep]).sum())
                   for k in keys}
            for k, v in tot.items():
                sums[k] = sums.get(k, 0) + v
            before = sum(nums.values())
            for sc in self.specs:
                name = sc["name"]
                moved = int(ep[-1][f"{name}/count"]) - sc["n_init"]
                net = (tot.get(f"{name}/emitted", 0)
                       - tot[f"{name}/absorbed_left"]
                       - tot[f"{name}/absorbed_right"])
                nums["wall_err"] += abs(moved - net)
            nums["overflow"] += sum(tot[f"{name}/emission_dropped"]
                                    for name in self._targets())
            bad += len(ep) if sum(nums.values()) > before else 0
        return nums, sums, bad

    # ---- the work a step does, for the byte bounds -------------------------
    def work(self, diags: list[dict]) -> dict:
        n = len(diags)

        def mean(key):
            return sum(float(d[key]) for d in diags) / n

        live = sum(mean(f"{sc['name']}/count") for sc in self.specs)
        emitted = sum(mean(f"{name}/emitted") for name in self._targets())
        ng = self.cfg["nc"] + 1
        slots = len(self.specs) * self.specs[0]["capacity"]
        # rho and E of the field phase
        step = work.step_bytes(live, 2 * ng) + SECONDARY * emitted
        return {"step_bytes": step,
                "fused_launch_bytes": work.fused_launch_bytes(slots, ng,
                                                              True),
                "deposit_rows": emitted, "deposit_nodes": ng}

    # ---- correct ------------------------------------------------------------
    def _draws(self, gen) -> list[dict]:
        return [{"uniform": state.uniform(gen, self.specs[p]["capacity"]),
                 "normal": torch.randn(self.specs[p]["capacity"], 3,
                                       generator=gen, device=gen.device)}
                for p, _ in self.pairs]

    def _program_steps(self, draws) -> list[dict]:
        st = self._fresh(self.rho0)
        keys = self._wall_keys()
        outs = []
        for d in draws:
            st, diag = self.step_fn(st, draws=d)
            outs.append({
                "species": [{"x": b.x, "v": b.v, "alive": b.alive}
                            for b in st.species],
                "rho": st.rho,
                "counts": [int(diag[f"{sc['name']}/count"])
                           for sc in self.specs],
                "events": {k: int(diag[k]) for k in keys}})
        return outs

    def _reference_steps(self, draws, dtype) -> list[dict]:
        sps = [pic_ref.Species(a["x"], a["v"], a["w"], a["alive"]).to(dtype)
               for a in self.s0]
        rho = pic_ref.charge_density(sps, self.specs, self.cfg["nc"],
                                     self.cfg["dx"], pic_ref.acc_dtype(dtype))
        outs = []
        for d in draws:
            sps, rho, info = wall_ref.wall_step(sps, rho, self.cfg, d)
            outs.append({
                "species": [{"x": s.x, "v": s.v, "alive": s.alive}
                            for s in sps],
                "rho": rho,
                "counts": [int(s.alive.sum()) for s in sps],
                "events": info})
        return outs

    def check(self, control: bool = False) -> dict:
        """The check's numbers: the program's ``check_steps`` steps (with
        ``control``, the reference in bfloat16 in their place) against the
        reference's, from the snapshot, with the same draws. Row and count
        gaps add up over the steps; position, velocity and charge gaps
        are the largest step's."""
        gen = state.generator(self.seed, state.SALT_CHECK, self.dev)
        draws = [self._draws(gen) for _ in range(self.traffic["check_steps"])]
        cand = (self._reference_steps(draws, torch.bfloat16) if control
                else self._program_steps(draws))
        ref = self._reference_steps(draws, torch.float32)
        nums: dict = {"absorbed_err": 0, "emitted_err": 0}
        base = [a["alive"] for a in self.s0]
        for c, r in zip(cand, ref):
            step = self._compare(c, r, base)
            for k in ("absorbed_err", "emitted_err"):
                nums[k] += step.pop(k)
            check.merge(nums, step)
        return nums

    def _compare(self, c: dict, r: dict, base) -> dict:
        nums: dict = {}
        for s, sc in enumerate(self.specs):
            p, q = c["species"][s], r["species"][s]
            check.merge(nums, check.slots(p, q, base[s], sc["vth"], None))
            born_p, born_q = p["alive"] & ~base[s], q["alive"] & ~base[s]
            check.merge(nums, check.multiset(
                {"x": p["x"][born_p], "v": p["v"][born_p]},
                {"x": q["x"][born_q], "v": q["v"][born_q]},
                sc["vth"], None))
        nums["count_err"] = sum(abs(a - b) for a, b in
                                zip(c["counts"], r["counts"]))
        ev_p, ev_r = c["events"], r["events"]
        nums["absorbed_err"] = sum(abs(ev_p[k] - ev_r[k]) for k in ev_r
                                   if "/absorbed_" in k)
        nums["emitted_err"] = sum(abs(ev_p[k] - ev_r[k]) for k in ev_r
                                  if k.endswith("/emitted"))
        nums["rho_err"] = check.rel_gap(c["rho"], r["rho"])
        return nums
