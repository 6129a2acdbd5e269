"""Driver of the single-domain cycle: ``repro_torch.core.pic.make_step``,
called as ``launch/pic_run.py`` calls it, step after step.

Set-up makes each species' slots on the card from the seed (the first
``n_init`` alive, uniform in x, Maxwellian in v) and keeps them as the
snapshot every episode starts from. The window steps with the program's
own generator. The check runs ``check_steps`` steps through the same step
function from the snapshot, with Monte-Carlo draws the benchmark makes,
and holds each step's rows against the plain reference's.
"""

from __future__ import annotations

import torch

from perfbench.bench import check, program, state, work
from perfbench.reference import pic_ref

COUNT_KEYS = ("n_ionized", "birth_overflow", "ionize_dropped",
              "coll_elastic", "coll_cx", "coll_coulomb")


class Driver:
    def __init__(self, cfg: dict, traffic: dict, device, seed: int):
        self.cfg, self.traffic, self.dev, self.seed = cfg, traffic, device, seed
        self.specs = cfg["species"]
        self.length = cfg["nc"] * cfg["dx"]

    # ---- the timed path ----------------------------------------------------
    def setup(self) -> None:
        from repro_torch.core import pic

        self.pic = pic
        self.pcfg = program.pic_config(self.cfg, self.traffic)
        gen = state.generator(self.seed, state.SALT_INIT, self.dev)
        self.s0 = [{k: t[0] for k, t in state.species(
            gen, 1, sc["capacity"], sc["n_init"], self.length, sc["vth"],
            sc["weight"]).items()} for sc in self.specs]
        self.gen = state.generator(self.seed, state.SALT_PROGRAM, self.dev)
        self.step_fn = pic.make_step(self.pcfg)
        # the carried charge density of the snapshot, as the program's
        # run() makes it for a state that has none
        st0, _ = pic.run(self.pcfg, 0, state=self._fresh(None))
        self.rho0 = st0.rho
        self.restore()

    def _fresh(self, rho):
        from repro_torch.core.particles import SpeciesBuffer

        bufs = tuple(SpeciesBuffer(**{k: a[k].clone() for k in
                                      ("x", "v", "w", "alive")})
                     for a in self.s0)
        return self.pic.PICState(species=bufs, gen=self.gen, step=0,
                                 rho=None if rho is None else rho.clone())

    def restore(self) -> None:
        self.state = None
        self.state = self._fresh(self.rho0)

    def step(self) -> dict:
        self.state, diag = self.step_fn(self.state)
        return diag

    def release(self) -> None:
        self.state = None

    # ---- what the window's own counters must show -------------------------
    def window_checks(self, episodes: list[list[dict]]
                      ) -> tuple[dict, dict, int]:
        """Exact accounting in each episode: every ionization makes one
        electron and one ion and takes one neutral, no birth is refused
        or dropped; without ionization the populations hold."""
        n0 = [sc["n_init"] for sc in self.specs]
        nums = {"overflow": 0, "pairs_err": 0} if self._ion() else \
            {"count_drift": 0}
        sums: dict = {}
        bad = 0
        for ep in episodes:
            if not ep:
                continue
            tot = {k: int(torch.stack([d[k] for d in ep]).sum())
                   for k in COUNT_KEYS if k in ep[0]}
            for k, v in tot.items():
                sums[k] = sums.get(k, 0) + v
            before = sum(nums.values())
            cnt = [int(ep[-1][f"{sc['name']}/count"]) for sc in self.specs]
            if self._ion():
                ni, ei, ii = self._ion()["triple"]
                n = tot["n_ionized"]
                nums["pairs_err"] += (abs(cnt[ei] - n0[ei] - n)
                                      + abs(cnt[ii] - n0[ii] - n)
                                      + abs(n0[ni] - cnt[ni] - n))
                nums["overflow"] += tot["birth_overflow"] + \
                    tot["ionize_dropped"]
            else:
                nums["count_drift"] += sum(abs(a - b)
                                           for a, b in zip(cnt, n0))
            bad += len(ep) if sum(nums.values()) > before else 0
        return nums, sums, bad

    def _ion(self):
        return self.traffic.get("ionization")

    # ---- the work a step does, for the byte bounds -------------------------
    def work(self, diags: list[dict]) -> dict:
        n = len(diags)

        def mean(key):
            return sum(float(d[key]) for d in diags) / n if key in diags[0] \
                else 0.0

        live = sum(mean(f"{sc['name']}/count") for sc in self.specs)
        ng = self.cfg["nc"] + 1
        grid = 0
        if self.traffic["field_solve"]:
            grid += 2 * ng                      # rho, E
        if self._ion():
            grid += ng                          # the electron density
        dens = {e["partner"] if e["kind"] != "coulomb" else e["species"]
                for e in self.traffic.get("collisions", [])}
        grid += len(dens) * self.cfg["nc"]
        collided = (mean("coll_elastic") + 2 * mean("coll_cx")
                    + 2 * mean("coll_coulomb"))
        slots = len(self.specs) * self.specs[0]["capacity"]
        carried = (self.traffic["field_solve"]
                   and self.cfg["strategy"] == "fused")
        return {"step_bytes": work.step_bytes(live, grid, mean("n_ionized"),
                                              collided),
                "fused_launches": 1,
                "fused_launch_bytes": work.fused_launch_bytes(slots, ng,
                                                              carried)}

    # ---- correct ------------------------------------------------------------
    def _draws(self, gen) -> list[dict]:
        caps = [sc["capacity"] for sc in self.specs]
        out = [state.menu_draws(gen, e, caps)
               for e in self.traffic.get("collisions", [])]
        if self._ion():
            out.append(state.ionize_draws(gen, caps[self._ion()["triple"][0]]))
        return out

    def _program_steps(self, draws) -> list[dict]:
        st = self._fresh(self.rho0)
        outs = []
        for d in draws:
            st, diag = self.step_fn(st, draws=d)
            outs.append({
                "species": [{"x": b.x, "v": b.v, "alive": b.alive}
                            for b in st.species],
                "rho": st.rho,
                "counts": [int(diag[f"{sc['name']}/count"])
                           for sc in self.specs],
                "events": {k: int(diag[k]) for k in COUNT_KEYS if k in diag}})
        return outs

    def _reference_steps(self, draws, dtype) -> list[dict]:
        sps = [pic_ref.Species(a["x"], a["v"], a["w"], a["alive"]).to(dtype)
               for a in self.s0]
        outs = []
        for d in draws:
            sps, info = pic_ref.cycle_step(sps, self.cfg, self.traffic, d)
            outs.append({
                "species": [{"x": s.x, "v": s.v, "alive": s.alive}
                            for s in sps],
                "rho": info.get("rho"),
                "counts": [int(s.alive.sum()) for s in sps],
                "events": {k: v for k, v in info.items() if k != "rho"}})
        return outs

    def check(self, control: bool = False) -> dict:
        """The check's numbers: the program's ``check_steps`` steps (with
        ``control``, the reference in bfloat16 in their place) against the
        reference's, from the snapshot, with the same draws."""
        gen = state.generator(self.seed, state.SALT_CHECK, self.dev)
        draws = [self._draws(gen) for _ in range(self.traffic["check_steps"])]
        cand = (self._reference_steps(draws, torch.bfloat16) if control
                else self._program_steps(draws))
        ref = self._reference_steps(draws, torch.float32)
        nums: dict = {}
        base = [a["alive"] for a in self.s0]
        for c, r in zip(cand, ref):
            check.merge(nums, self._compare(c, r, base))
        return nums

    def _compare(self, c: dict, r: dict, base) -> dict:
        nums: dict = {}
        for s, sc in enumerate(self.specs):
            p, q = c["species"][s], r["species"][s]
            check.merge(nums, check.slots(p, q, base[s], sc["vth"],
                                          self.length))
            born_p, born_q = p["alive"] & ~base[s], q["alive"] & ~base[s]
            check.merge(nums, check.multiset(
                {"x": p["x"][born_p], "v": p["v"][born_p]},
                {"x": q["x"][born_q], "v": q["v"][born_q]},
                sc["vth"], self.length))
        nums["count_err"] = sum(abs(a - b) for a, b in
                                zip(c["counts"], r["counts"]))
        if self._ion():
            nums["ionized_err"] = abs(c["events"]["n_ionized"]
                                      - r["events"]["n_ionized"])
        if self.traffic.get("collisions"):
            nums["coll_err"] = sum(abs(c["events"].get(k, 0)
                                       - r["events"].get(k, 0))
                                   for k in pic_ref.KIND_DIAG.values())
        if self.traffic["field_solve"]:
            nums["rho_err"] = check.rel_gap(c["rho"], r["rho"])
        return nums
