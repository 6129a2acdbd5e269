"""Driver of the multi-domain engine:
``repro_torch.distributed.engine.make_engine_step``, called as
``launch/pic_run.py --domains D --async-n n`` calls it, step after step.

Set-up makes each domain's slots on the card from the seed (per species
the first ``n_init / D`` alive, uniform over the domain's slab, Maxwellian
in v) and hands them to the engine (``attach_engine_state``: rings from
the alive masks, no rows pending, the carried charge, one generator a
domain seeded from the run's seed). That state is the snapshot every
episode starts from; the step donates its input, so each episode starts
from a copy.

The check: step 1 from the snapshot, with draws the benchmark makes,
against the reference from the same rows; each later step from the
program's state before it (its pending rows and the slots they claimed
are the program's choice, which the reference cannot work out, and a
landed row reads its ionization draw at its slot), against the reference
from that state. Step 1 covers the start, step 2 the landing of pending
rows; where step 1 agrees bit for bit, the later steps start from the
reference's own rows.
"""

from __future__ import annotations

import dataclasses

import torch

from perfbench.bench import check, program, state, work
from perfbench.reference import engine_ref, pic_ref

EVENT_KEYS = ("n_ionized", "birth_overflow")


def _clone(obj):
    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).clone() for f in dataclasses.fields(obj)
        if isinstance(getattr(obj, f.name), torch.Tensor)})


class Driver:
    def __init__(self, cfg: dict, traffic: dict, device, seed: int):
        self.cfg, self.traffic, self.dev, self.seed = cfg, traffic, device, seed
        self.specs = cfg["species"]
        self.d = cfg["domains"]
        self.ncl = cfg["nc"] // self.d
        self.length = self.ncl * cfg["dx"]

    # ---- the timed path ----------------------------------------------------
    def setup(self) -> None:
        from repro_torch.core.particles import SpeciesBuffer
        from repro_torch.core.pic import PICState
        from repro_torch.distributed import engine

        self.ecfg = program.engine_config(self.cfg, self.traffic)
        gen = state.generator(self.seed, state.SALT_INIT, self.dev)
        cap_l = self.specs[0]["capacity"] // self.d
        self.s0 = [state.species(gen, self.d, sc["capacity"] // self.d,
                                 sc["n_init"] // self.d, self.length,
                                 sc["vth"], sc["weight"])
                   for sc in self.specs]
        if any(sc["capacity"] // self.d != cap_l for sc in self.specs):
            raise ValueError("the engine driver takes species of one "
                             "capacity (one capacity group)")
        bufs = tuple(SpeciesBuffer(**{k: a[k].clone() for k in
                                      ("x", "v", "w", "alive")})
                     for a in self.s0)
        self.e0 = engine.attach_engine_state(
            self.ecfg, PICState(species=bufs, gen=None, step=0, rho=None),
            seed=state.mix(self.seed, state.SALT_PROGRAM))
        self.gens = self.e0.gens
        self.step_fn = engine.make_engine_step(self.ecfg)
        self.restore()

    def _fresh(self):
        e0 = self.e0
        return dataclasses.replace(
            e0, groups=tuple(_clone(g) for g in e0.groups),
            rings=tuple(_clone(r) for r in e0.rings),
            pending=tuple(_clone(p) for p in e0.pending),
            rho=None if e0.rho is None else e0.rho.clone(),
            gens=self.gens, step=0)

    def restore(self) -> None:
        self.state = None
        self.state = self._fresh()

    def step(self) -> dict:
        self.state, diag = self.step_fn(self.state)
        return diag

    def release(self) -> None:
        self.state = None

    # ---- what the window's own counters must show -------------------------
    def window_checks(self, episodes: list[list[dict]]
                      ) -> tuple[dict, dict, int]:
        """Exact accounting in each episode (resident plus pending rows):
        every ionization makes one electron and one ion and takes one
        neutral, no birth is refused, no arrival dropped, and no leaver
        held back in its old slab past the migration budget."""
        n0 = [(sc["n_init"] // self.d) * self.d for sc in self.specs]
        ni, ei, ii = self.traffic["ionization"]["triple"]
        nums = {"pairs_err": 0, "overflow": 0}
        sums: dict = {}
        bad = 0
        tails = ("merge_dropped", "migration_overflow", "migrated_left",
                 "migrated_right")
        for ep in episodes:
            if not ep:
                continue
            keys = [k for k in ep[0] if k in EVENT_KEYS
                    or k.rsplit("/", 1)[-1] in tails]
            tot = {k: int(torch.stack([d[k] for d in ep]).sum())
                   for k in keys}
            for k, v in tot.items():
                sums[k] = sums.get(k, 0) + v
            before = sum(nums.values())
            cnt = [int(ep[-1][f"{sc['name']}/count"]) for sc in self.specs]
            n = tot["n_ionized"]
            nums["pairs_err"] += (abs(cnt[ei] - n0[ei] - n)
                                  + abs(cnt[ii] - n0[ii] - n)
                                  + abs(n0[ni] - cnt[ni] - n))
            nums["overflow"] += tot["birth_overflow"] + sum(
                v for k, v in tot.items()
                if k.endswith(("/merge_dropped", "/migration_overflow")))
            bad += len(ep) if sum(nums.values()) > before else 0
        return nums, sums, bad

    # ---- the work a step does, for the byte bounds -------------------------
    def work(self, diags: list[dict]) -> dict:
        n = len(diags)

        def mean(pred):
            return sum(float(v) for d in diags for k, v in d.items()
                       if pred(k)) / n

        live = mean(lambda k: k.endswith("/count"))
        migrated = mean(lambda k: k.endswith("/migrated_left")
                        or k.endswith("/migrated_right"))
        births = mean(lambda k: k == "n_ionized")
        ngl = self.ncl + 1
        grid = self.d * ngl * (2 * self.traffic["field_solve"] + 1)
        n_q = self.cfg["async_n"]
        slots = len(self.specs) * (self.specs[0]["capacity"] // self.d) // n_q
        carried = (self.traffic["field_solve"]
                   and self.cfg["strategy"] == "fused")
        return {"step_bytes": work.step_bytes(live, grid, births,
                                              migrated=migrated),
                "fused_launches": self.d * n_q,
                "fused_launch_bytes": work.fused_launch_bytes(slots, ngl,
                                                              carried)}

    # ---- correct ------------------------------------------------------------
    def _draws(self, gen) -> list[dict]:
        n_q = self.cfg["async_n"]
        cap_q = self.specs[0]["capacity"] // self.d // n_q
        return [{"ionize": [state.ionize_draws(gen, cap_q)
                            for _ in range(n_q)]} for _ in range(self.d)]

    def _export(self, st, diag) -> dict:
        """The rows of a state by domain and species, its carried charge
        and the step's counters (copies: the next step donates ``st``)."""
        g, p = st.groups[0], st.pending[0]
        dom = [[pic_ref.Species(g.x[r, s].clone(), g.v[r, s].clone(),
                                g.w[r, s].clone(), g.alive[r, s].clone())
                for s in range(len(self.specs))] for r in range(self.d)]
        pend = [[{"x": p.x[r, s].clone(), "v": p.v[r, s].clone(),
                  "w": p.w[r, s].clone(), "alive": p.alive[r, s].clone(),
                  "dest": p.dest[r, s].clone()}
                 for s in range(len(self.specs))] for r in range(self.d)]
        return {"dom": dom, "pending": pend,
                "rho": None if st.rho is None else st.rho.clone(),
                "counts": [int(diag[f"{sc['name']}/count"])
                           for sc in self.specs],
                "n_ionized": int(diag["n_ionized"])}

    def _s0_domains(self, dtype):
        return [[pic_ref.Species(a["x"][r], a["v"][r], a["w"][r],
                                 a["alive"][r]).to(dtype) for a in self.s0]
                for r in range(self.d)]

    def check(self, control: bool = False) -> dict:
        """The check's numbers over ``check_steps`` steps: the first from
        the snapshot, each later one from the program's state before it
        (see the module's docstring). With ``control`` the reference in
        bfloat16 stands in for the program."""
        gen = state.generator(self.seed, state.SALT_CHECK, self.dev)
        draws = [self._draws(gen)
                 for _ in range(self.traffic["check_steps"])]
        st = self._fresh()
        outs = []
        for dr in draws:
            st, diag = self.step_fn(st, draws=dr)
            outs.append(self._export(st, diag))
        st = None
        nums: dict = {}
        for k, (out, dr) in enumerate(zip(outs, draws)):
            def ref_from(dtype):
                if k == 0:
                    return engine_ref.step(self._s0_domains(dtype), None,
                                           self.cfg, self.traffic, dr)
                prev = outs[k - 1]
                dom = [[sp.to(dtype) for sp in row] for row in prev["dom"]]
                return engine_ref.step(dom, prev["pending"], self.cfg,
                                       self.traffic, dr)
            ref = ref_from(torch.float32)
            cand = self._as_output(ref_from(torch.bfloat16)) if control \
                else out
            check.merge(nums, self._compare(cand, ref))
        return nums

    @staticmethod
    def _as_output(ref: dict) -> dict:
        pend = [[dict(p, alive=torch.ones(p["x"].numel(), dtype=torch.bool,
                                          device=p["x"].device))
                 for p in row] for row in ref["pending"]]
        return {"dom": ref["dom"], "pending": pend, "rho": ref["rho"],
                "counts": ref["counts"], "n_ionized": ref["n_ionized"]}

    def _compare(self, c: dict, r: dict) -> dict:
        nums: dict = {"landing_err": r["landing_err"]}
        for rr in range(self.d):
            for s, sc in enumerate(self.specs):
                p, q = c["dom"][rr][s], r["dom"][rr][s]
                res = check.slots(
                    {"x": p.x, "v": p.v, "alive": p.alive},
                    {"x": q.x, "v": q.v, "alive": q.alive},
                    torch.ones_like(q.alive), sc["vth"], None)
                check.merge(nums, res)
                pp, qq = c["pending"][rr][s], r["pending"][rr][s]
                live = pp["alive"]
                check.merge(nums, check.multiset(
                    {"x": pp["x"][live], "v": pp["v"][live]}, qq,
                    sc["vth"], None))
        nums["count_err"] = sum(abs(a - b) for a, b in
                                zip(c["counts"], r["counts"]))
        nums["ionized_err"] = abs(c["n_ionized"] - r["n_ionized"])
        if r["rho"] is not None:
            nums["rho_err"] = check.rel_gap(c["rho"], r["rho"])
        return nums
