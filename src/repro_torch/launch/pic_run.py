"""PIC launcher: run the paper's scenario on the card, single- or
multi-domain.

    PYTHONPATH=src python -m repro_torch.launch.pic_run --steps 100 \
        [--nc 4096] [--particles 131072] \
        [--domains 4] [--async-n 2] [--rebalance-every K] \
        [--rebalance-skew T] [--cell-order] [--max-births N] \
        [--strategy unified|explicit|async_batched|fused] \
        [--scenario bench|wall] [--field-solve] [--see-yield Y] \
        [--collisions elastic,cx,coulomb] \
        [--diag-every K] [--phases] [--device cuda|cpu] \
        [--profile-dir DIR] [--metrics-jsonl FILE] [--autotune] \
        [--ckpt-dir DIR --ckpt-every K] [--resume] [--fail-at-step N] \
        [--ensemble W]

The scenario is ``configs/pic_bit1.make_bench_config(nc, particles)``
(buffers hold twice the initial particles); --see-yield Y switches the walls
to absorbing and re-emits secondary electrons with yield Y. --scenario wall
is ``make_wall_config(nc, particles)`` instead: the field on at eps0 100
between grounded absorbing walls, SEE at yield 0.5 (or --see-yield Y),
ionization off, the ions loaded at the electrons' positions
(``wall_state``); it runs the single-domain cycle (the published scale:
--nc 102400 --particles 10485760 --strategy fused). --collisions
adds the binary-collision menu (the deflection through ``ta_kick_ref``, as
the reference launcher leaves ``collide_kernel`` off). It runs on the CUDA
device unless --device cpu is given, and stops with an error when no card
is present. Prints the collision totals (with --collisions), the time per
step and the final populations, in the reference launcher's form.

--domains D > 1, --async-n n > 1, a rebalance trigger or --cell-order run
the multi-domain engine (``repro_torch.distributed``) in one process: D
domains, each with n queues on their own CUDA streams; it prints the MC
sources of the last step and the per-queue balance. --domains 1
--async-n 1 keeps the single-domain cycle.

Observability (``repro_torch.obs``): --profile-dir DIR captures a
``torch.profiler`` trace of the run into DIR (a Chrome trace, for Perfetto;
the cycle's and the engine's phase ranges appear in it, and as NVTX ranges
under Nsight Systems) and the span recorder's spans beside it
(``DIR/spans.jsonl``, one ``obs.tracing.spans()`` record a line); --phases
prints each span name's host self ms and device ms a step over the run's
steps, from the same recorder; --metrics-jsonl FILE streams one structured
metrics record per engine step; --autotune lets the online controller
retune the engine knobs (async_n, migration/birth budgets, rebalance
triggers) from the measured stream between steps. The last two force the engine path even at
--domains 1.

Resilience (``repro_torch.runtime.resilience``): --ckpt-dir DIR checkpoints
the full engine state asynchronously every --ckpt-every steps; --resume
restarts from the newest complete checkpoint (bitwise when --domains
matches the save, elastic re-split otherwise); --fail-at-step N injects a
simulated failure at step N — the restart drill is to re-run the same
command with --resume. These flags force the engine path and exclude
--autotune.

Simulation-as-a-service (``repro_torch.serve``): --ensemble W serves a
sweep of 2W sessions, a dt x ionization-rate grid, through a width-W
``SimService`` (slots reused as sessions finish), prints one line a
session and the server's stats, and fails if a kernel was built after the
first step. It runs one domain and excludes the engine, checkpoint and
auto-tuner flags.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time


# the cycle's diagnostics that count particles absorbed at, and emitted
# from, the walls
WALL_KEYS = ("/absorbed_left", "/absorbed_right", "/emitted",
             "/emission_dropped")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--nc", type=int, default=4096)
    ap.add_argument("--particles", type=int, default=131_072)
    ap.add_argument("--domains", type=int, default=1)
    ap.add_argument("--async-n", type=int, default=1,
                    help="migration/compute queues per domain (paper's "
                         "async(n))")
    ap.add_argument("--rebalance-every", type=int, default=0,
                    help="compact + re-split the async queues every K steps "
                         "(0 = never); bounds per-queue occupancy skew")
    ap.add_argument("--rebalance-skew", type=int, default=0,
                    help="also compact + re-split whenever the per-queue "
                         "occupancy skew exceeds this threshold (0 = off)")
    ap.add_argument("--max-births", type=int, default=8192,
                    help="ionization birth budget per domain per step "
                         "(clamped births retry; see birth_overflow)")
    ap.add_argument("--cell-order", action="store_true",
                    help="rebalance by counting sort by cell (BIT1-style "
                         "per-cell ordering) instead of plain compaction")
    ap.add_argument("--strategy", default="unified",
                    choices=["unified", "explicit", "async_batched",
                             "fused"])
    ap.add_argument("--scenario", default="bench",
                    choices=["bench", "wall"],
                    help="'bench': the §3.3 ionization test; 'wall': the "
                         "§3.3 plasma between grounded absorbing walls, "
                         "field on, with secondary electron emission")
    ap.add_argument("--field-solve", action="store_true",
                    help="enable the field phase (the paper's benchmark "
                         "scenario disables it)")
    ap.add_argument("--see-yield", type=float, default=0.0,
                    help="enable absorbing walls + secondary electron "
                         "emission with this yield (0 = off)")
    ap.add_argument("--collisions", default="",
                    help="comma list from {elastic, cx, coulomb}: enable "
                         "the per-cell binary-collision menu")
    ap.add_argument("--diag-every", type=int, default=1,
                    help="compute full diagnostics every K-th step")
    ap.add_argument("--phases", action="store_true",
                    help="print each span's host self and device ms a "
                         "step over the run's steps")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' runs the kernels; 'cpu' their plain "
                         "PyTorch versions")
    ap.add_argument("--profile-dir", default="",
                    help="capture a torch.profiler trace of the run into "
                         "this directory (a Chrome trace for Perfetto)")
    ap.add_argument("--metrics-jsonl", default="",
                    help="stream per-step engine metrics records to this "
                         "JSONL file (engine path)")
    ap.add_argument("--autotune", action="store_true",
                    help="retune the engine knobs online from the metrics "
                         "stream (engine path)")
    ap.add_argument("--ensemble", type=int, default=0, metavar="W",
                    help="serve a width-W parameter sweep through the "
                         "ensemble engine instead of one run "
                         "(simulation-as-a-service demo; one domain)")
    ap.add_argument("--ckpt-dir", default="",
                    help="checkpoint the engine state into this directory "
                         "(async write; engine path)")
    ap.add_argument("--ckpt-every", type=int, default=5,
                    help="checkpoint cadence in steps (with --ckpt-dir)")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the newest complete checkpoint in "
                         "--ckpt-dir (elastic: --domains may differ from "
                         "the save)")
    ap.add_argument("--fail-at-step", type=int, default=-1,
                    help="inject a simulated failure at this step (restart "
                         "drill; restart the command with --resume)")
    args = ap.parse_args(argv)
    resilient = bool(args.ckpt_dir) or args.fail_at_step >= 0
    want_stream = bool(args.metrics_jsonl or args.autotune)
    engine_path = (args.domains != 1 or args.async_n != 1
                   or args.rebalance_every != 0 or args.rebalance_skew != 0
                   or args.cell_order or want_stream or resilient)
    if args.resume and not args.ckpt_dir:
        ap.error("--resume requires --ckpt-dir")
    if args.autotune and resilient:
        ap.error("--autotune cannot be combined with the checkpoint flags "
                 "(the knob retunes would change the state's layout "
                 "mid-run)")
    if args.scenario == "wall" and (engine_path or args.ensemble):
        ap.error("--scenario wall runs the single-domain cycle; it excludes "
                 "the engine, checkpoint, auto-tuner and ensemble flags")
    if args.ensemble and (args.domains > 1 or args.async_n > 1 or resilient
                          or args.autotune):
        ap.error("--ensemble is the single-device serving demo; it excludes "
                 "--domains/--async-n > 1, the checkpoint flags and "
                 "--autotune")

    import torch

    from repro_torch.configs.pic_bit1 import (make_bench_config,
                                              make_collision_menu,
                                              make_engine_config,
                                              make_see_config,
                                              make_wall_config, wall_state)
    from repro_torch.core import pic
    from repro_torch.distributed import engine
    from repro_torch.obs import MetricsStream, tracing
    from repro_torch.obs.metrics import host_values

    if args.scenario == "wall":
        cfg = make_wall_config(nc=args.nc, n=args.particles,
                               strategy=args.strategy,
                               emission_yield=args.see_yield or 0.5,
                               diag_every=args.diag_every)
    elif args.see_yield > 0.0:
        cfg = make_see_config(nc=args.nc, n=args.particles,
                              strategy=args.strategy,
                              emission_yield=args.see_yield,
                              diag_every=args.diag_every)
    else:
        cfg = make_bench_config(nc=args.nc, n=args.particles,
                                strategy=args.strategy,
                                diag_every=args.diag_every)
    if args.field_solve:
        cfg = dataclasses.replace(cfg, field_solve=True)
    if args.collisions:
        menu = tuple(m for m in args.collisions.split(",") if m)
        cfg = dataclasses.replace(cfg,
                                  collisions=make_collision_menu(menu))

    dev = pic.resolve_device(args.device)
    if args.ensemble:
        _serve_ensemble(cfg, args, dev)
        return
    profile_dir = args.profile_dir or None
    t0 = time.perf_counter()
    balance = {}
    walls = {}
    if not engine_path:
        state = (wall_state(cfg, 0, device=dev) if args.scenario == "wall"
                 else pic.init_state(cfg, 0, device=dev))
        with _observed(args):
            final, diags = pic.run(cfg, args.steps, state=state)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        # count from the final state: with --diag-every K the diagnostics
        # hold zeros on off-steps
        counts = {f"{sc.name}/count": int(buf.count())
                  for sc, buf in zip(cfg.species, final.species)}
        colls = {k: int(v.sum()) for k, v in diags.items()
                 if k.startswith("coll_")}
        if colls:
            print("collisions (total):", colls)
        walls = {k: int(v.sum()) for k, v in diags.items()
                 if k.endswith(WALL_KEYS)}
    else:
        ecfg = make_engine_config(cfg, domains=args.domains,
                                  max_migration=8192, async_n=args.async_n,
                                  max_births=args.max_births,
                                  rebalance_every=args.rebalance_every,
                                  rebalance_skew=args.rebalance_skew,
                                  cell_order=args.cell_order,
                                  metrics=want_stream)
        state = engine.init_engine_state(ecfg, 0, device=dev)
        stream = None
        if want_stream:
            stream = MetricsStream(
                jsonl_path=args.metrics_jsonl or None,
                config={"domains": args.domains,
                        "async_n": args.async_n,
                        "max_births": args.max_births,
                        "rebalance_every": args.rebalance_every,
                        "rebalance_skew": args.rebalance_skew,
                        "steps": args.steps,
                        "autotune": bool(args.autotune)})
        diag = {}
        if resilient:
            from repro_torch.ckpt.checkpoint import Checkpointer
            from repro_torch.runtime import resilience
            from repro_torch.runtime.fault_tolerance import (
                FailureInjector, SimulatedFailure)
            ckpt = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
            if args.resume:
                step0, state = resilience.resume_engine(ecfg, ckpt,
                                                        device=dev)
                print(f"resumed from checkpoint step {step0} "
                      f"in {args.ckpt_dir}")
            # a resumed run is the restarted process: its failure has
            # happened, so the same command line with --resume runs through
            inj = (FailureInjector(args.fail_at_step, fired=args.resume)
                   if args.fail_at_step >= 0 else None)
            try:
                with _observed(args):
                    state, run_diags = resilience.run_engine(
                        ecfg, state, num_steps=args.steps, ckpt=ckpt,
                        ckpt_every=args.ckpt_every, injector=inj,
                        stream=stream, collect=True)
                if run_diags:
                    diag = run_diags[-1]
            except SimulatedFailure as e:
                if stream is not None:
                    stream.close()
                print(f"simulated failure: {e} — restart the same command "
                      f"with --resume to continue from the newest "
                      f"checkpoint")
                return
        elif args.autotune:
            from repro_torch.obs.autotune import AutoTuner
            tuner = AutoTuner(ecfg, stream=stream)
            with _observed(args):
                for _ in range(args.steps):
                    state, diag = tuner.run_step(state)
            for line in tuner.log:
                print("autotune:", line)
        else:
            step = engine.make_engine_step(ecfg)
            with _observed(args):
                for _ in range(args.steps):
                    ts = time.perf_counter()
                    state, diag = step(state)
                    if stream is not None:
                        diag = host_values(diag)
                        stream.record(
                            diag, wall_us=(time.perf_counter() - ts) * 1e6)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
        if stream is not None:
            print("metrics:", stream.summary())
            stream.close()
        counts = {k: int(v) for k, v in diag.items()
                  if k.endswith("/count")}
        sources = {k: int(v) for k, v in diag.items()
                   if k in ("n_ionized", "birth_overflow")
                   or k.startswith("coll_")
                   or k.endswith(("/emitted", "/emission_overflow"))}
        if sources:
            print("mc sources (last step):", sources)
        balance = {k: v.tolist() for k, v in diag.items()
                   if k.endswith(("/queue_occ", "/queue_skew"))}
    wall = time.perf_counter() - t0
    if profile_dir or args.phases:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        records = tracing.spans()
    if profile_dir:
        with open(os.path.join(profile_dir, "spans.jsonl"), "w") as fh:
            for rec in records:
                fh.write(json.dumps(rec) + "\n")
        print(f"profiler trace written to {profile_dir}")
    print(f"{args.steps} steps, {args.domains} domain(s), "
          f"async_n={args.async_n}, rebalance_every={args.rebalance_every}, "
          f"strategy={args.strategy}: {wall:.2f}s "
          f"({wall / args.steps * 1e3:.1f} ms/step)")
    print("final populations:", counts)
    if balance:
        print("queue balance:", balance)
    if args.phases:
        steps = len({rec["step"] for rec in records})
        print(f"spans (ms/step over {steps} steps): host self, device")
        for name, row in tracing.per_step(records).items():
            dms = ("-" if row["device_ms"] is None
                   else f"{row['device_ms']:.3f}")
            print(f"  {name}: {row['host_self_ms']:.3f}, {dms}")
        if walls and cfg.boundary == "absorb":
            print("wall counters (total):", walls)


@contextlib.contextmanager
def _observed(args):
    """The run's observers: the profiler capture of --profile-dir and,
    with --phases, the span recorder, both over the run's own steps."""
    from repro_torch.obs import tracing

    tracing.reset()
    with tracing.trace_session(args.profile_dir or None), (
            tracing.recording() if args.phases
            else contextlib.nullcontext()):
        yield


def _serve_ensemble(cfg, args, dev) -> None:
    """The --ensemble path: 2W sessions on a dt x ionization-rate grid
    through one width-W SimService, in the reference launcher's lines."""
    from repro_torch.serve import SimService

    w = args.ensemble
    svc = SimService(cfg, width=w, device=dev)
    t0 = time.perf_counter()
    sids = []
    for i in range(2 * w):
        # every session is its own parameter point
        sids.append(svc.submit(
            {"dt": cfg.dt * (1.0 + 0.1 * (i % w)),
             "ionization_rate": cfg.ionization_rate * (1 + i)},
            seed=i, steps=args.steps))
    svc.step(1)
    built = svc.stats()["compiles"]
    svc.run_until_drained()
    wall = time.perf_counter() - t0
    for sid in sids:
        p = svc.poll(sid)
        kes = {k: float(v.sum()) for k, v in sorted(p["diag"].items())
               if k.endswith("/ke")}
        print(f"session {sid}: slot={p['slot']} "
              f"steps={p['steps_done']} ke={kes}")
    st = svc.stats()
    print(f"{len(sids)} sessions x {args.steps} steps, width="
          f"{w}: {wall:.2f}s — stats {st}")
    # the serving contract: nothing builds after the first step
    assert st["compiles"] == built, st


if __name__ == "__main__":
    main()
