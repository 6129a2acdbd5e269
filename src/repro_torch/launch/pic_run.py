"""PIC launcher: run the paper's scenario on the card, single- or
multi-domain.

    PYTHONPATH=src python -m repro_torch.launch.pic_run --steps 100 \
        [--nc 4096] [--particles 131072] \
        [--domains 4] [--async-n 2] [--rebalance-every K] \
        [--rebalance-skew T] [--cell-order] [--max-births N] \
        [--strategy unified|explicit|async_batched|fused] \
        [--field-solve] [--see-yield Y] [--collisions elastic,cx,coulomb] \
        [--diag-every K] [--phases] [--device cuda|cpu]

The scenario is ``configs/pic_bit1.make_bench_config(nc, particles)``
(buffers hold twice the initial particles); --see-yield Y switches the walls
to absorbing and re-emits secondary electrons with yield Y; --collisions
adds the binary-collision menu (the deflection through ``ta_kick_ref``, as
the reference launcher leaves ``collide_kernel`` off). It runs on the CUDA
device unless --device cpu is given, and stops with an error when no card
is present. Prints the collision totals (with --collisions), the time per
step and the final populations, in the reference launcher's form.

--domains D > 1, --async-n n > 1, a rebalance trigger or --cell-order run
the multi-domain engine (``repro_torch.distributed``) in one process: D
domains, each with n queues on their own CUDA streams; it prints the MC
sources of the last step, the per-queue balance and, with --phases, the
per-phase breakdown of the engine's probes. --domains 1 --async-n 1 keeps
the single-domain cycle.
"""

from __future__ import annotations

import argparse
import dataclasses
import time


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
                    help="print the per-phase timing breakdown "
                         "(multi-domain)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' runs the kernels; 'cpu' their plain "
                         "PyTorch versions")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs.pic_bit1 import (make_bench_config,
                                              make_collision_menu,
                                              make_engine_config,
                                              make_see_config)
    from repro_torch.core import pic
    from repro_torch.distributed import engine, perf

    if args.see_yield > 0.0:
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
    t0 = time.perf_counter()
    ecfg = None
    balance = {}
    if (args.domains == 1 and args.async_n == 1
            and args.rebalance_every == 0 and args.rebalance_skew == 0
            and not args.cell_order):
        state = pic.init_state(cfg, 0, device=dev)
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
    else:
        ecfg = make_engine_config(cfg, domains=args.domains,
                                  max_migration=8192, async_n=args.async_n,
                                  max_births=args.max_births,
                                  rebalance_every=args.rebalance_every,
                                  rebalance_skew=args.rebalance_skew,
                                  cell_order=args.cell_order)
        state = engine.init_engine_state(ecfg, 0, device=dev)
        step = engine.make_engine_step(ecfg)
        diag = {}
        for _ in range(args.steps):
            state, diag = step(state)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
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
    print(f"{args.steps} steps, {args.domains} domain(s), "
          f"async_n={args.async_n}, rebalance_every={args.rebalance_every}, "
          f"strategy={args.strategy}: {wall:.2f}s "
          f"({wall / args.steps * 1e3:.1f} ms/step)")
    print("final populations:", counts)
    if balance:
        print("queue balance:", balance)
    if args.phases:
        if ecfg is None:
            print("--phases times the engine pipeline; pass --domains or "
                  "--async-n > 1 (the single-domain run above used the "
                  "plain hot loop)")
        else:
            probe = perf.phase_breakdown(ecfg, iters=3, warmup=1,
                                         device=dev)
            print("per-phase (us/step):",
                  {k: round(v, 1) for k, v in probe["phases"].items()},
                  f"total={probe['total']:.1f}")
            for flag in probe["flags"]:
                print("probe flag:", flag)

if __name__ == "__main__":
    main()
