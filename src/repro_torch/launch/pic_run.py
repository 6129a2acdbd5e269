"""PIC launcher, single domain: run the paper's scenario on the card.

    PYTHONPATH=src python -m repro_torch.launch.pic_run --steps 100 \
        [--nc 4096] [--particles 131072] \
        [--strategy unified|explicit|async_batched|fused] \
        [--field-solve] [--see-yield Y] [--collisions elastic,cx,coulomb] \
        [--diag-every K] [--device cuda|cpu]

The scenario is ``configs/pic_bit1.make_bench_config(nc, particles)``
(buffers hold twice the initial particles); --see-yield Y switches the walls
to absorbing and re-emits secondary electrons with yield Y; --collisions
adds the binary-collision menu (the deflection through ``ta_kick_ref``, as
the reference launcher leaves ``collide_kernel`` off). It runs on the CUDA
device unless --device cpu is given, and stops with an error when no card
is present. Prints the collision totals (with --collisions), the time per
step and the final populations, in the reference launcher's form.
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
    ap.add_argument("--device", default="cuda",
                    help="'cuda' runs the kernels; 'cpu' their plain "
                         "PyTorch versions")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs.pic_bit1 import (make_bench_config,
                                              make_collision_menu,
                                              make_see_config)
    from repro_torch.core import pic

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
    state = pic.init_state(cfg, 0, device=dev)
    final, diags = pic.run(cfg, args.steps, state=state)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    # count from the final state: with --diag-every K the diagnostics hold
    # zeros on off-steps
    counts = {f"{sc.name}/count": int(buf.count())
              for sc, buf in zip(cfg.species, final.species)}
    colls = {k: int(v.sum()) for k, v in diags.items()
             if k.startswith("coll_")}
    if colls:
        print("collisions (total):", colls)
    print(f"{args.steps} steps, 1 domain(s), async_n=1, rebalance_every=0, "
          f"strategy={args.strategy}: {wall:.2f}s "
          f"({wall / args.steps * 1e3:.1f} ms/step)")
    print("final populations:", counts)


if __name__ == "__main__":
    main()
