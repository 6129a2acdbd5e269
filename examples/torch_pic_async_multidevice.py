"""The asynchronous multi-domain engine of the PyTorch port end to end (the
port of ``examples/pic_async_multidevice.py``).

Runs the BIT1 scenario under the async(n) queue scheduler with the
halo-exchange field phase, verifies conservation against the initial
population, and prints the per-phase timing breakdown
(``repro_torch/distributed/perf.py``). The D domains are rows of (D, ...)
tensors in one process, each (domain, queue) on its own CUDA stream on the
card; no emulated devices are needed. It runs on the CUDA card unless
--device cpu is given.

    PYTHONPATH=src python examples/torch_pic_async_multidevice.py \
        --domains 4 --async-n 2 [--steps 40] [--ionization] [--device cpu]
"""

import argparse
import dataclasses
import time

import torch

from repro_torch.configs.pic_bit1 import make_bench_config, make_engine_config
from repro_torch.device import resolve_device
from repro_torch.distributed import engine, perf


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--domains", type=int, default=4)
    ap.add_argument("--async-n", type=int, default=2)
    ap.add_argument("--rebalance-every", type=int, default=0,
                    help="compact + re-split queues every K steps (0 = off)")
    ap.add_argument("--rebalance-skew", type=int, default=0,
                    help="also re-split when per-queue occupancy skew "
                         "exceeds this threshold (0 = off)")
    ap.add_argument("--ionization", action="store_true",
                    help="keep the scenario's MC ionization source active "
                         "(ring-claimed births on the queue pipeline); the "
                         "conservation check then accounts for the pairs")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--nc", type=int, default=512)
    ap.add_argument("--n", type=int, default=16_384)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' runs the kernels; 'cpu' their plain "
                         "PyTorch versions")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = make_bench_config(nc=args.nc, n=args.n, strategy="fused")
    # the halo field phase on (the paper's own test disables it); pure
    # transport by default, or the scenario's MC ionization on the queue
    # pipeline (ring-claimed births) with --ionization
    cfg = dataclasses.replace(
        cfg, field_solve=True,
        ionization=cfg.ionization if args.ionization else None)
    ecfg = make_engine_config(cfg, domains=args.domains,
                              async_n=args.async_n, max_migration=2048,
                              max_births=2048,
                              rebalance_every=args.rebalance_every,
                              rebalance_skew=args.rebalance_skew)

    state = engine.init_engine_state(ecfg, seed=0, device=dev)
    step = engine.make_engine_step(ecfg)
    n0 = {sc.name: (sc.n_init // args.domains) * args.domains
          for sc in cfg.species}

    t0 = time.perf_counter()
    migrated = ionized = 0
    for _ in range(args.steps):
        state, diag = step(state)
        migrated += int(diag["e/migrated_left"]) + int(
            diag["e/migrated_right"])
        if args.ionization:
            ionized += int(diag["n_ionized"])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0

    print(f"{args.steps} steps on D={args.domains} domains, "
          f"async_n={args.async_n}: {wall:.2f}s "
          f"({wall / args.steps * 1e3:.1f} ms/step) on {dev}, "
          f"{migrated} electron migrations, {ionized} ionizations")
    # every ionization kills one neutral and births an (e-, D+) pair
    delta = {"e": ionized, "D+": ionized, "D": -ionized}
    ok = True
    for sc in cfg.species:
        cnt = int(diag[f"{sc.name}/count"])
        want = n0[sc.name] + delta.get(sc.name, 0)
        print(f"  {sc.name}: {cnt} particles (expect {want}), "
              f"charge {float(diag[f'{sc.name}/charge']):+.2f}, "
              f"queue occupancy {diag[f'{sc.name}/queue_occ'].tolist()} "
              f"(skew {int(diag[f'{sc.name}/queue_skew'])})")
        ok &= cnt == want
    assert ok, "conservation FAILED"
    print("conservation PASSED")

    probe = perf.phase_breakdown(ecfg, iters=3, warmup=1, device=dev)
    phases = dict(probe["phases"], total=probe["total"])
    width = max(len(k) for k in phases)
    print("per-phase breakdown (us/step):")
    for k, v in phases.items():
        print(f"  {k:<{width}} {v:10.1f}")


if __name__ == "__main__":
    main()
