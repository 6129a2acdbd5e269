"""The paper's §3.3 test case end to end on the PyTorch port, with physics
validation (the port of ``examples/pic_ionization.py``).

Unbounded unmagnetized plasma of (e-, D+, D); electron-impact ionization
depletes neutrals as dn/dt = -n n_e R. Runs the scaled scenario, checks the
measured decay against the analytic exponential, and reports the ms a step.
It runs on the CUDA card unless --device cpu is given.

    PYTHONPATH=src python examples/torch_pic_ionization.py [--steps 200] \
        [--device cpu]
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.pic_bit1 import make_bench_config
from repro_torch.core import pic
from repro_torch.device import resolve_device


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--nc", type=int, default=2048)
    ap.add_argument("--n", type=int, default=65_536)
    ap.add_argument("--strategy", default="unified",
                    choices=["unified", "explicit", "async_batched",
                             "fused"])
    ap.add_argument("--device", default="cuda",
                    help="'cuda' runs the kernels; 'cpu' their plain "
                         "PyTorch versions")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = make_bench_config(nc=args.nc, n=args.n, strategy=args.strategy)
    state = pic.init_state(cfg, seed=42, device=dev)

    t0 = time.perf_counter()
    _, diags = pic.run(cfg, args.steps, state=state)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0

    n = diags["D/count"].cpu().numpy().astype(np.float64)
    ne = diags["e/count"].cpu().numpy().astype(np.float64) / cfg.nc
    lhs = np.log(n[-1] / n[0])
    rhs = -np.sum(ne[:-1] * cfg.ionization_rate * cfg.dt)
    print(f"strategy={args.strategy} steps={args.steps} wall={wall:.2f}s "
          f"({wall / args.steps * 1e3:.1f} ms/step) on {dev}")
    print(f"neutrals: {int(n[0])} -> {int(n[-1])}")
    print(f"log-decay measured {lhs:.4f} vs analytic {rhs:.4f} "
          f"(rel err {abs(lhs - rhs) / abs(rhs):.2%})")
    assert abs(lhs - rhs) / abs(rhs) < 0.2, "physics validation FAILED"
    print("physics validation PASSED")


if __name__ == "__main__":
    main()
