"""Quickstart of the PyTorch port: a tour of its public API (the port of
``examples/quickstart.py``).

Runs (1) a miniature BIT1 ionization scenario, the paper's test case, and
(2) a few training steps of an assigned LM architecture at its reduced
config. Both run on the CUDA card unless --device cpu is given.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""

import argparse

import torch

from repro_torch.configs import get_smoke_config
from repro_torch.configs.pic_bit1 import make_bench_config
from repro_torch.core import pic
from repro_torch.data.pipeline import DataConfig, synthetic_batch
from repro_torch.device import resolve_device
from repro_torch.models.registry import build
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import TrainConfig, make_train_step


def pic_demo(dev) -> None:
    print("== PIC-MC: the paper's ionization scenario (scaled down) ==")
    cfg = make_bench_config(nc=1024, n=32_768)
    _, diags = pic.run(cfg, 50, seed=0, device=dev)
    n = diags["D/count"].cpu()
    ionized = int(diags["n_ionized"].sum())
    print(f"neutrals {int(n[0])} -> {int(n[-1])} over 50 steps "
          f"(ionized: {ionized})")


def lm_demo(dev) -> None:
    print("== LM substrate: one assigned arch, reduced config ==")
    cfg = get_smoke_config("qwen2-0.5b")
    params = build(cfg).init_params(
        torch.Generator(device=dev).manual_seed(0))
    tcfg = TrainConfig(opt=opt.OptConfig(lr=1e-3), loss_chunk=32,
                       remat=False)
    dcfg = DataConfig(global_batch=4, seq_len=64)
    step = make_train_step(cfg, tcfg)
    state = opt.init(params, tcfg.opt)
    batch = synthetic_batch(dcfg, cfg, 0, dev)
    for i in range(5):
        params, state, metrics = step(params, state, batch)
        print(f"step {i}: loss={float(metrics['loss']):.3f}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="'cuda' runs the kernels; 'cpu' their plain "
                         "PyTorch versions")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    pic_demo(dev)
    lm_demo(dev)


if __name__ == "__main__":
    main()
