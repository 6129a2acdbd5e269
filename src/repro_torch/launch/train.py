"""Training launcher: params, optimizer, train step and the checkpointed
loop (the port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \
        [--smoke | --full] [--steps 20] [--batch 4] [--seq 128] \
        [--ckpt-dir DIR] [--ckpt-every 10] [--microbatches 1] \
        [--device cuda|cpu]

Builds the arch at its smoke config (``--full``: its published config)
with random weights from seed 0, AdamW (lr 3e-4, 10 warm-up steps),
``loss_chunk`` min(seq, 512) and remat, and trains on the synthetic
pipeline's batches through ``runtime.fault_tolerance.run_training``,
checkpointing every ``--ckpt-every`` steps into ``--ckpt-dir`` (default:
``repro_torch_launch_train`` in the system's temporary directory). It
prints the reference's last line, ``N steps in Xs; loss a -> b``. It runs
on the CUDA device unless --device cpu is given, and stops with an error
when no card is present.

``--mesh`` keeps the reference's choices: ``debug`` is the one device;
``pod`` and ``multipod`` raise ``NotImplementedError`` until the port has
a mesh (``sharding/rules.py`` and ``launch/mesh.py``).
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time


def main(argv=None) -> None:
    from repro_torch.configs import ARCHS

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b", choices=list(ARCHS))
    ap.add_argument("--smoke", action="store_true", default=True,
                    help="use the reduced config (CPU-feasible)")
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--mesh", default="debug",
                    choices=["debug", "pod", "multipod"])
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_launch_train"))
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' runs the kernels; 'cpu' their plain "
                         "PyTorch versions")
    args = ap.parse_args(argv)
    if args.mesh != "debug":
        raise NotImplementedError(
            f"--mesh {args.mesh}: the port has no mesh yet; it comes with "
            f"the tools slice (sharding/rules.py, launch/mesh.py)")

    import torch

    from repro_torch.ckpt.checkpoint import Checkpointer
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data.pipeline import DataConfig, synthetic_batch
    from repro_torch.device import resolve_device
    from repro_torch.models.registry import build
    from repro_torch.runtime.fault_tolerance import run_training
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import TrainConfig, make_train_step

    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    dev = resolve_device(args.device)
    params = build(cfg).init_params(torch.Generator(device=dev).manual_seed(0))
    ocfg = opt.OptConfig(lr=3e-4, warmup_steps=10)
    tcfg = TrainConfig(opt=ocfg, loss_chunk=min(args.seq, 512), remat=True,
                       microbatches=args.microbatches)
    opt_state = opt.init(params, ocfg)
    dcfg = DataConfig(global_batch=args.batch, seq_len=args.seq)
    ckpt = Checkpointer(args.ckpt_dir)

    t0 = time.perf_counter()
    params, opt_state, log = run_training(
        make_train_step(cfg, tcfg),
        lambda s: synthetic_batch(dcfg, cfg, s, dev), params, opt_state,
        num_steps=args.steps, ckpt=ckpt, ckpt_every=args.ckpt_every)
    wall = time.perf_counter() - t0
    print(f"{args.steps} steps in {wall:.1f}s; "
          f"loss {log[0]['loss']:.3f} -> {log[-1]['loss']:.3f}")


if __name__ == "__main__":
    main()
