"""Training launcher: mesh, placements, train step and the checkpointed
loop (the port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \
        [--smoke | --full] [--steps 20] [--batch 4] [--seq 128] \
        [--mesh debug|pod|multipod] [--ckpt-dir DIR] [--ckpt-every 10] \
        [--microbatches 1] [--device cuda|cpu]

Builds the arch at its smoke config (``--full``: its published config)
with random weights from seed 0, places every parameter on the mesh as a
DTensor by ``sharding.rules.param_specs`` (through ``enforce_divisible``)
and the optimizer state by ``opt_state_specs`` when a mesh is asked for,
and trains with AdamW (lr
3e-4, 10 warm-up steps), ``loss_chunk`` min(seq, 512) and remat on the
synthetic pipeline's batches (batch-sharded) through
``runtime.fault_tolerance.run_training``, checkpointing every
``--ckpt-every`` steps into ``--ckpt-dir`` (default:
``repro_torch_launch_train`` in the system's temporary directory). It
prints the reference's last line, ``N steps in Xs; loss a -> b``.

Without ``--mesh`` the state is plain tensors on ``--device``. ``--mesh
debug`` is the 1 x 1 mesh on the device of ``--device`` (a process group
of one: NCCL on the card, gloo on the CPU, destroyed at the end when the
launcher started it); ``pod`` and
``multipod`` are the 16 x 16 and 2 x 16 x 16 production meshes, which need
that many ranks (``torchrun``; the process group comes from
``WORLD_SIZE`` / ``RANK``) and raise otherwise. The launcher is the code
path a cluster job runs: it differs only by the mesh and the process-count
environment. It runs on the CUDA device unless --device cpu is given, and
stops with an error when no card is present.
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
    ap.add_argument("--mesh", default=None,
                    choices=["debug", "pod", "multipod"],
                    help="train on this DeviceMesh (default: no mesh, "
                         "plain tensors on --device)")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_launch_train"))
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' runs the kernels; 'cpu' their plain "
                         "PyTorch versions")
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.device import resolve_device
    from repro_torch.launch.mesh import (make_debug_mesh,
                                         make_production_mesh, stop_group)

    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    dev = resolve_device(args.device)
    started = not dist.is_initialized()
    try:
        mesh = None
        if args.mesh == "debug":
            mesh = make_debug_mesh(data=1, model=1, device=dev.type)
        elif args.mesh is not None:
            mesh = make_production_mesh(multi_pod=args.mesh == "multipod",
                                        device=dev.type)
        if mesh is not None and dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
        wall, log, _, _ = _train(args, cfg, dev, mesh)
    finally:
        if started:
            stop_group()
    print(f"{args.steps} steps in {wall:.1f}s; "
          f"loss {log[0]['loss']:.3f} -> {log[-1]['loss']:.3f}")


def _train(args, cfg, dev, mesh):
    """The loop of ``main``: (seconds, metrics log, params, optimizer
    state)."""
    import torch

    from repro_torch.ckpt.checkpoint import Checkpointer
    from repro_torch.data.pipeline import DataConfig, synthetic_batch
    from repro_torch.models.registry import build
    from repro_torch.runtime.fault_tolerance import run_training
    from repro_torch.sharding import rules
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import TrainConfig, make_train_step

    params = build(cfg).init_params(torch.Generator(device=dev).manual_seed(0))
    ocfg = opt.OptConfig(lr=3e-4, warmup_steps=10)
    opt_state = opt.init(params, ocfg)
    if mesh is not None:
        pspecs = rules.param_specs(cfg, params, mesh)
        opt_state = rules.distribute(
            opt_state, rules.opt_state_specs(ocfg.kind, pspecs, params, mesh,
                                             ocfg.compress_grads), mesh)
        params = rules.distribute(params, pspecs, mesh)
    tcfg = TrainConfig(opt=ocfg, loss_chunk=min(args.seq, 512), remat=True,
                       microbatches=args.microbatches)
    dcfg = DataConfig(global_batch=args.batch, seq_len=args.seq)

    def batch_fn(step):
        batch = synthetic_batch(dcfg, cfg, step, dev)
        if mesh is None:
            return batch
        return rules.distribute(
            batch, {k: rules.Spec(rules.batch_axes(mesh)) for k in batch},
            mesh)

    t0 = time.perf_counter()
    params, opt_state, log = run_training(
        make_train_step(cfg, tcfg), batch_fn, params, opt_state,
        num_steps=args.steps, ckpt=Checkpointer(args.ckpt_dir),
        ckpt_every=args.ckpt_every)
    return time.perf_counter() - t0, log, params, opt_state


if __name__ == "__main__":
    main()
