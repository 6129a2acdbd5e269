"""End-to-end training on the PyTorch port: a ~100M-param LM for a few
hundred steps, with checkpointing and restart from the latest checkpoint
(the port of ``examples/train_lm.py``): data pipeline -> model ->
optimizer -> checkpointer. ``--mesh debug`` trains on the 1 x 1
``DeviceMesh`` with every parameter and moment a DTensor placed by
``sharding.rules``. It runs on the CUDA card unless --device cpu is given.

    PYTHONPATH=src python examples/torch_train_lm.py --steps 300 \
        [--mesh debug] [--device cpu]
"""

import argparse
import os
import tempfile
import time

import torch

from repro_torch.ckpt.checkpoint import Checkpointer
from repro_torch.data.pipeline import DataConfig, synthetic_batch
from repro_torch.device import resolve_device
from repro_torch.models.common import ModelConfig
from repro_torch.models.registry import build
from repro_torch.runtime.fault_tolerance import run_training
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import TrainConfig, make_train_step

# ~100M params: a scaled qwen2-style dense model
CFG_100M = ModelConfig(
    arch="qwen2-0.5b", kind="dense",
    n_layers=10, d_model=640, n_heads=10, n_kv_heads=2, d_ff=2560,
    vocab=32_000, ffn_act="swiglu", qkv_bias=True, tie_embeddings=True,
)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--layers", type=int, default=CFG_100M.n_layers,
                    help="cut the depth (the CPU smoke takes 1)")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh", default=None, choices=["debug"],
                    help="train on the 1 x 1 DeviceMesh (DTensors)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' runs the kernels; 'cpu' their plain "
                         "PyTorch versions")
    args = ap.parse_args(argv)

    import dataclasses

    dev = resolve_device(args.device)
    cfg = dataclasses.replace(CFG_100M, n_layers=args.layers)
    params = build(cfg).init_params(
        torch.Generator(device=dev).manual_seed(0))
    n_params = sum(p.numel() for p in opt.tree_leaves(params))
    print(f"model: {n_params / 1e6:.1f}M params")

    tcfg = TrainConfig(opt=opt.OptConfig(lr=3e-4, warmup_steps=20),
                       loss_chunk=64, remat=True)
    dcfg = DataConfig(global_batch=args.batch, seq_len=args.seq)
    opt_state = opt.init(params, tcfg.opt)
    mesh = None
    if args.mesh == "debug":
        from repro_torch.launch.mesh import make_debug_mesh
        from repro_torch.sharding import rules

        mesh = make_debug_mesh(1, 1, device=dev.type)
        pspecs = rules.param_specs(cfg, params, mesh)
        opt_state = rules.distribute(opt_state, rules.opt_state_specs(
            "adamw", pspecs, params, mesh), mesh)
        params = rules.distribute(params, pspecs, mesh)

    def batch_fn(step):
        batch = synthetic_batch(dcfg, cfg, step, dev)
        if mesh is None:
            return batch
        return rules.distribute(
            batch, {k: rules.batch_spec(mesh) for k in batch}, mesh)

    ckpt = Checkpointer(args.ckpt_dir)
    start = ckpt.latest_step() or 0
    if start:
        print(f"resuming from checkpoint step {start}")
        _, state = ckpt.restore(like={"params": params, "opt": opt_state})
        params, opt_state = state["params"], state["opt"]

    t0 = time.perf_counter()
    params, opt_state, log = run_training(
        make_train_step(cfg, tcfg), batch_fn, params, opt_state,
        num_steps=args.steps, ckpt=ckpt, ckpt_every=args.ckpt_every,
        start_step=start)
    wall = time.perf_counter() - t0
    done = args.steps - start
    if done:
        toks = done * args.batch * args.seq
        print(f"{done} steps in {wall:.1f}s "
              f"({toks / wall:.0f} tok/s) on {dev}; "
              f"loss {log[0]['loss']:.3f} -> {log[-1]['loss']:.3f}")
    if mesh is not None:
        from repro_torch.launch.mesh import stop_group

        stop_group()


if __name__ == "__main__":
    main()
