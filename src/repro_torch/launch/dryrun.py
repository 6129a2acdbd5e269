"""Multi-pod dry-run: trace every (arch x shape x mesh) cell on the
production mesh without a cluster (the port of ``repro.launch.dryrun``).

The reference lowers and compiles each cell for 512 emulated host devices.
The port traces it: the process joins torch's ``fake`` process group at
world 512 (``mesh.start_group("fake", 512)``), so the 16 x 16 and
2 x 16 x 16 meshes exist as rank names only, and runs the cell's step once
under ``FakeTensorMode``, with every parameter, optimizer moment, batch and
cache a DTensor of fake tensors placed by ``sharding.rules`` (on ``cuda``
where torch has CUDA; see ``trace_device``).
Nothing is allocated, nothing is compiled and nothing is sent, on any
machine, a card or none. Per cell it runs the right step:

  train_4k     -> train_step(params, opt_state, batch)
  prefill_32k  -> forward(params, tokens[, frontend])
  decode_32k   -> serve_step(params, token, cache, pos)
  long_500k    -> serve_step at 524288 cache (sub-quadratic archs only)

under ``roofline.analysis.CostMode`` (this rank's FLOPs, bytes and
collective bytes) and a ``MemTracker`` (this rank's peak bytes, the
counterpart of ``memory_analysis()``'s argument + output + temp), and
emits the roofline row.

``--pic`` cannot be traced so: the engine reads counters on the host
(``.item()``, ``nonzero``). ``run_pic_dryrun`` runs the port's engine for
one real step at D = the mesh's domain count, §3.3 global size, on the
device it is given, under the same counters.

Usage:
  python -m repro_torch.launch.dryrun [--arch A] [--shape S] \
      [--mesh pod|multipod|both] [--out dryrun_results.json] [--pic] \
      [--opt] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.common import ModelConfig
from repro_torch.models.registry import build
from repro_torch.roofline import analysis
from repro_torch.sharding import rules
from repro_torch.train import optimizer as opt
from repro_torch.train.serve_step import make_prefill, make_serve_step
from repro_torch.train.train_step import TrainConfig, make_train_step

SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}

HBM_PER_CHIP = 80 * 1024 ** 3     # H100 SXM5 80 GB
# ranks of the fake group: the multi-pod mesh's; the pod mesh takes the
# first 256, as the reference's 512-device dry-run does
FAKE_WORLD = 512


def trace_device() -> str:
    """The device type of the fake tensors a cell is traced on: "cuda"
    where torch is built with CUDA (the card's build), "cpu" otherwise. A
    CPU-only build cannot fake every CUDA op: DTensor's vocab-sharded
    embedding lookup masks its indices with ``t[mask] = 0``, which such a
    build runs for real on "cuda" and fails. The counts do not depend on
    the device type."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def opt_config_for(cfg: ModelConfig) -> opt.OptConfig:
    if cfg.arch in rules.FSDP_ARCHS:
        # factored second moment + bf16 state: the only way the 100B+ archs'
        # optimizer fits
        return opt.OptConfig(kind="adafactor", state_dtype=torch.bfloat16)
    return opt.OptConfig(kind="adamw")


def skip_reason(cfg: ModelConfig, shape: str) -> str | None:
    if shape == "long_500k" and not cfg.subquadratic:
        return ("full quadratic attention at 524k context; skipped per "
                "assignment (sub-quadratic archs only)")
    return None


def _require_fake() -> None:
    from torch._guards import active_fake_mode

    if active_fake_mode() is None:
        raise RuntimeError("input_specs makes fake tensors: call it under "
                           "FakeTensorMode (lower_cell does)")


def _stand_in(tree, spec_tree, mesh):
    """Fake tensors of ``tree``'s shapes and dtypes on the mesh's device,
    placed by ``spec_tree`` (through ``enforce_divisible``)."""
    return rules.distribute(
        opt.tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype,
                                           device=mesh.device_type), tree),
        spec_tree, mesh)


def _batch_spec(mesh, b: int, ndim: int) -> rules.Spec:
    axes = rules.batch_axes(mesh)
    lead = axes if b % rules.axes_size(mesh, axes) == 0 else None
    return rules.Spec(lead, *([None] * (ndim - 1)))


def input_specs(cfg: ModelConfig, shape_name: str, mesh) -> dict:
    """Fake stand-ins for every model input of the cell, placed on
    ``mesh``; call under ``FakeTensorMode`` (nothing is allocated)."""
    _require_fake()
    info = SHAPES[shape_name]
    b, s = info["batch"], info["seq"]
    dev = mesh.device_type
    m = build(cfg)

    pshapes = m.init_params(torch.Generator())      # fake, on the CPU
    pspecs = rules.param_specs(cfg, pshapes, mesh)
    params = _stand_in(pshapes, pspecs, mesh)
    out = {"params": params, "pspecs": pspecs, "pshapes": pshapes}

    def tokens(n):
        return rules.distribute(
            torch.empty((b, n), dtype=torch.int32, device=dev),
            _batch_spec(mesh, b, 2), mesh)

    def frontend():
        n = cfg.enc_seq if cfg.kind == "encdec" else cfg.frontend_tokens
        return rules.distribute(
            torch.empty((b, n, cfg.d_model), dtype=torch.float32,
                        device=dev), _batch_spec(mesh, b, 3), mesh)

    s_tok = s - (cfg.frontend_tokens if cfg.kind == "vlm" else 0)
    if info["kind"] == "train":
        batch = {"tokens": tokens(s_tok)}
        if cfg.kind in ("encdec", "vlm"):
            batch["frontend"] = frontend()
        ocfg = opt_config_for(cfg)
        ostruct = opt.init(pshapes, ocfg)
        ospecs = rules.opt_state_specs(ocfg.kind, pspecs, pshapes, mesh,
                                       ocfg.compress_grads)
        out.update(batch=batch, opt_state=_stand_in(ostruct, ospecs, mesh),
                   ospecs=ospecs, ocfg=ocfg)
    elif info["kind"] == "prefill":
        out["tokens"] = tokens(s_tok)
        if cfg.kind in ("encdec", "vlm"):
            out["frontend"] = frontend()
    else:  # decode
        cstruct = m.init_cache(b, s, device="cpu")  # fake, on the CPU
        cspecs = rules.cache_specs(cfg, cstruct, mesh, b)
        out["cache"] = _stand_in(cstruct, cspecs, mesh)
        out["cspecs"] = cspecs
        out["token"] = tokens(1)
        out["pos"] = s - 1
    return out


def model_flops(cfg: ModelConfig, shape_name: str) -> float:
    info = SHAPES[shape_name]
    n_active = cfg.num_active_params()
    tokens = info["batch"] * (info["seq"] if info["kind"] != "decode" else 1)
    mult = 6.0 if info["kind"] == "train" else 2.0
    return mult * n_active * tokens


@dataclasses.dataclass
class Traced:
    """One traced run of a cell: what ``CostMode`` counted, the peak bytes
    this rank held, and the step's (fake) result."""
    cost: analysis.CostMode
    peak_bytes: int
    result: object


def lower_cell(cfg: ModelConfig, shape_name: str, mesh
               ) -> tuple[Traced, int, float]:
    """Returns (traced, chips, model_flops). The reference lowers the cell
    to HLO here; the port's counterpart of lowering is one run of the step
    under ``FakeTensorMode`` on ``mesh``, counted as it runs (the name is
    kept so the two dry-runs read alike)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    info = SHAPES[shape_name]
    chips = mesh.size()
    with FakeTensorMode():
        spec = input_specs(cfg, shape_name, mesh)
        if info["kind"] == "train":
            tcfg = TrainConfig(opt=spec["ocfg"], loss_chunk=512, remat=True)
            fn = make_train_step(cfg, tcfg)
            args = (spec["params"], spec["opt_state"], spec["batch"])
            external = (spec["params"], spec["opt_state"])
        elif info["kind"] == "prefill":
            prefill = make_prefill(cfg)

            def fn(params, tokens, frontend=None):
                return prefill(params, tokens, frontend)[0]

            args = (spec["params"], spec["tokens"], spec.get("frontend"))
            external = (spec["params"],)
        else:
            fn = make_serve_step(cfg)
            args = (spec["params"], spec["token"], spec["cache"],
                    spec["pos"])
            external = (spec["params"], spec["cache"])
        tracker = analysis.peak_memory()
        tracker.track_external(*[x for t in external
                                 for x in opt.tree_leaves(t)])
        with tracker, analysis.CostMode() as cost:
            result = fn(*args)
        peak = analysis.peak_bytes(tracker)
    return Traced(cost, peak, result), chips, model_flops(cfg, shape_name)


def optimize_cfg(cfg: ModelConfig, mesh, shape_name: str) -> ModelConfig:
    """The beyond-paper configuration: these knobs add sequence-parallel
    attention constraints (32k+ shapes only), bf16 PV products, and MoE
    sub-group dispatch with explicit EP sharding."""
    long_ctx = SHAPES[shape_name]["seq"] >= 32768
    return dataclasses.replace(
        cfg,
        tp_axis="model",
        tp_size=rules.axis_size(mesh, "model") if long_ctx else 0,
        dp_axes=rules.batch_axes(mesh),
        # short shapes: attention data-parallel (replicated over tp)
        attn_dp_only=not long_ctx,
        moe_group=512 if cfg.kind == "moe" else 0, attn_p_bf16=True)


def run_cell(arch: str, shape_name: str, mesh, mesh_name: str,
             opt: bool = False) -> dict:
    cfg = get_config(arch)
    if opt:
        cfg = optimize_cfg(cfg, mesh, shape_name)
    reason = skip_reason(cfg, shape_name)
    base = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
            "variant": "optimized" if opt else "baseline"}
    if reason:
        return {**base, "status": "skipped", "reason": reason}
    try:
        chips = mesh.size()
        mflops = model_flops(cfg, shape_name)
        t0 = time.time()
        traced, _, _ = lower_cell(cfg, shape_name, mesh)
        t_lower = time.time() - t0
        roof = analysis.from_counts(traced.cost, chips, mflops)
        per_chip = traced.peak_bytes
        return {
            **base, "status": "ok", "chips": chips,
            "lower_s": round(t_lower, 1),
            "memory": {"peak_bytes": int(per_chip)},
            "bytes_per_chip_est": int(per_chip),
            "fits_80g": bool(per_chip < HBM_PER_CHIP),
            "model_flops": mflops,
            "roofline": roof.row(),
        }
    except Exception as e:  # a failing cell is a bug: surface it loudly
        return {**base, "status": "FAILED", "error": f"{type(e).__name__}: "
                f"{e}", "trace": traceback.format_exc()[-2000:]}


def run_pic_dryrun(mesh, mesh_name: str, device="cuda") -> dict:
    """The paper's own configuration at the mesh's domain count: one real
    engine step on ``device`` (the engine cannot be traced under fake
    tensors), counted as a cell is. FLOPs and bytes are a domain's share of
    the step (its counts over D); the collective term is the elements the
    halo moved (``halo.ppermute.moved``, 4 bytes each) over D."""
    from torch.utils._pytree import tree_leaves

    from repro_torch.configs.pic_bit1 import make_config
    from repro_torch.core import decomposition
    from repro_torch.distributed import engine, halo

    d = mesh_lib.domain_count(mesh)
    cfg = make_config(scale=d)          # 100k cells global, scaled particles
    dcfg = decomposition.DomainConfig(pic=cfg, domains=d, max_migration=2048)
    t0 = time.time()
    step = decomposition.make_distributed_step(dcfg)
    state = decomposition.init_distributed_state(dcfg, 0, device)
    tracker = analysis.peak_memory()
    tracker.track_external(*[x for x in tree_leaves(engine.state_tree(
        state)) if isinstance(x, torch.Tensor)])
    moved0 = halo.ppermute.moved
    with tracker, analysis.CostMode() as cost:
        state, diag = step(state)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
    moved = halo.ppermute.moved - moved0
    roof = analysis.Roofline(
        flops=cost.flops / d, hbm_bytes=cost.hbm_bytes / d,
        coll_bytes=4.0 * moved / d,
        coll_breakdown={"collective-permute": int(4 * moved / d)},
        chips=mesh.size())
    peak = analysis.peak_bytes(tracker)
    return {"arch": "pic-bit1", "shape": f"{cfg.nc}cells", "mesh": mesh_name,
            "status": "ok", "chips": mesh.size(), "domains": d,
            "step_s": round(time.time() - t0, 1),
            "memory": {"peak_bytes": peak},
            "bytes_per_chip_est": peak // d,
            "fits_80g": bool(peak // d < HBM_PER_CHIP),
            "roofline": roof.row()}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both",
                    choices=["pod", "multipod", "both"])
    ap.add_argument("--out", default="dryrun_results.json")
    ap.add_argument("--pic", action="store_true",
                    help="also run the paper's PIC config for one step")
    ap.add_argument("--opt", action="store_true",
                    help="apply the beyond-paper configuration")
    ap.add_argument("--device", default="cuda",
                    help="the device of the --pic engine step ('cuda' "
                         "unless 'cpu' is asked for); the cells are "
                         "traced on no device")
    args = ap.parse_args(argv)

    started = not torch.distributed.is_initialized()
    mesh_lib.start_group("fake", FAKE_WORLD)
    try:
        meshes = []
        if args.mesh in ("pod", "both"):
            meshes.append(("pod16x16", mesh_lib.make_production_mesh(
                multi_pod=False, device=trace_device())))
        if args.mesh in ("multipod", "both"):
            meshes.append(("multipod2x16x16", mesh_lib.make_production_mesh(
                multi_pod=True, device=trace_device())))

        archs = [args.arch] if args.arch else list(ARCHS)
        shapes = [args.shape] if args.shape else list(SHAPES)

        results = []
        if os.path.exists(args.out):
            with open(args.out) as f:
                results = json.load(f)
        done = {(r["arch"], r["shape"], r["mesh"]) for r in results
                if r.get("status") in ("ok", "skipped")}

        for mesh_name, mesh in meshes:
            if args.pic:
                row = run_pic_dryrun(mesh, mesh_name, args.device)
                print(json.dumps(row)[:400], flush=True)
                results.append(row)
                with open(args.out, "w") as f:
                    json.dump(results, f, indent=1)
            for arch in archs:
                for shape in shapes:
                    if (arch, shape, mesh_name) in done:
                        continue
                    row = run_cell(arch, shape, mesh, mesh_name,
                                   opt=args.opt)
                    print(json.dumps({k: v for k, v in row.items()
                                      if k != "trace"})[:500], flush=True)
                    results.append(row)
                    with open(args.out, "w") as f:
                        json.dump(results, f, indent=1)
    finally:
        if started:
            mesh_lib.stop_group()

    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    n_fail = sum(r["status"] == "FAILED" for r in results)
    print(f"dry-run complete: {n_ok} ok, {n_skip} skipped, {n_fail} FAILED")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
