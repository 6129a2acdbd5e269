#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and hold its kernels against
their plain PyTorch versions.

    python3 chip_smoke.py

Phases (any failure raises and ends the run with a non-zero exit):

1. the card, the versions, and the build of ``src/repro_torch/csrc/*.cu``;
2. each kernel against its plain version on the card, at the shapes of the
   paper's §3.3 run (3 species x 16,777,216 slots, 102,401 nodes) and at a
   ragged small shape for every boundary with and without a magnetic field;
   times by CUDA events beside the least time the card's memory allows;
3. the main path at full width through the port's entry points: the §3.3
   configuration with ``strategy='fused'`` for 5 steps, the same with the
   field solve on (rho carried) for 5 steps, ``strategy='explicit'`` for 3
   steps, and the ``pic_run`` command line; exact pair accounting, finite
   energies and the launches each kernel made per step;
4. a profile of two §3.3 fused steps: device time by kernel, and the
   device's busy share of the step;
5. card against CPU: the small bench configuration, fused with the field
   solve, 3 steps on the card and on a CPU copy of the same state with the
   same random draws;
6. one line of JSON with every kernel's numbers, then the result line.

Exits non-zero and prints no result without a CUDA device, or when the
port's sources are not beside this script.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent

# H100 SXM data sheet: 3.35 TB/s device memory, 67 TFLOP/s float32 (no
# tensor cores); the bound of a kernel is the larger of its bytes over the
# first and its operations over the second
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# flops a slot, counted from the device code: CIC weights 6, gather 6, two
# half kicks 5, drift 2, periodic wrap 4, w*alive 1; the deposit adds CIC 6
# and 4 for the two weighted charges
PUSH_FLOPS = 24
DEPOSIT_FLOPS = 10

TOL = 2e-5          # x / v / w, as tests/test_kernels.py
RHO_TOL = 1e-3      # rho, as tests/test_kernels.py


def log(msg: str) -> None:
    print(msg, flush=True)


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = flops / F32_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def median_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def periodic_err(a, b, length: float) -> float:
    d = (a.double() - b.double()).abs()
    return float(torch.minimum(d, length - d).max()) if a.numel() else 0.0


def check_close(name, err, scale, tol):
    if not err <= tol * (1.0 + scale):
        raise AssertionError(f"{name}: max |kernel - plain| = {err} exceeds "
                             f"{tol} * (1 + {scale})")


def check_equal(name, a, b):
    bad = int((a != b).sum())
    if bad:
        raise AssertionError(f"{name}: {bad} entries differ")


# ---------------------------------------------------------------- phase 2 --

def compare_fused(fused, args, kw, length, periodic):
    """Kernel vs plain on the same inputs; returns the max float error."""
    got = fused.fused_push_deposit(*args, **kw)
    want = fused.fused_push_deposit_plain(*args, **kw)
    torch.cuda.synchronize()
    names = ("x", "v", "alive", "hit_left", "hit_right", "w", "rho")
    worst = 0.0
    for name, g, w in zip(names, got, want):
        if name in ("alive", "hit_left", "hit_right"):
            check_equal(f"fused {name}", g, w)
            continue
        if g is None:
            assert w is None, name
            continue
        err = (periodic_err(g, w, length) if name == "x" and periodic
               else max_err(g, w))
        tol = RHO_TOL if name == "rho" else TOL
        check_close(f"fused {name}", err, float(w.abs().max()), tol)
        worst = max(worst, err)
    if kw["deposit"]:
        # total charge: what was deposited is the surviving charge
        q = (args[7][:, None].double() * want[5].double()).sum()
        rel = abs(float(got[6].double().sum() - q))    # raw units (x dx)
        scale = float((args[7][:, None].abs().double()
                       * want[5].double()).sum())
        assert rel <= 1e-5 * scale + 1e-3, ("fused total charge", rel, scale)
    return worst


def compare_mover(mover, args, kw, length, periodic):
    got = mover.mover_push(*args, **kw)
    want = mover.mover_push_plain(*args, **kw)
    torch.cuda.synchronize()
    worst = 0.0
    for name, g, w in zip(("x", "v", "alive", "hit_left", "hit_right"),
                          got, want):
        if g.dtype == torch.bool:
            check_equal(f"mover {name}", g, w)
            continue
        err = (periodic_err(g, w, length) if name == "x" and periodic
               else max_err(g, w))
        check_close(f"mover {name}", err, float(w.abs().max()), TOL)
        worst = max(worst, err)
    return worst


def compare_deposit(deposit, x, q, kw):
    got = deposit.deposit(x, q, **kw)
    want = deposit.deposit_plain(x, q, **kw)
    torch.cuda.synchronize()
    err = max_err(got, want)
    scale = float(want.abs().max())
    if not err <= RHO_TOL * (1.0 + scale):
        raise AssertionError(f"deposit: max |kernel - plain| = {err}")
    total = abs(float(got.double().sum() - q.double().sum()))
    assert total <= 1e-5 * float(q.double().abs().sum()) + 1e-3, total
    return err


def kernel_phase(dev):
    from repro_torch.configs.pic_bit1 import make_config
    from repro_torch.core import pic
    from repro_torch.core.particles import stack_species
    from repro_torch.kernels import deposit, fused_cycle, mover

    f32 = torch.float32
    gen = torch.Generator(device=dev).manual_seed(1234)
    results = {}

    # ragged small shapes: every boundary, b on and off, per-species scalars
    for boundary in ("periodic", "absorb", "open"):
        for b in ((0.05, -0.1, 0.2), (0.0, 0.0, 0.0)):
            s, cap, nc, length = 3, 5000, 256, 10.0
            dx = length / nc
            x = torch.rand(s, cap, generator=gen, device=dev) * length
            v = torch.randn(s, cap, 3, generator=gen, device=dev)
            alive = torch.rand(s, cap, generator=gen, device=dev) < 0.9
            w = torch.rand(s, cap, generator=gen, device=dev) * alive
            e = torch.randn(nc + 1, generator=gen, device=dev)
            qm = torch.tensor([-1.0, 0.5, 0.0], dtype=f32, device=dev)
            dts = torch.tensor([0.05, 0.1, 0.2], dtype=f32, device=dev)
            charge = torch.tensor([-1.0, 1.0, 0.0], dtype=f32, device=dev)
            kw = dict(x0=0.0, dx=dx, nc=nc, length=length, b=b,
                      boundary=boundary)
            for dep in (True, False):
                compare_fused(fused_cycle,
                              (x, v, w, alive, e, qm * dts, dts, charge),
                              dict(kw, deposit=dep), length,
                              boundary == "periodic")
            compare_mover(mover, (x[0], v[0], alive[0], e),
                          dict(kw, qm_dt=-0.05, dt=0.05), length,
                          boundary == "periodic")
    xs = torch.rand(3000, generator=gen, device=dev) * 10.0
    compare_deposit(deposit, xs,
                    torch.rand(3000, generator=gen, device=dev),
                    dict(x0=0.0, dx=10.0 / 512, nc=512))
    log("kernels: ragged shapes (cap 5000, 3 boundaries x b on/off) agree "
        "with their plain versions")

    # the main path's shapes: the §3.3 initial state, a non-zero field
    cfg = make_config(mover_strategy="fused")
    grid = cfg.grid
    state = pic.init_state(cfg, 7, device=dev)
    st = stack_species(state.species)
    del state
    s, cap = st.x.shape
    ng = grid.ng
    e = 0.1 * torch.randn(ng, generator=gen, device=dev)
    qm = torch.tensor([sc.charge / sc.mass for sc in cfg.species],
                      dtype=f32, device=dev)
    dts = torch.tensor([cfg.dt] * s, dtype=f32, device=dev)
    charge = torch.tensor([sc.charge for sc in cfg.species], dtype=f32,
                          device=dev)
    kw = dict(x0=0.0, dx=grid.dx, nc=grid.nc, length=grid.length,
              b=cfg.b_field, boundary=cfg.boundary)
    fargs = (st.x, st.v, st.w, st.alive, e, qm * dts, dts, charge)
    err = 0.0
    for dep in (False, True):
        err = max(err, compare_fused(fused_cycle, fargs,
                                     dict(kw, deposit=dep), grid.length,
                                     True))
    fkw = dict(kw, deposit=True)
    n_slots = s * cap
    nbytes = n_slots * (4 + 12 + 4 + 1 + 4 + 12 + 4 + 1 + 1 + 1) + 2 * ng * 4
    bms, by = bound_ms(nbytes, n_slots * (PUSH_FLOPS + DEPOSIT_FLOPS))
    results["fused_push_deposit"] = dict(
        name="fused_push_deposit", route="cuda",
        source="src/repro_torch/csrc/fused_cycle.cu",
        replaces="src/repro/kernels/fused_cycle.py:37",
        max_abs_err=err,
        ms=median_ms(lambda: fused_cycle.fused_push_deposit(
            *fargs, **fkw), 20),
        ms_no_deposit=median_ms(lambda: fused_cycle.fused_push_deposit(
            *fargs, **dict(kw, deposit=False)), 20),
        plain_ms=median_ms(lambda: fused_cycle.fused_push_deposit_plain(
            *fargs, **fkw), 5),
        bound_ms=bms, bound_by=by, library_ms=None)

    mkw = dict(kw, qm_dt=float(cfg.species[0].charge / cfg.species[0].mass
                               * cfg.dt), dt=cfg.dt)
    margs = (st.x[0], st.v[0], st.alive[0], e)
    err = compare_mover(mover, margs, mkw, grid.length, True)
    bms, by = bound_ms(cap * (4 + 12 + 1 + 4 + 12 + 1 + 1 + 1) + ng * 4,
                       cap * PUSH_FLOPS)
    results["mover_push"] = dict(
        name="mover_push", route="cuda",
        source="src/repro_torch/csrc/mover.cu",
        replaces="src/repro/kernels/mover.py:35", max_abs_err=err,
        ms=median_ms(lambda: mover.mover_push(*margs, **mkw), 20),
        plain_ms=median_ms(lambda: mover.mover_push_plain(
            *margs, **mkw), 5),
        bound_ms=bms, bound_by=by, library_ms=None)

    # the deposit of the ionization step: electron density over one species
    x, q = st.x[0], st.w[0] * st.alive[0]
    dkw = dict(x0=0.0, dx=grid.dx, nc=grid.nc)
    err = compare_deposit(deposit, x, q, dkw)
    i, f = mover.cic(x, 0.0, grid.dx, grid.nc)
    idx = torch.cat([i, i + 1])
    upd = torch.cat([q * (1.0 - f), q * f])
    acc = torch.zeros(ng, device=dev)
    lib_ms = median_ms(lambda: acc.zero_().index_add_(0, idx, upd), 20)
    bms, by = bound_ms(cap * 8 + ng * 4, cap * DEPOSIT_FLOPS)
    results["deposit"] = dict(
        name="deposit", route="cuda", source="src/repro_torch/csrc/deposit.cu",
        replaces="src/repro/kernels/deposit.py:26", max_abs_err=err,
        ms=median_ms(lambda: deposit.deposit(x, q, **dkw), 20),
        plain_ms=median_ms(lambda: deposit.deposit_plain(x, q, **dkw),
                           5),
        bound_ms=bms, bound_by=by, library_ms=lib_ms)
    for r in results.values():
        extra = (f" (no deposit {r['ms_no_deposit']:.4f} ms)"
                 if "ms_no_deposit" in r else "")
        lib = (f", index_add_ {r['library_ms']:.4f} ms"
               if r["library_ms"] is not None else "")
        log(f"kernel {r['name']} at the main-path shape: max_abs_err "
            f"{r['max_abs_err']:.3g}, {r['ms']:.4f} ms{extra}, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}){lib}")
    del st, fargs, margs, x, q, idx, upd
    torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------- phase 3 --

def launches(counters):
    return {name: fn.launches for name, fn in counters.items()}


def drive(cfg, steps, label, counters, per_step, dev, seed=0):
    """Run ``steps`` steps through make_step and check the step's contract:
    exact pair accounting, finite energies, the launches of each kernel."""
    from repro_torch.core import pic

    state = pic.init_state(cfg, seed, device=dev)
    step = pic.make_step(cfg)
    n0 = [int(b.count()) for b in state.species]
    ionized = 0
    times = []
    for k in range(steps):
        before = launches(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, diag = step(state)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        after = launches(counters)
        delta = {n: after[n] - before[n] for n in after}
        if delta != per_step:
            raise AssertionError(f"{label} step {k}: launches {delta}, "
                                 f"expected {per_step}")
        ionized += int(diag["n_ionized"])
        for sc in cfg.species:
            if not bool(torch.isfinite(diag[f"{sc.name}/ke"])):
                raise AssertionError(f"{label}: non-finite {sc.name}/ke")
        if cfg.field_solve and not bool(torch.isfinite(diag["field_energy"])):
            raise AssertionError(f"{label}: non-finite field energy")
    ne, ni, nn = (int(b.count()) for b in state.species)
    if not (ne - n0[0] == ni - n0[1] == ionized == n0[2] - nn):
        raise AssertionError(f"{label}: pair accounting broken: e {n0[0]}->"
                             f"{ne}, D+ {n0[1]}->{ni}, D {n0[2]}->{nn}, "
                             f"ionized {ionized}")
    if ionized <= 0:
        raise AssertionError(f"{label}: no ionization in {steps} steps")
    steady = statistics.median(times[1:]) if steps > 1 else times[0]
    log(f"main path {label}: {steps} steps, ms/step "
        f"{[round(t, 3) for t in times]}"
        f" (median after the first {steady:.3f}), ionized {ionized}, "
        f"populations e {ne} D+ {ni} D {nn}")
    del state
    torch.cuda.empty_cache()
    return steady


def main_path_phase(dev):
    from repro_torch.configs.pic_bit1 import make_config
    from repro_torch.kernels import deposit, fused_cycle, mover
    from repro_torch.launch import pic_run

    counters = {"fused_push_deposit": fused_cycle.fused_push_deposit,
                "mover_push": mover.mover_push, "deposit": deposit.deposit}
    for fn in counters.values():
        fn.launches = 0
    ms = {}
    cfg = make_config(mover_strategy="fused")
    ms["fused"] = drive(cfg, 5, "fused (field solve off)", counters,
                        {"fused_push_deposit": 1, "mover_push": 0,
                         "deposit": 1}, dev)
    ms["fused_field"] = drive(
        dataclasses.replace(cfg, field_solve=True), 5,
        "fused + field solve (rho carried)", counters,
        {"fused_push_deposit": 1, "mover_push": 0, "deposit": 2}, dev)
    ms["explicit"] = drive(
        make_config(mover_strategy="explicit"), 3, "explicit",
        counters, {"fused_push_deposit": 0, "mover_push": 3, "deposit": 1},
        dev)
    before = launches(counters)
    pic_run.main(["--nc", "102400", "--particles", "10485760", "--strategy",
                  "fused", "--steps", "3"])
    after = launches(counters)
    if after["fused_push_deposit"] - before["fused_push_deposit"] != 3:
        raise AssertionError("pic_run did not run the fused kernel per step")
    counts = launches(counters)
    for name, c in counts.items():
        if c <= 0:
            raise AssertionError(f"kernel {name} never launched on the main "
                                 f"path")
    log(f"main path launches: {counts}")
    return counts, ms


def profile_phase(dev, step_ms):
    """Where a §3.3 fused step (field solve off) spends device time: two
    steps under torch.profiler, device kernels by self time. ``step_ms`` is
    the unprofiled step time of phase 3, for the device's busy share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.pic_bit1 import make_config
    from repro_torch.core import pic

    cfg = make_config(mover_strategy="fused")
    state = pic.init_state(cfg, 3, device=dev)
    step = pic.make_step(cfg)
    state, _ = step(state)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            state, _ = step(state)
        torch.cuda.synchronize()
    # device kernels carry the device time; the aten ops that launched
    # them carry the same time again as their self device time
    kernels, ops = [], []
    for e in prof.key_averages():
        if e.self_device_time_total > 0:
            row = (e.self_device_time_total / 2e3, e.count / 2, e.key)
            (ops if e.device_type == DeviceType.CPU else kernels).append(row)
    if not kernels:
        log("profile: the profiler recorded no device time (not measured)")
        return
    busy = sum(r[0] for r in kernels)
    log(f"profile of a fused §3.3 step: device busy {busy:.3f} ms of "
        f"{step_ms:.3f} ms/step ({100 * busy / step_ms:.1f} %), "
        f"{sum(r[1] for r in kernels):.0f} kernels a step")
    for title, rows in (("by operator", ops), ("by kernel", kernels)):
        log(f"  device ms a step {title}:")
        for ms, count, name in sorted(rows, reverse=True)[:10]:
            log(f"  {ms:8.3f} ms  x{count:4.0f}  {name[:90]}")
    del state
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- phase 4 --

def card_vs_cpu_phase(dev):
    import numpy as np

    from repro_torch.configs.pic_bit1 import make_bench_config
    from repro_torch.core import pic

    cfg = dataclasses.replace(make_bench_config(strategy="fused"),
                              field_solve=True)
    cpu = pic.init_state(cfg, 11, device="cpu")
    arrays = [{"x": b.x.numpy(), "v": b.v.numpy(), "w": b.w.numpy(),
               "alive": b.alive.numpy()} for b in cpu.species]
    card = pic.state_from_numpy(cfg, arrays, 0, cpu.rho.numpy(), device=dev)
    rng = np.random.default_rng(5)
    cap = cfg.species[cfg.ionization[0]].capacity
    length = cfg.length
    for k in range(3):
        draws = [{"uniform": rng.random(cap, dtype=np.float32),
                  "normal": rng.standard_normal((cap, 3), dtype=np.float32)}]
        cpu, dc = pic.step_fn(cpu, cfg, draws=draws)
        card, dg = pic.step_fn(card, cfg, draws=draws)
        for key in ("n_ionized", "birth_overflow", "e/count", "D+/count",
                    "D/count"):
            if int(dc[key]) != int(dg[key]):
                raise AssertionError(f"card vs CPU step {k}: {key} "
                                     f"{int(dg[key])} != {int(dc[key])}")
        ex = ev = 0.0
        for bc, bg in zip(cpu.species, card.species):
            check_equal(f"card vs CPU alive step {k}", bg.alive.cpu(),
                        bc.alive)
            ex = max(ex, periodic_err(bg.x.cpu(), bc.x, length))
            vmax = float(bc.v.abs().max())
            ev = max(ev, max_err(bg.v.cpu(), bc.v) / (1.0 + vmax))
        er = max_err(card.rho.cpu(), cpu.rho)
        rmax = float(cpu.rho.abs().max())
        # bands: x to 1e-5 of the period, v to 1e-4 of max|v|, rho to
        # rtol = atol = 1e-3; the deposit's summation order is the only
        # difference the field sees (the field solve runs in float64)
        if ex > 1e-5 * length or ev > 1e-4 or er > RHO_TOL * (1.0 + rmax):
            raise AssertionError(f"card vs CPU step {k}: x {ex}, v {ev} "
                                 f"(of 1+max|v|), rho {er} (max {rmax})")
        log(f"card vs CPU step {k}: counts equal, ionized "
            f"{int(dg['n_ionized'])}, max |dx| {ex:.3g}, max |dv|/(1+max|v|)"
            f" {ev:.3g}, max |drho| {er:.3g}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "the card", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are not beside "
              f"{Path(__file__).name}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    t_start = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    smi = smi.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device "
        f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} "
        f"device(s)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = _build.build()
    log(f"build: {_build.build_seconds:.1f} s into {out.relative_to(ROOT)}")
    for src in _build.SOURCES:
        for line in (out / f"{src}.log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {src}: {line.strip()}")

    kernels = kernel_phase(dev)
    counts, ms = main_path_phase(dev)
    profile_phase(dev, ms["fused"])
    card_vs_cpu_phase(dev)

    log("kernels: " + "; ".join(
        f"{k} launches={counts[k]} max_abs_err={kernels[k]['max_abs_err']:.3g}"
        for k in kernels))
    log(f"main path ms/step (median after the first step): "
        + ", ".join(f"{k} {v:.3f}" for k, v in ms.items()))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    rows = []
    for k, r in kernels.items():
        rows.append({key: r[key] for key in (
            "name", "route", "source", "replaces")}
            | {"launches": counts[k]}
            | {key: r[key] for key in ("max_abs_err", "ms", "plain_ms",
                                       "bound_ms", "bound_by",
                                       "library_ms")})
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
