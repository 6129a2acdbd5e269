#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and hold its kernels against
their plain PyTorch versions.

    python3 chip_smoke.py

Phases (any failure raises and ends the run with a non-zero exit):

1. the card, the versions, and the build of ``src/repro_torch/csrc/*.cu``;
   for each flash-attention instantiation its registers, spills, shared
   memory and HGMMA (wgmma) instructions in its SASS: a bf16 one that
   spills or holds no HGMMA fails the run; for each instance of the two
   deposit kernels (fused, deposit) its spills and the atomics of its SASS
   by opcode and memory space, and for a block instance its registers,
   shared memory and the blocks that fit: an instance that spills, a pair
   instance that adds other than by float2 reductions in L2, or a block
   instance with an atomic outside shared memory fails the run;
2. each kernel against its plain version on the card, at the shapes of the
   paper's §3.3 run (3 species x 16,777,216 slots, 102,401 nodes; the
   deposit also at the births of one ionization step, 2 x 16,777,216 rows;
   the Takizuka-Abe deflection on the within-cell pairs of the 16,777,216
   electron slots) and at ragged small shapes (every boundary with and
   without a magnetic field; the deposit kernels' two forms on either side
   of the grid size that parts them; deflection rows along z and with
   delta = 0), each deposit checked to launch in the form its grid gives;
   times by CUDA events (and the deposit kernels' device time behind a spin
   kernel) beside the least time the card allows, also at an engine
   domain's grid (25,601 nodes, the block form) and at 600,001 nodes;
3. the main paths at full width through the port's entry points, each with
   the kernels' launch counts (and the deposit kernels' counts by form)
   set to 0 just before it and read just after:
   the §3.3 configuration with ``strategy='fused'`` for 5 steps, the same
   with the field solve on (rho carried) for 5 steps, ``strategy='explicit'``
   for 3 steps, the collision menu with ``collide_kernel=True`` (ionization
   off) for 3 steps, and two ``pic_run`` command lines (plain, and with
   ``--collisions``); exact pair accounting or constant counts, the
   collision menu's energy invariants, finite energies and the launches
   each kernel made per step, every deposit in the form its grid gives;
4. profiles of two §3.3 fused steps (field off, and field on) and of one
   collision step: device time by operator and kernel, and the device's
   busy share of the step;
5. card against CPU, each on a CPU copy of the same state with the same
   random draws: the small bench configuration, fused with the field solve,
   3 steps; and the small collision configuration, fused with
   ``collide_kernel=True``, 3 steps each started from the CPU's state;
6. flash attention against its plain version on the card: at the prefill
   shape of qwen2-0.5b (8 x 4,096 tokens, 14 query heads over 2 KV heads,
   head dim 64, causal) in bf16 and f32, and at ragged shapes (lengths that
   are no multiple of a tile, fewer queries than keys, windows, GQA groups
   1/2/7/8, head dims 16 to 256, rows that see no key, the head-folded
   (bh, s, hd) signature); times by CUDA events beside its bound and beside
   PyTorch's ``scaled_dot_product_attention`` on the same tensors (a
   yardstick only: the port never calls it), and the same for one layer of
   qwen2-7b (B 2, S 4,096, 28/4 heads, D 128) and of gemma-7b (B 1, S
   4,096, 16/16 heads, D 256), for information;
7. the LM serving path at the full width and depth of qwen2-0.5b, weights
   from a seeded generator on the card, through ``get_config``,
   ``registry.build``, ``make_prefill`` and ``make_serve_step``: a prefill of
   8 prompts x 4,096 tokens (logits at the last position; exactly one flash
   launch a layer), 4 requests of 512-token prompts fed by teacher-forced
   decode steps then 32 greedy tokens (no flash launch), the decode logits
   at every prompt position against the prefill's on the same prompts
   (rel < 0.02), the ``serve_lm --full`` command line, and a profile of one
   prefill;
8. card against CPU for the LM: qwen2-0.5b at full width cut to 2 layers,
   in f32, on the same weights and a 128-token prompt: prefill and decode
   logits within 1e-4 of max |logits|, greedy tokens equal wherever the
   top-2 gap exceeds that band;
9. the multi-domain engine (run after phase 5), with the kernels' launch
   counts set to 0 before each of its paths and read after: the §3.3
   configuration with the field solve on (rho carried) and ionization at
   (domains, async_n) = (1, 1), (4, 1), (4, 4), 5 steps each, with exact
   pair accounting, every overflow counter 0, charge equal to the counts,
   the launches of every step pinned by kernel and deposit form
   (``engine_launches``), host ms/step, a 2-step profile (device busy,
   and the time kernels on different streams overlap, read from the
   trace's stream ids after a calibration with two spin kernels) and
   ``perf.phase_breakdown``; async_n 1 against 4 at D = 4 (ionization
   off: counts and charge equal, KE within 1e-5); the collision menu with
   ``collide_kernel=True`` at D = 4, async_n 4 (``ta_kick`` once a queue
   a domain); the queue push and the small deposits timed at D = 4's
   shapes; card against CPU on the bench configuration at D = 4, async_n
   2 with the same draws (counts, masks, rings and pending exact, x
   within 1e-5 of the slab, v 1e-4 of max|v|, rho 1e-3); and ``pic_run
   --domains 4 --async-n 4 --field-solve --phases`` at full size, its
   lines in the reference launcher's form;
10. one line of JSON with every kernel's numbers (launches summed over
   the main paths and the engine's), then the result line.

Exits non-zero and prints no result without a CUDA device, or when the
port's sources are not beside this script.
"""

from __future__ import annotations

import dataclasses
import json
import re
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
BF16_FLOPS = 989e12     # dense bf16 tensor cores
# flops a slot, counted from the device code: CIC weights 6, gather 6, two
# half kicks 5, drift 2, periodic wrap 4, w*alive 1; the deposit adds CIC 6
# and 4 for the two weighted charges
PUSH_FLOPS = 24
DEPOSIT_FLOPS = 10
# flops a row of the Takizuka-Abe deflection, from csrc/collide.cu on its
# general branch: cos/sin of theta 8, the two magnitudes 7 (square roots
# counted as one), cos/sin of phi 2, the degenerate-frame test 3, du 27
TA_FLOPS = 47
TA_BYTES = 32       # u 12, delta 4, phi 4 read; du 12 written
COLL_KEYS = ("coll_elastic", "coll_cx", "coll_coulomb")

TOL = 2e-5          # x / v / w, as tests/test_kernels.py
RHO_TOL = 1e-3      # rho, as tests/test_kernels.py
# flash attention against its plain version, (rtol, atol) by input dtype.
# f32 as tests/test_flash_attention.py holds the Pallas kernel. In bf16 both
# sides sum in f32 from the same inputs and round the output once, so they
# may differ by about one bf16 ulp: rtol two ulps (1/64), atol 4e-3 (two ulps
# at 0.5). The reference test's 3e-2 compares against a bf16 oracle and
# would be as large as a typical output at S 4096.
FLASH_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (1 / 64, 4e-3)}
LM_ARCH = "qwen2-0.5b"


def log(msg: str) -> None:
    print(msg, flush=True)


def bound_ms(nbytes: float, flops: float,
             peak: float = F32_FLOPS) -> tuple[float, str]:
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = flops / peak * 1e3
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

def in_form(wrapper, ng, call):
    """``call()``, checking that it launched ``wrapper`` once in the form
    ``deposit_form(ng)`` gives."""
    from repro_torch.kernels.deposit import deposit_form

    name = f"launches_{deposit_form(ng)}"
    before = getattr(wrapper, name)
    out = call()
    if getattr(wrapper, name) != before + 1:
        raise AssertionError(f"{wrapper.__name__} at {ng} nodes did not "
                             f"launch in the {deposit_form(ng)} form")
    return out


def compare_fused(fused, args, kw, length, periodic):
    """Kernel vs plain on the same inputs (with a deposit, in the form of
    the grid); returns the max float error."""
    def call():
        return fused.fused_push_deposit(*args, **kw)

    got = (in_form(fused.fused_push_deposit, kw["nc"] + 1, call)
           if kw["deposit"] else call())
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
    got = in_form(deposit.deposit, kw["nc"] + 1,
                  lambda: deposit.deposit(x, q, **kw))
    want = deposit.deposit_plain(x, q, **kw)
    torch.cuda.synchronize()
    err = max_err(got, want)
    scale = float(want.abs().max())
    if not err <= RHO_TOL * (1.0 + scale):
        raise AssertionError(f"deposit: max |kernel - plain| = {err}")
    total = abs(float(got.double().sum() - q.double().sum()))
    assert total <= 1e-5 * float(q.double().abs().sum()) + 1e-3, total
    return err


def compare_ta_kick(collide, u, delta, phi):
    """Kernel vs plain on the same rows: du within 1e-6 (1 + max|u|),
    |u + du| = |u| to 1e-5, and delta = 0 rows deflected by exactly 0."""
    got = collide.ta_kick(u, delta, phi)
    want = collide.ta_kick_plain(u, delta, phi)
    torch.cuda.synchronize()
    err = max_err(got, want)
    umax = float(u.abs().max())
    check_close("ta_kick du", err, umax, 1e-6)
    mag0 = torch.linalg.vector_norm(u.double(), dim=1)
    mag1 = torch.linalg.vector_norm(u.double() + got.double(), dim=1)
    bad = int(((mag1 - mag0).abs() > 1e-5 * mag0 + 1e-6 * (1 + umax)).sum())
    if bad:
        raise AssertionError(f"ta_kick: |u + du| != |u| on {bad} rows")
    zero = delta == 0
    if bool((got[zero] != 0).any()):
        raise AssertionError("ta_kick: a delta = 0 row was deflected")
    return err


def main_path_ta_inputs(electrons, cfg):
    """The rows the collision path hands the deflection kernel: one
    ``coulomb_intra`` call on ``electrons`` with the menu's Coulomb rate,
    whose ``ops.ta_kick`` call is recorded and answered by the plain
    version (no launch is counted)."""
    from repro_torch.configs.pic_bit1 import make_collision_menu
    from repro_torch.core import collisions
    from repro_torch.kernels import collide, ops

    rate = make_collision_menu(("coulomb",))[0].rate
    seen = {}

    def record(u, delta, phi):
        seen.update(u=u, delta=delta, phi=phi)
        return collide.ta_kick_plain(u, delta, phi)

    gen = torch.Generator(device=electrons.x.device).manual_seed(99)
    orig, ops.ta_kick = ops.ta_kick, record
    try:
        collisions.coulomb_intra(
            gen, electrons, collisions.cell_density(cfg.grid, electrons),
            cfg.grid, rate, cfg.dt, use_kernel=True)
    finally:
        ops.ta_kick = orig
    return seen["u"], seen["delta"], seen["phi"]


def deposit_bound(q, ng):
    """(bound ms, bound_by, charged elements) of a deposit of ``q``: the
    bytes it must move are q whole, the 32-byte sectors of x that hold a
    charged element, and the (ng,) result; 10 flops a charged element."""
    charged = q != 0
    pad = charged.new_zeros((-charged.numel()) % 8)
    sectors = int(torch.cat([charged, pad]).view(-1, 8).any(1).sum())
    nnz = int(charged.sum())
    bms, by = bound_ms(4 * q.numel() + 32 * sectors + 4 * ng,
                       nnz * DEPOSIT_FLOPS)
    return bms, by, nnz


def main_path_birth_inputs(cfg, species, dev):
    """The rows the carried-rho cycle deposits for the births of one
    ionization step on ``species`` (``pic.step_fn``): both halves of every
    candidate pair at the neutral's x, q_e * w * ok then q_i * w * ok,
    flattened as ``grid.deposit_windowed`` does."""
    from repro_torch.core import collisions

    ni, ei, ii = cfg.ionization
    params = collisions.IonizationParams(rate=cfg.ionization_rate,
                                         vth_electron=cfg.ionization_vth_e)
    gen = torch.Generator(device=dev).manual_seed(98)
    *_, births = collisions.ionize(gen, species[ni], species[ei],
                                   species[ii], cfg.grid, params, cfg.dt)
    bw = births.w * births.ok
    x = torch.stack([births.x, births.x]).reshape(-1)
    q = torch.stack([cfg.species[ei].charge * bw,
                     cfg.species[ii].charge * bw]).reshape(-1)
    return x.contiguous(), q.contiguous()


# a spin kernel of this many SM cycles (~2.5 ms on an H100) keeps the card
# busy while the host enqueues the call that ``device_ms`` times
SLEEP_CYCLES = 5_000_000


def device_ms(fn, reps: int = 10) -> float:
    """Device time of one call of ``fn``: CUDA events around the call,
    enqueued behind a spin kernel, so the card runs the call's kernels back
    to back and the host's time between launches falls outside the
    events. Unlike ``median_ms``, it leaves out the wrapper's host time."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def timed(what, fn, bms):
    """Times ``fn`` by CUDA events around a call (as every kernel row) and
    by ``device_ms``, beside the bound; returns (ms, device ms)."""
    ms, dms = median_ms(fn, 20), device_ms(fn)
    log(f"{what}: {ms:.4f} ms (device {dms:.4f}), bound {bms:.4f} ms, "
        f"share of bound {bms / ms:.3f} (device {bms / dms:.3f})")
    return ms, dms


def kernel_phase(dev):
    from repro_torch.configs.pic_bit1 import make_config
    from repro_torch.core import pic
    from repro_torch.core.particles import SpeciesBuffer, stack_species
    from repro_torch.kernels import collide, deposit, fused_cycle, mover

    f32 = torch.float32
    gen = torch.Generator(device=dev).manual_seed(1234)
    results = {}

    # ragged small shapes: every boundary, b on and off, per-species
    # scalars, cap 5000 (no multiple of a block); with a deposit the block
    # form at 257 nodes, and with b on both forms at the grid sizes on
    # either side of one block's shared memory (58,112 and 58,113 nodes).
    # The 58,112-node cases take dx = 10 / 58,111, no power of two: every
    # path computes the cell coordinate as (x - x0) * inv_dx with the same
    # float32 reciprocal (the rounding jitted JAX gives the reference's
    # division), so kernel and plain version still agree there
    s, cap = 3, 5000
    edge = deposit.BLOCK_SMEM // 4
    rotating = (0.05, -0.1, 0.2)
    cases = [(bd, b, 256, 10.0) for bd in ("periodic", "absorb", "open")
             for b in (rotating, (0.0, 0.0, 0.0))]
    cases += [(bd, rotating, nc, 10.0 if nc == edge - 1 else float(nc))
              for bd in ("periodic", "absorb", "open")
              for nc in (edge - 1, edge)]
    for boundary, b, nc, length in cases:
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
        fargs = (x, v, w, alive, e, qm * dts, dts, charge)
        periodic = boundary == "periodic"
        for dep in (False, True):
            compare_fused(fused_cycle, fargs, dict(kw, deposit=dep),
                          length, periodic)
        compare_mover(mover, (x[0], v[0], alive[0], e),
                      dict(kw, qm_dt=-0.05, dt=0.05), length, periodic)
    xs = torch.rand(3000, generator=gen, device=dev) * 10.0
    qs = torch.rand(3000, generator=gen, device=dev)
    qs[::3] = 0.0
    compare_deposit(deposit, xs, qs, dict(x0=0.0, dx=10.0 / 512, nc=512))
    compare_deposit(deposit, xs, qs, dict(x0=0.0, dx=10.0 / (edge - 1),
                                          nc=edge - 1))
    compare_deposit(deposit, xs * (edge / 10.0), qs,
                    dict(x0=0.0, dx=1.0, nc=edge))
    m = 5000
    u = torch.randn(m, 3, generator=gen, device=dev)
    u[:40, :2] = 0.0                       # u along +z and -z
    u[:20, 2] = torch.rand(20, generator=gen, device=dev) + 0.5
    u[20:40, 2] = -torch.rand(20, generator=gen, device=dev) - 0.5
    delta = 0.5 * torch.randn(m, generator=gen, device=dev)
    delta[::7] = 0.0
    phi = torch.rand(m, generator=gen, device=dev) * (2 * torch.pi)
    compare_ta_kick(collide, u, delta, phi)
    log(f"kernels: ragged shapes (cap 5000, 3 boundaries x b on/off; the "
        f"deposit kernels at 257, 513, {edge} (block, dx = 10 / {edge - 1}) "
        f"and {edge + 1} (pair) nodes; 5000 deflection rows with u along z "
        f"and delta = 0) agree with their plain versions")

    # the main path's shapes: the §3.3 initial state, a non-zero field
    cfg = make_config(mover_strategy="fused")
    grid = cfg.grid
    state = pic.init_state(cfg, 7, device=dev)
    bx, bq = main_path_birth_inputs(cfg, state.species, dev)
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
    fms, _ = timed(f"fused push + deposit ({s}, {cap}) at {ng} nodes "
                   f"({deposit.deposit_form(ng)} form)",
                   lambda: fused_cycle.fused_push_deposit(*fargs, **fkw), bms)
    nbytes_nd = n_slots * (4 + 12 + 4 + 1 + 4 + 12 + 4 + 1 + 1 + 1) + ng * 4
    bnd, _ = bound_ms(nbytes_nd, n_slots * PUSH_FLOPS)
    nd_ms, _ = timed(f"fused without deposit ({s}, {cap})",
                     lambda: fused_cycle.fused_push_deposit(
                         *fargs, **dict(kw, deposit=False)), bnd)
    results["fused_push_deposit"] = dict(
        name="fused_push_deposit", route="cuda",
        source="src/repro_torch/csrc/fused_cycle.cu",
        replaces="src/repro/kernels/fused_cycle.py:37",
        max_abs_err=err, ms=fms, ms_no_deposit=nd_ms,
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

    # the deposits of the ionization step: the electron density over one
    # species, and (field on) the births of one step
    dkw = dict(x0=0.0, dx=grid.dx, nc=grid.nc)

    def index_add_ms(x, q):
        i, f = mover.cic(x, 0.0, grid.dx, grid.nc)
        idx = torch.cat([i, i + 1])
        upd = torch.cat([q * (1.0 - f), q * f])
        acc = torch.zeros(ng, device=dev)
        return median_ms(lambda: acc.zero_().index_add_(0, idx, upd), 20)

    dep_rows = {}
    for label, x, q in (("electron density", st.x[0],
                         st.w[0] * st.alive[0]), ("births", bx, bq)):
        err = compare_deposit(deposit, x, q, dkw)
        bms, by, nnz = deposit_bound(q, ng)
        dms, _ = timed(f"deposit {label} ({q.numel()} elements, {nnz} "
                       f"charged, {deposit.deposit_form(ng)} form)",
                       lambda: deposit.deposit(x, q, **dkw), bms)
        dep_rows[label] = dict(
            max_abs_err=err, ms=dms,
            plain_ms=median_ms(lambda: deposit.deposit_plain(x, q, **dkw),
                               5),
            bound_ms=bms, bound_by=by, library_ms=index_add_ms(x, q))
        r = dep_rows[label]
        log(f"deposit {label}: plain {r['plain_ms']:.4f} ms, index_add_ "
            f"{r['library_ms']:.4f} ms")
    results["deposit"] = dict(
        name="deposit", route="cuda", source="src/repro_torch/csrc/deposit.cu",
        replaces="src/repro/kernels/deposit.py:26",
        **dep_rows["electron density"])
    del bx, bq

    grid_lines(dev, deposit, fused_cycle, st, cfg, gen)

    # the Coulomb deflection of the collision path: the within-cell pairs
    # of the §3.3 electrons, one row per slot
    electrons = SpeciesBuffer(x=st.x[0], v=st.v[0], w=st.w[0],
                              alive=st.alive[0])
    targs = main_path_ta_inputs(electrons, cfg)
    rows = targs[0].shape[0]
    err = compare_ta_kick(collide, *targs)
    bms, by = bound_ms(rows * TA_BYTES, rows * TA_FLOPS)
    results["ta_kick"] = dict(
        name="ta_kick", route="cuda", source="src/repro_torch/csrc/collide.cu",
        replaces="src/repro/kernels/collide.py:36", max_abs_err=err,
        ms=median_ms(lambda: collide.ta_kick(*targs), 20),
        plain_ms=median_ms(lambda: collide.ta_kick_plain(*targs), 5),
        bound_ms=bms, bound_by=by, library_ms=None)
    log(f"ta_kick rows: {rows}, of which {int((targs[1] != 0).sum())} "
        f"with delta != 0")
    for r in results.values():
        extra = (f" (no deposit {r['ms_no_deposit']:.4f} ms)"
                 if "ms_no_deposit" in r else "")
        lib = (f", index_add_ {r['library_ms']:.4f} ms"
               if r["library_ms"] is not None else "")
        log(f"kernel {r['name']} at the main-path shape: max_abs_err "
            f"{r['max_abs_err']:.3g}, {r['ms']:.4f} ms{extra}, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}){lib}")
    del st, fargs, margs, electrons, targs
    torch.cuda.empty_cache()
    return results


def grid_lines(dev, deposit, fused_cycle, st, cfg, gen):
    """For information, held to the same gates: a per-domain grid of the
    engine at D = 4 (a quarter of the §3.3 slots on 25,600 cells, which fit
    one block: the block form) and a grid of 600,000 cells (the pair
    form)."""
    s, cap = st.x.shape
    f32 = torch.float32
    qm = torch.tensor([sc.charge / sc.mass for sc in cfg.species],
                      dtype=f32, device=dev)
    dts = torch.tensor([cfg.dt] * s, dtype=f32, device=dev)
    charge = torch.tensor([sc.charge for sc in cfg.species], dtype=f32,
                          device=dev)
    for label, nc, n in (("per-domain grid", 25_600, cap // 4),
                         ("large grid", 600_000, cap)):
        scale = nc / cfg.grid.nc
        x = (st.x[:, :n] * scale).contiguous()
        v, w = st.v[:, :n].contiguous(), st.w[:, :n].contiguous()
        alive = st.alive[:, :n].contiguous()
        e = 0.1 * torch.randn(nc + 1, generator=gen, device=dev)
        kw = dict(x0=0.0, dx=cfg.grid.dx, nc=nc, length=float(nc),
                  b=cfg.b_field, boundary=cfg.boundary, deposit=True)
        fargs = (x, v, w, alive, e, qm * dts, dts, charge)
        dkw = dict(x0=0.0, dx=cfg.grid.dx, nc=nc)
        q = w[0] * alive[0]
        compare_fused(fused_cycle, fargs, kw, float(nc), True)
        compare_deposit(deposit, x[0], q, dkw)
        form = deposit.deposit_form(nc + 1)
        nbytes = s * n * 44 + 2 * (nc + 1) * 4
        fb, _ = bound_ms(nbytes, s * n * (PUSH_FLOPS + DEPOSIT_FLOPS))
        timed(f"fused push + deposit, {label} ({s}, {n}) at {nc + 1} nodes "
              f"({form} form)",
              lambda: fused_cycle.fused_push_deposit(*fargs, **kw), fb)
        db, _, _ = deposit_bound(q, nc + 1)
        timed(f"deposit, {label} ({n} elements) at {nc + 1} nodes ({form} "
              f"form)", lambda: deposit.deposit(x[0], q, **dkw), db)
        del x, v, w, alive, fargs, q


# ---------------------------------------------------------------- phase 3 --

def launches(counters):
    """Each kernel's launch count and, for the two deposit kernels, its
    count by form ("fused_push_deposit/block", ...)."""
    out = {}
    for name, fn in counters.items():
        out[name] = fn.launches
        for attr, n in sorted(vars(fn).items()):
            if attr.startswith("launches_"):
                out[f"{name}/{attr.removeprefix('launches_')}"] = n
    return out


def reset_launches(counters):
    for fn in counters.values():
        for attr in list(vars(fn)):
            if attr.startswith("launches"):
                setattr(fn, attr, 0)


def expected(form, fused=0, fused_dep=0, mover=0, deposit=0, ta=0):
    """Launches a step: totals, and the deposit kernels' launches by form,
    all of them in ``form`` (fused_dep of the fused kernel's launches carry
    a deposit)."""
    from repro_torch.kernels.deposit import FORMS

    out = {"fused_push_deposit": fused, "mover_push": mover,
           "deposit": deposit, "ta_kick": ta}
    for name, n in (("fused_push_deposit", fused_dep), ("deposit", deposit)):
        for f in FORMS:
            out[f"{name}/{f}"] = n if f == form else 0
    return out


def ke64(cfg, species):
    """Kinetic energy of each species in float64."""
    return {sc.name: 0.5 * sc.mass * float(
        (b.w.double() * b.alive * (b.v.double() ** 2).sum(-1)).sum())
        for sc, b in zip(cfg.species, species)}


def drive(cfg, steps, label, counters, per_step, dev, seed=0):
    """Run ``steps`` steps through make_step and check the step's contract:
    exact pair accounting with ionization, constant counts without it, the
    collision menu's counters and energy invariants, finite energies, the
    launches of each kernel. Returns (steady ms/step, launches)."""
    from repro_torch.core import pic

    torch.cuda.reset_peak_memory_stats(dev)
    state = pic.init_state(cfg, seed, device=dev)
    step = pic.make_step(cfg)
    n0 = [int(b.count()) for b in state.species]
    # the push leaves v alone with the field off: only the menu moves KE
    check_ke = (bool(cfg.collisions) and cfg.ionization is None
                and not cfg.field_solve)
    ke0 = ke64(cfg, state.species) if check_ke else None
    ionized = 0
    colls = dict.fromkeys(COLL_KEYS, 0) if cfg.collisions else {}
    times = []
    reset_launches(counters)
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
        ionized += int(diag.get("n_ionized", 0))
        for key in colls:
            if int(diag[key]) <= 0:
                raise AssertionError(f"{label} step {k}: {key} = 0")
            colls[key] += int(diag[key])
        for sc in cfg.species:
            if not bool(torch.isfinite(diag[f"{sc.name}/ke"])):
                raise AssertionError(f"{label}: non-finite {sc.name}/ke")
        if cfg.field_solve and not bool(torch.isfinite(diag["field_energy"])):
            raise AssertionError(f"{label}: non-finite field energy")
    counts = launches(counters)
    ne, ni, nn = (int(b.count()) for b in state.species)
    if cfg.ionization is None:
        if [ne, ni, nn] != n0:
            raise AssertionError(f"{label}: counts moved {n0} -> "
                                 f"{[ne, ni, nn]}")
    else:
        if not (ne - n0[0] == ni - n0[1] == ionized == n0[2] - nn):
            raise AssertionError(
                f"{label}: pair accounting broken: e {n0[0]}->{ne}, D+ "
                f"{n0[1]}->{ni}, D {n0[2]}->{nn}, ionized {ionized}")
        if ionized <= 0:
            raise AssertionError(f"{label}: no ionization in {steps} steps")
    extra = ""
    if check_ke:
        # elastic and e-e Coulomb keep the electron KE, charge exchange the
        # D+ + D sum
        ke1 = ke64(cfg, state.species)
        re = abs(ke1["e"] - ke0["e"]) / ke0["e"]
        rh = (abs(ke1["D+"] + ke1["D"] - ke0["D+"] - ke0["D"])
              / (ke0["D+"] + ke0["D"]))
        if not (re <= 2e-4 and rh <= 2e-4):
            raise AssertionError(f"{label}: KE not kept: e rel {re}, "
                                 f"D+ + D rel {rh}")
        extra = (f", collisions {colls}, KE rel change e {re:.3g} "
                 f"D+ + D {rh:.3g}")
    steady = statistics.median(times[1:]) if steps > 1 else times[0]
    log(f"main path {label}: {steps} steps, ms/step "
        f"{[round(t, 3) for t in times]}"
        f" (median after the first {steady:.3f}), ionized {ionized}, "
        f"populations e {ne} D+ {ni} D {nn}{extra}; launches {counts}; "
        f"peak memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} "
        f"GiB")
    del state
    torch.cuda.empty_cache()
    return steady, counts


def collision_config(strategy="fused"):
    """The §3.3 configuration with the collision menu on and ionization
    off, as ``make_collision_config`` chooses, at the published widths;
    the Coulomb pairs deflect through the kernel."""
    from repro_torch.configs.pic_bit1 import make_collision_menu, make_config

    return dataclasses.replace(
        make_config(mover_strategy=strategy), ionization=None,
        collisions=make_collision_menu(), collide_kernel=True)


def run_launcher(argv, counters, label):
    from repro_torch.launch import pic_run

    reset_launches(counters)
    pic_run.main(argv)
    counts = launches(counters)
    log(f"main path {label}: launches {counts}")
    return counts


def main_path_phase(dev):
    from repro_torch.configs.pic_bit1 import make_config
    from repro_torch.kernels import collide, deposit, fused_cycle, mover

    counters = {"fused_push_deposit": fused_cycle.fused_push_deposit,
                "mover_push": mover.mover_push, "deposit": deposit.deposit,
                "ta_kick": collide.ta_kick}
    ms, paths = {}, {}
    cfg = make_config(mover_strategy="fused")
    # the form of the §3.3 grid; every deposit of every path below must
    # launch in it
    form = deposit.deposit_form(cfg.nc + 1)
    ms["fused"], paths["fused"] = drive(
        cfg, 5, "fused (field solve off)", counters,
        expected(form, fused=1, deposit=1), dev)
    ms["fused_field"], paths["fused_field"] = drive(
        dataclasses.replace(cfg, field_solve=True), 5,
        "fused + field solve (rho carried)", counters,
        expected(form, fused=1, fused_dep=1, deposit=2), dev)
    ms["explicit"], paths["explicit"] = drive(
        make_config(mover_strategy="explicit"), 3, "explicit",
        counters, expected(form, mover=3, deposit=1), dev)
    ms["collisions"], paths["collisions"] = drive(
        collision_config(), 3, "collisions (menu + T-A kernel, field off)",
        counters, expected(form, fused=1, ta=1), dev)
    paths["pic_run"] = run_launcher(
        ["--nc", "102400", "--particles", "10485760", "--strategy",
         "fused", "--steps", "3"], counters, "pic_run")
    if paths["pic_run"]["fused_push_deposit"] != 3:
        raise AssertionError("pic_run did not run the fused kernel per step")
    # the reference launcher deflects through ta_kick_ref, and so does the
    # port's: no ta_kick launch here
    paths["pic_run_collisions"] = run_launcher(
        ["--nc", "102400", "--particles", "10485760", "--strategy",
         "fused", "--steps", "2", "--collisions", "elastic,cx,coulomb"],
        counters, "pic_run --collisions")
    if (paths["pic_run_collisions"]["fused_push_deposit"] != 2
            or paths["pic_run_collisions"]["ta_kick"] != 0):
        raise AssertionError("pic_run --collisions: unexpected launches "
                             f"{paths['pic_run_collisions']}")
    counts = {name: sum(p[name] for p in paths.values())
              for name in paths["fused"]}
    for name, c in counts.items():
        main = "/" not in name or name.endswith("/" + form)
        if main and c <= 0:
            raise AssertionError(f"kernel {name} never launched on the main "
                                 f"paths")
        if not main and c:
            raise AssertionError(f"{name}: {c} launches on the main paths, "
                                 f"whose grid takes the {form} form")
    log(f"main path launches, summed over the paths: {counts}")
    return counts, ms


# ---------------------------------------------------------------- phase 4 --

def profile_phase(dev, cfg, label, step_ms, steps):
    """Where a step of ``cfg`` spends device time: ``steps`` steps under
    torch.profiler after one warm step, device time by operator and by
    kernel. ``step_ms`` is the unprofiled step time of phase 3, for the
    device's busy share."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import pic

    state = pic.init_state(cfg, 3, device=dev)
    step = pic.make_step(cfg)
    state, _ = step(state)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            state, _ = step(state)
        torch.cuda.synchronize()
    report_profile(prof, f"a {label} step", steps, step_ms)
    del state
    torch.cuda.empty_cache()


def report_profile(prof, label, reps, host_ms):
    """Device time by operator and by kernel, per repetition, and the
    device's busy share of ``host_ms`` (the unprofiled host-clock time of
    one repetition)."""
    from torch.autograd import DeviceType

    # device kernels carry the device time; the aten ops that launched
    # them carry the same time again as their self device time, and so do
    # the engine's record_function ranges (engine/..., halo/...)
    kernels, ops = [], []
    for e in prof.key_averages():
        if e.key.startswith(("engine/", "halo/")):
            continue
        if e.self_device_time_total > 0:
            row = (e.self_device_time_total / (1e3 * reps),
                   e.count / reps, e.key)
            (ops if e.device_type == DeviceType.CPU else kernels).append(row)
    if not kernels:
        log(f"profile of {label}: the profiler recorded no device time (not "
            f"measured)")
        return
    busy = sum(r[0] for r in kernels)
    log(f"profile of {label}: device busy {busy:.3f} ms of "
        f"{host_ms:.3f} ms ({100 * busy / host_ms:.1f} %), "
        f"{sum(r[1] for r in kernels):.0f} kernels")
    for title, rows in (("by operator", ops), ("by kernel", kernels)):
        log(f"  device ms {title}:")
        for ms, count, name in sorted(rows, reverse=True)[:12]:
            log(f"  {ms:8.3f} ms  x{count:4.0f}  {name[:90]}")


# ---------------------------------------------------------------- phase 5 --

def card_vs_cpu_phase(dev):
    import numpy as np

    from repro_torch.configs.pic_bit1 import make_bench_config
    from repro_torch.core import pic
    from repro_torch.kernels import deposit, fused_cycle

    cfg = dataclasses.replace(make_bench_config(strategy="fused"),
                              field_solve=True)
    # the bench grid fits one block: both deposit kernels in the block form
    counters = {"fused_push_deposit": fused_cycle.fused_push_deposit,
                "deposit": deposit.deposit}
    reset_launches(counters)
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
    counts = launches(counters)
    form = deposit.deposit_form(cfg.nc + 1)
    if not all(0 < counts[f"{k}/{form}"] == counts[k] for k in counters):
        raise AssertionError(f"card vs CPU at {cfg.nc + 1} nodes: launches "
                             f"{counts}, expected every deposit in the "
                             f"{form} form")
    log(f"card vs CPU at {cfg.nc + 1} nodes ({form} form): launches {counts}")


def collision_card_vs_cpu_phase(dev):
    """The collision menu with the deflection kernel, card against CPU.
    Pairs follow cells, and one ulp in v can move a particle across a cell
    and reshuffle its cell's pairs, so every step starts the card from a
    copy of the CPU's state; with the field off the push is bitwise equal
    on both, and so are the cells and the pairs."""
    import numpy as np

    from repro_torch.configs.pic_bit1 import make_collision_config
    from repro_torch.core import pic

    cfg = dataclasses.replace(make_collision_config(strategy="fused"),
                              collide_kernel=True)
    cpu = pic.init_state(cfg, 13, device="cpu")
    rng = np.random.default_rng(6)
    caps = [sc.capacity for sc in cfg.species]
    length = cfg.length
    f32 = np.float32

    def draws_for(cc):
        if cc.kind == "elastic":
            c = caps[cc.species]
            return {"uniform": rng.random(c, dtype=f32),
                    "cos": (2 * rng.random(c, dtype=f32) - 1).astype(f32),
                    "phi": (2 * np.pi * rng.random(c)).astype(f32)}
        if cc.kind == "charge_exchange":
            return {"uniform": rng.random(caps[cc.species], dtype=f32),
                    "shuffle": rng.random(caps[cc.partner], dtype=f32)}
        c = caps[cc.species]
        return {"shuffle": rng.random(c, dtype=f32),
                "normal": rng.standard_normal(c, dtype=f32),
                "phi": (2 * np.pi * rng.random(c)).astype(f32)}

    for k in range(3):
        arrays = [{"x": b.x.numpy(), "v": b.v.numpy(), "w": b.w.numpy(),
                   "alive": b.alive.numpy()} for b in cpu.species]
        card = pic.state_from_numpy(cfg, arrays, cpu.step, device=dev)
        draws = [draws_for(cc) for cc in cfg.collisions]
        cpu, dc = pic.step_fn(cpu, cfg, draws=draws)
        card, dg = pic.step_fn(card, cfg, draws=draws)
        for key in COLL_KEYS + ("e/count", "D+/count", "D/count"):
            if int(dc[key]) != int(dg[key]):
                raise AssertionError(f"collisions card vs CPU step {k}: "
                                     f"{key} {int(dg[key])} != "
                                     f"{int(dc[key])}")
        ex = ev = 0.0
        for bc, bg in zip(cpu.species, card.species):
            check_equal(f"collisions card vs CPU alive step {k}",
                        bg.alive.cpu(), bc.alive)
            ex = max(ex, periodic_err(bg.x.cpu(), bc.x, length))
            vmax = float(bc.v.abs().max())
            ev = max(ev, max_err(bg.v.cpu(), bc.v) / (1.0 + vmax))
        if ex > 1e-6 * length or ev > 1e-5:
            raise AssertionError(f"collisions card vs CPU step {k}: x {ex}, "
                                 f"v {ev} (of 1+max|v|)")
        log(f"collisions card vs CPU step {k}: counts and alive equal, "
            f"{ {key: int(dg[key]) for key in COLL_KEYS} }, max |dx| "
            f"{ex:.3g}, max |dv|/(1+max|v|) {ev:.3g}")


# ---------------------------------------------------------------- phase 6 --

def attention_pairs(sq: int, skv: int, causal: bool, window: int) -> int:
    """The (query, key) pairs the mask lets through: the work this input
    needs, whatever tiles a kernel computes."""
    qpos = torch.arange(sq, dtype=torch.int64)
    hi = torch.clamp(qpos, max=skv - 1) if causal else torch.full_like(
        qpos, skv - 1)
    lo = torch.clamp(qpos - window + 1, min=0) if window > 0 else \
        torch.zeros_like(qpos)
    return int(torch.clamp(hi - lo + 1, min=0).sum())


def compare_flash(fa, q, k, v, causal, window, label):
    """Kernel vs plain on the same inputs, elementwise within FLASH_TOL of
    the input dtype; returns the max abs error."""
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    want = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    rtol, atol = FLASH_TOL[q.dtype]
    g, w = got.float(), want.float()
    if got.shape != q.shape or got.dtype != q.dtype:
        raise AssertionError(f"flash {label}: {got.shape} {got.dtype}")
    if not bool(torch.isfinite(g).all()):
        raise AssertionError(f"flash {label}: non-finite output")
    bad = int(((g - w).abs() > atol + rtol * w.abs()).sum())
    if bad:
        raise AssertionError(f"flash {label}: {bad} entries differ from the "
                             f"plain version by more than atol {atol} + "
                             f"rtol {rtol:.4g} (max "
                             f"{max_err(g, w)})")
    return max_err(g, w)


def flash_phase(dev):
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    gen = torch.Generator(device=dev).manual_seed(4321)

    def qkv(b, sq, skv, h, kvh, d, dtype):
        return tuple(torch.randn(b, s, n, d, generator=gen, device=dev)
                     .to(dtype) for s, n in ((sq, h), (skv, kvh), (skv, kvh)))

    # ragged: (B, Sq, Skv, H, KVH, D, causal, window)
    cases = [(2, 1000, 1000, 4, 2, 64, True, 0),
             (2, 384, 1024, 8, 1, 128, True, 0),
             (1, 1000, 1000, 14, 2, 64, True, 128),
             (1, 777, 777, 4, 4, 256, True, 256),
             (1, 640, 700, 28, 4, 128, True, 0),
             (1, 333, 333, 16, 2, 128, True, 0),
             (2, 500, 700, 4, 4, 256, False, 0),
             (1, 300, 300, 4, 2, 16, True, 0),
             (1, 300, 300, 4, 4, 32, True, 0),
             # queries past Skv + window: rows that see no key at all
             (1, 200, 90, 2, 1, 64, True, 16)]
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        for c in cases:
            *shape, causal, window = c
            err = compare_flash(fa, *qkv(*shape, dtype), causal, window,
                                f"{c} {dtype}")
            worst[dtype] = max(worst.get(dtype, 0.0), err)
        # the reference kernel's head-folded signature, through ops
        q, k, v = (torch.randn(6, 640, 64, generator=gen, device=dev)
                   .to(dtype) for _ in range(3))
        for causal in (True, False):
            got = ops.flash_attention(q, k, v, causal=causal)
            want = fa.flash_attention_plain(
                q.unsqueeze(2), k.unsqueeze(2), v.unsqueeze(2),
                causal=causal).squeeze(2)
            rtol, atol = FLASH_TOL[dtype]
            if not torch.allclose(got.float(), want.float(), rtol=rtol,
                                  atol=atol):
                raise AssertionError(f"flash (bh, s, hd) {dtype} causal="
                                     f"{causal}")
    log(f"flash: {len(cases)} ragged shapes and the (bh, s, hd) signature "
        f"agree with the plain version, max abs err f32 "
        f"{worst[torch.float32]:.3g}, bf16 {worst[torch.bfloat16]:.3g}")

    # the main path's shape: one layer of the qwen2-0.5b prefill
    cfg = get_config(LM_ARCH)
    b, s, h, kvh, d = 8, 4096, cfg.n_heads, cfg.kv_heads, cfg.hd
    err32 = compare_flash(fa, *qkv(b, s, s, h, kvh, d, torch.float32), True,
                          0, "main shape f32")
    q, k, v = qkv(b, s, s, h, kvh, d, cfg.dtype)
    err = compare_flash(fa, q, k, v, True, 0, "main shape bf16")
    r = dict(name="flash_attention", route="cuda",
             source="src/repro_torch/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:33",
             max_abs_err=err,
             plain_ms=median_ms(lambda: fa.flash_attention_plain(q, k, v), 5),
             **time_flash(fa, q, k, v))
    log(f"kernel flash_attention at the main-path shape (B {b}, S {s}, H "
        f"{h}, KVH {kvh}, D {d}, causal, bf16): max_abs_err {err:.3g} (f32 "
        f"{err32:.3g}), {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
        f"{r['bound_ms']:.4f} ms ({r['bound_by']}: {r['gflop']:.1f} GFLOP, "
        f"{r['g_exp']:.3f} G exponentials, {r['mb']:.1f} MB), "
        f"scaled_dot_product_attention {r['library_ms']:.4f} ms")
    del q, k, v
    torch.cuda.empty_cache()

    # one layer of the other configs' head shapes, for information
    for arch, b in (("qwen2-7b", 2), ("gemma-7b", 1)):
        c = get_config(arch)
        q, k, v = qkv(b, s, s, c.n_heads, c.kv_heads, c.hd, c.dtype)
        e = compare_flash(fa, q, k, v, True, 0, f"{arch} layer")
        t = time_flash(fa, q, k, v)
        log(f"flash one {arch} layer (B {b}, S {s}, H {c.n_heads}, KVH "
            f"{c.kv_heads}, D {c.hd}, causal, bf16): max_abs_err {e:.3g}, "
            f"{t['ms']:.4f} ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']}"
            f"), scaled_dot_product_attention {t['library_ms']:.4f} ms")
        del q, k, v
        torch.cuda.empty_cache()
    return {key: r[key] for key in (
        "name", "route", "source", "replaces", "max_abs_err", "ms",
        "plain_ms", "bound_ms", "bound_by", "library_ms")}


def time_flash(fa, q, k, v):
    """Causal flash on (B, S, H, D) inputs by CUDA events, beside its
    compute bound and SDPA on the same tensors."""
    b, s, h, d = q.shape
    pairs = b * h * attention_pairs(s, k.shape[1], True, 0)
    nbytes = q.element_size() * (2 * q.numel() + k.numel() + v.numel())
    bms, by = bound_ms(nbytes, 4 * d * pairs, BF16_FLOPS)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return dict(ms=median_ms(lambda: fa.flash_attention(q, k, v), 20),
                library_ms=median_ms(lambda: sdpa(qt, kt, vt, is_causal=True,
                                                  enable_gqa=True), 20),
                bound_ms=bms, bound_by=by, gflop=4 * d * pairs / 1e9,
                g_exp=pairs / 1e9, mb=nbytes / 1e6)


def flash_build_phase(build_dir):
    """What the compiler made of each flash instantiation: registers, spills
    and shared memory; fails if a bf16 (tensor-core) instantiation spills or
    holds no HGMMA (wgmma) instruction in its SASS."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa

    def short(mangled):
        m = re.search(r"(flash_(?:wgmma_)?kernel)I((?:Li\d+E)+)E", mangled)
        args = ", ".join(re.findall(r"Li(\d+)E", m.group(2)))
        return f"{m.group(1)}<{args}>"

    spills, fn = {}, None
    for line in (build_dir / "flash_attention.log").read_text().splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = short(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and fn:
            spills[fn] = (int(m.group(1)), int(m.group(2)))
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass",
                           str(build_dir / "libflash_attention.so")],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    hgmma, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = short(m.group(1))
            hgmma[fn] = 0
        elif fn and re.search(r"\bHGMMA\b", line):
            hgmma[fn] += 1
    for dtype in (torch.bfloat16, torch.float32):
        for d in fa.HEAD_DIMS:
            a = fa.kernel_attributes(d, dtype)
            name = (f"flash_wgmma_kernel<{d}>" if dtype == torch.bfloat16 else
                    f"flash_kernel<{d}, {fa.BLOCK_K[(dtype, d)]}>")
            st, ld = spills[name]
            log(f"  {name}: {a['registers']} registers, spill stores {st} B "
                f"loads {ld} B, local {a['local_bytes']} B, shared "
                f"{a['static_smem']} B static + {a['dynamic_smem']} B "
                f"dynamic, {hgmma[name]} HGMMA in its SASS")
            if dtype == torch.bfloat16 and (st or ld or not hgmma[name]):
                raise AssertionError(f"{name}: spills {st}/{ld} B, "
                                     f"{hgmma[name]} HGMMA instructions")


# the kernels of csrc/fused_cycle.cu and csrc/deposit.cu, by their
# mangled names: the name, then the template arguments
PIC_KERNEL = re.compile(r"\d+(fused_block_kernel|deposit_block_kernel|"
                        r"fused_push_deposit_kernel|deposit_kernel|"
                        r"sum_rows_kernel|pair_finish_kernel)(I?)")
# an atomic or reduction instruction of the SASS, after its address and
# predicate; REDUX (a warp reduction) is not one
SASS_ATOMIC = re.compile(r"/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?"
                         r"((?:ATOM|RED)(?!UX)[A-Z]*(?:\.[A-Za-z0-9_]+)*)")


def pic_kernel_name(mangled: str) -> str | None:
    """``fused_block_kernel<0, false>`` from its mangled name: int and bool
    template arguments, and type names (length-prefixed, or f)."""
    m = PIC_KERNEL.search(mangled)
    if not m:
        return None
    if not m.group(2):
        return m.group(1)
    rest, args = mangled[m.end():], []
    while rest and rest[0] != "E":
        if rest.startswith("Li"):
            value, rest = rest[2:].split("E", 1)
            args.append(value)
        elif rest.startswith("Lb"):
            args.append("true" if rest[2] == "1" else "false")
            rest = rest[4:]
        elif rest[0].isdigit():
            digits = re.match(r"\d+", rest).group()
            end = len(digits) + int(digits)
            args.append(rest[len(digits):end])
            rest = rest[end:]
        else:
            args.append({"f": "float"}.get(rest[0], rest[0]))
            rest = rest[1:]
    return f"{m.group(1)}<{', '.join(args)}>"


def atomic_space(opcode: str) -> str:
    """The memory space of a SASS atomic: ATOMS shared, ATOMG/REDG global,
    ATOM/RED generic (the address picks the window)."""
    base = opcode.split(".")[0]
    return {"ATOMS": "shared", "ATOMG": "global", "REDG": "global",
            "ATOM": "generic", "RED": "generic"}.get(base, base)


def check_pic_atomics(name, atomics, by_space):
    """The gates on one instance's atomics: a deposit in L2 adds by float2
    reductions only, a block instance only in shared memory, and a launch
    without a deposit adds nothing."""
    pair = (name == "deposit_kernel"
            or re.fullmatch(r"fused_push_deposit_kernel<\d, \w+, true>", name))
    if pair and (set(by_space) != {"global"} or any(
            not re.search(r"F32x2", op) for op in atomics)):
        raise AssertionError(f"{name}: adds {atomics}, not float2 "
                             f"reductions in L2")
    if "block_kernel" in name and set(by_space) != {"shared"}:
        raise AssertionError(f"{name}: atomics {atomics} outside shared "
                             f"memory")
    if re.fullmatch(r"fused_push_deposit_kernel<\d, \w+, false>", name) and (
            atomics):
        raise AssertionError(f"{name}: atomics {atomics} without a deposit")


def pic_build_phase(build_dir):
    """What the compiler made of each instance of the two deposit kernels
    (csrc/fused_cycle.cu, csrc/deposit.cu): spills, every atomic
    instruction of its SASS by opcode and memory space, and for a block
    instance its registers, shared memory, and the blocks that fit at an
    engine domain's grid (25,601 nodes) and at the largest block grid. Fails
    if an instance spills or breaks ``check_pic_atomics``."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import deposit as dep

    grids = (25_601, dep.BLOCK_SMEM // 4)
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    for src in ("fused_cycle", "deposit"):
        spills, fn = {}, None
        for line in (build_dir / f"{src}.log").read_text().splitlines():
            m = re.search(r"Function properties for (\S+)", line)
            if m:
                fn = pic_kernel_name(m.group(1))
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m and fn:
                spills[fn] = (int(m.group(1)), int(m.group(2)))
        sass = subprocess.run([str(cuobjdump), "-sass",
                               str(build_dir / f"lib{src}.so")],
                              capture_output=True, text=True, check=True,
                              timeout=300).stdout
        atomics, fn = {}, None
        for line in sass.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                fn = pic_kernel_name(m.group(1)) or m.group(1)
                atomics[fn] = {}
                continue
            m = SASS_ATOMIC.search(line)
            if m and fn:
                atomics[fn][m.group(1)] = atomics[fn].get(m.group(1), 0) + 1
        for name in sorted(atomics):
            st, ld = spills.get(name, (0, 0))
            by_space = {}
            for op, c in atomics[name].items():
                by_space[atomic_space(op)] = by_space.get(
                    atomic_space(op), 0) + c
            line = (f"  {name}: spill stores {st} B loads {ld} B; atomics "
                    f"{by_space or 'none'} {atomics[name]}")
            check_pic_atomics(name, atomics[name], by_space)
            if "block_kernel" in name:
                key = tuple(1 if a == "true" else 0 if a == "false"
                            else int(a) for a in re.findall(
                                r"true|false|\d+", name.partition("<")[2]))
                for ng in grids:
                    a = dep.block_info(src, key, ng)
                    line += (f"; {a['registers']} registers, local "
                             f"{a['local_bytes']} B, shared "
                             f"{a['static_smem']} B static + {4 * ng} B "
                             f"dynamic: {a['max_blocks']} blocks fit")
                    if a["local_bytes"]:
                        raise AssertionError(
                            f"{name}: local {a['local_bytes']} B")
            log(line)
            if st or ld:
                raise AssertionError(f"{name} spills {st}/{ld} B")


# ---------------------------------------------------------------- phase 9 --

# the engine phase's runs at the §3.3 configuration: (domains, async_n)
ENGINE_RUNS = ((1, 1), (4, 1), (4, 4))
# births a domain a step: the §3.3 step births about 21,700 pairs, so
# 8,192 would overflow at D = 1; 32,768 divides by every async_n here
ENGINE_MAX_BIRTHS = 32_768
ENGINE_MAX_MIGRATION = 8_192
ENGINE_STEPS = 5


def engine_config(d, n_q, cfg=None, **kw):
    """EngineConfig of the §3.3 configuration (field solve on, rho carried,
    ionization on) unless ``cfg`` is given."""
    from repro_torch.configs.pic_bit1 import make_config, make_engine_config

    if cfg is None:
        cfg = dataclasses.replace(make_config(mover_strategy="fused"),
                                  field_solve=True)
    return make_engine_config(cfg, domains=d, async_n=n_q,
                              max_migration=ENGINE_MAX_MIGRATION,
                              max_births=ENGINE_MAX_BIRTHS, **kw)


def engine_launches(ecfg):
    """Launches a step of the engine, from its design: the fused kernel
    once a queue a domain (with a deposit when rho is carried), the
    deposit kernel for the electron density once a domain (ionization
    on), for the leavers once a queue a domain and for the merged rows
    once a domain (rho carried), and the deflection kernel once a queue a
    domain a Coulomb entry (with ``collide_kernel``); every deposit in the
    form of a domain's grid."""
    from repro_torch.distributed import engine
    from repro_torch.kernels.deposit import deposit_form

    cfg = ecfg.pic
    d, n_q = ecfg.domains, ecfg.async_n
    carried = engine._carries_rho(ecfg)
    queues = d * n_q
    dep = ((d if cfg.ionization is not None else 0)
           + (queues + d if carried else 0))
    coulomb = sum(cc.kind == "coulomb" for cc in cfg.collisions)
    return expected(deposit_form(ecfg.local_nc() + 1), fused=queues,
                    fused_dep=queues if carried else 0, deposit=dep,
                    ta=queues * coulomb if cfg.collide_kernel else 0)


def resident_counts(state):
    """Per-species resident + pending rows of an engine state."""
    out = []
    for i, b in enumerate(state.species):
        n = int(b.alive.sum())
        for g, idxs in enumerate(state.group_species):
            if i in idxs and state.pending:
                n += int(state.pending[g].alive[:, idxs.index(i)].sum())
        out.append(n)
    return out


def drive_engine(ecfg, steps, label, counters, dev, seed=0):
    """``steps`` engine steps with the launches of each pinned to
    ``engine_launches``; exact pair accounting (ionization) or constant
    counts, every overflow counter 0, integer charge totals equal to the
    counts (weight 1), finite energies, the collision counters > 0 where
    the menu is on. Returns (state, steady ms/step, launches, last diag,
    sums of the event counters)."""
    from repro_torch.distributed import engine

    cfg = ecfg.pic
    per_step = engine_launches(ecfg)
    torch.cuda.reset_peak_memory_stats(dev)
    state = engine.init_engine_state(ecfg, seed, device=dev)
    step = engine.make_engine_step(ecfg)
    n0 = resident_counts(state)
    sums: dict = {}
    times = []
    reset_launches(counters)
    diag = {}
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
        for key, v in diag.items():
            tail = key.rsplit("/", 1)[-1]
            if tail in ("n_ionized", "birth_overflow", "migration_overflow",
                        "merge_dropped", "migrated_left", "migrated_right",
                        "coll_elastic", "coll_cx", "coll_coulomb"):
                sums[key] = sums.get(key, 0) + int(v)
                if tail in ("birth_overflow", "migration_overflow",
                            "merge_dropped") and int(v):
                    raise AssertionError(f"{label} step {k}: {key} = "
                                         f"{int(v)}")
        for key in COLL_KEYS if cfg.collisions else ():
            if int(diag[key]) <= 0:
                raise AssertionError(f"{label} step {k}: {key} = 0")
        for sc in cfg.species:
            if not bool(torch.isfinite(diag[f"{sc.name}/ke"])):
                raise AssertionError(f"{label}: non-finite {sc.name}/ke")
            if float(diag[f"{sc.name}/charge"]) != (
                    sc.charge * int(diag[f"{sc.name}/count"])):
                raise AssertionError(f"{label}: {sc.name} charge "
                                     f"{float(diag[f'{sc.name}/charge'])} "
                                     f"is not charge x count")
    counts = [int(diag[f"{sc.name}/count"]) for sc in cfg.species]
    if counts != resident_counts(state):
        raise AssertionError(f"{label}: diag counts {counts} != resident + "
                             f"pending {resident_counts(state)}")
    ionized = sums.get("n_ionized", 0)
    if cfg.ionization is not None:
        ne, ni, nn = counts
        if not (ne - n0[0] == ni - n0[1] == ionized == n0[2] - nn
                and ionized > 0):
            raise AssertionError(
                f"{label}: pair accounting broken: e {n0[0]}->{ne}, D+ "
                f"{n0[1]}->{ni}, D {n0[2]}->{nn}, ionized {ionized}")
    elif counts != n0:
        raise AssertionError(f"{label}: counts moved {n0} -> {counts}")
    steady = statistics.median(times[1:]) if steps > 1 else times[0]
    log(f"engine {label}: {steps} steps, ms/step "
        f"{[round(t, 3) for t in times]} (median after the first "
        f"{steady:.3f}), populations {counts}, sums {sums}; launches a step "
        f"{per_step}; peak memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    return state, steady, launches(counters), diag, sums


def trace_intervals(path):
    """(start µs, end µs, stream) of every kernel, copy and memset of a
    chrome trace written by torch.profiler."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    out = []
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy",
                                                  "gpu_memset"):
            stream = e.get("args", {}).get("stream", e.get("tid"))
            out.append((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                        stream))
    return out


def busy_and_overlap(intervals):
    """(busy µs: the union of the intervals, overlap µs: the time two or
    more streams run at once, the streams seen)."""
    edges = sorted([(s, 1, st) for s, _, st in intervals]
                   + [(e, -1, st) for _, e, st in intervals],
                   key=lambda t: (t[0], t[1]))
    active: dict = {}
    busy = overlap = 0.0
    last = None
    for t, kind, st in edges:
        if last is not None:
            live = [s for s, c in active.items() if c > 0]
            if live:
                busy += t - last
            if len(live) > 1:
                overlap += t - last
        active[st] = active.get(st, 0) + kind
        last = t
    return busy, overlap, len({st for _, _, st in intervals})


def trace_overlap(fn, label):
    """(busy, overlap, streams) in µs of the device events a
    torch.profiler trace records around ``fn()``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = ROOT / "build" / "traces"
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"trace_{label}.json"
    prof.export_chrome_trace(str(path))
    iv = trace_intervals(path)
    path.unlink()
    return prof, iv


def trace_calibration():
    """Whether the profiler's trace shows concurrent kernels as such: two
    spin kernels on two streams, each ~2.5 ms, run at once on the card.
    Returns the overlap the trace shows, in ms."""
    a, b = torch.cuda.Stream(), torch.cuda.Stream()

    def two():
        with torch.cuda.stream(a):
            torch.cuda._sleep(SLEEP_CYCLES)
        with torch.cuda.stream(b):
            torch.cuda._sleep(SLEEP_CYCLES)

    two()
    torch.cuda.synchronize()
    _, iv = trace_overlap(two, "calibration")
    busy, overlap, n = busy_and_overlap(iv)
    log(f"trace calibration: two spin kernels on two streams: busy "
        f"{busy / 1e3:.3f} ms, overlap {overlap / 1e3:.3f} ms in the trace "
        f"({len(iv)} events on {n} streams)")
    return overlap / 1e3


def profile_engine(ecfg, state, label, host_ms, steps=2):
    """Device busy of an engine step and the time kernels on different
    streams overlap, from a torch.profiler trace of ``steps`` steps; device
    time by kernel beside ``host_ms``, the unprofiled step. Returns (busy
    ms, overlap ms) a step."""
    from repro_torch.distributed import engine

    step = engine.make_engine_step(ecfg)
    state, _ = step(state)
    torch.cuda.synchronize()
    box = [state]

    def run():
        for _ in range(steps):
            box[0], _ = step(box[0])

    prof, iv = trace_overlap(run, f"engine_{label}")
    if not iv:
        log(f"profile of an engine step {label}: no device events in the "
            f"trace (not measured)")
        return None, None
    busy, overlap, n_streams = busy_and_overlap(iv)
    kernel_sum = sum(e - s for s, e, _ in iv)
    log(f"profile of an engine step {label}: device busy "
        f"{busy / 1e3 / steps:.3f} ms a step (kernels, copies and memsets "
        f"{kernel_sum / 1e3 / steps:.3f} ms summed over {n_streams} "
        f"streams; {overlap / 1e3 / steps:.3f} ms with two or more streams "
        f"running), {len(iv) / steps:.0f} device events a step")
    report_profile(prof, f"an engine step {label}", steps, host_ms)
    return busy / 1e3 / steps, overlap / 1e3 / steps


def engine_kernel_times(dev):
    """Device ms of the kernels at the engine's D = 4 shapes, beside their
    bounds: the queue push (fused + deposit) at async_n 1 and 4, and the
    small deposits of the leavers (a queue) and of the merged rows (a
    domain), with the charged rows an engine step gives them."""
    from repro_torch.configs.pic_bit1 import make_config
    from repro_torch.kernels import deposit, fused_cycle

    cfg = make_config(mover_strategy="fused")
    gen = torch.Generator(device=dev).manual_seed(99)
    f32 = torch.float32
    s, cap_l, nc = 3, cfg.species[0].capacity // 4, cfg.nc // 4
    ng = nc + 1
    length = float(nc)
    qm = torch.tensor([sc.charge / sc.mass for sc in cfg.species],
                      dtype=f32, device=dev)
    dts = torch.tensor([cfg.dt] * s, dtype=f32, device=dev)
    charge = torch.tensor([sc.charge for sc in cfg.species], dtype=f32,
                          device=dev)
    e = 0.1 * torch.randn(ng, generator=gen, device=dev)
    kw = dict(x0=0.0, dx=1.0, nc=nc, length=length, b=cfg.b_field,
              boundary="open", deposit=True)
    dkw = dict(x0=0.0, dx=1.0, nc=nc)
    out = {}
    for n_q in (1, 4):
        n = cap_l // n_q
        alive = (torch.arange(n, device=dev) < (n * 10) // 16).expand(s, n) \
            .contiguous()
        x = torch.rand(s, n, generator=gen, device=dev) * length
        v = torch.randn(s, n, 3, generator=gen, device=dev) * 0.1
        w = alive.to(f32)
        fargs = (x, v, w, alive, e, qm * dts, dts, charge)
        compare_fused(fused_cycle, fargs, kw, length, False)
        nbytes = s * n * 44 + 2 * ng * 4
        fb, _ = bound_ms(nbytes, s * n * (PUSH_FLOPS + DEPOSIT_FLOPS))
        _, dms = timed(f"engine queue push at async_n {n_q} ({s}, {n}) at "
                       f"{ng} nodes ({deposit.deposit_form(ng)} form)",
                       lambda: fused_cycle.fused_push_deposit(*fargs, **kw),
                       fb)
        out[f"push_q{n_q}"] = dms
        m_q = ENGINE_MAX_MIGRATION // n_q
        for label, rows, charged in (
                ("leavers", s * 2 * m_q, 40),
                ("merged rows", s * (2 * ENGINE_MAX_MIGRATION
                                     + ENGINE_MAX_BIRTHS), 2 * 5_500)):
            xs = torch.rand(rows, generator=gen, device=dev) * length
            q = torch.zeros(rows, device=dev)
            q[torch.randperm(rows, generator=gen, device=dev)[:charged]] = 1.0
            compare_deposit(deposit, xs, q, dkw)
            db, _, _ = deposit_bound(q, ng)
            _, dms = timed(f"engine deposit of the {label} at async_n {n_q} "
                           f"({rows} rows, {charged} charged) at {ng} nodes "
                           f"({deposit.deposit_form(ng)} form)",
                           lambda: deposit.deposit(xs, q, **dkw), db)
            out[f"{label}_q{n_q}"] = dms
        del x, v, w, alive, fargs
    torch.cuda.empty_cache()
    return out


def engine_card_vs_cpu(dev):
    """The bench configuration (field solve on, rho carried, ionization)
    at D = 4, async_n = 2 on the card and on the CPU from one state, with
    the same draws, 3 steps: counts, masks, ring and pending integers
    exact; x within 1e-5 of the slab, v within 1e-4 of max|v|, rho within
    1e-3."""
    import numpy as np

    from repro_torch.configs.pic_bit1 import make_bench_config
    from repro_torch.distributed import engine

    cfg = dataclasses.replace(make_bench_config(strategy="fused"),
                              field_solve=True)
    ecfg = engine_config(4, 2, cfg)
    cpu = engine.init_engine_state(ecfg, 5, device="cpu")
    card = engine.state_from_numpy(ecfg, engine.to_numpy(cpu), device=dev)
    step = engine.make_engine_step(ecfg)
    rng = np.random.default_rng(8)
    cap_q = ecfg.local_cap(cfg.species[0]) // ecfg.async_n
    length = ecfg.local_nc() * cfg.dx
    for k in range(3):
        draws = [{"ionize": [{
            "uniform": rng.random(cap_q, dtype=np.float32),
            "normal": rng.standard_normal((cap_q, 3), dtype=np.float32)}
            for _ in range(ecfg.async_n)], "see": [], "collide": []}
            for _ in range(ecfg.domains)]
        cpu, dc = step(cpu, draws)
        card, dg = step(card, draws)
        for key in dc:
            if key.rsplit("/", 1)[-1] in ("count", "n_ionized",
                                          "birth_overflow", "queue_occ",
                                          "migrated_left", "migrated_right"):
                check_equal(f"engine card vs CPU step {k} {key}",
                            dg[key].cpu(), dc[key])
        ex = ev = 0.0
        for bc, bg in zip(cpu.species, card.species):
            check_equal(f"engine card vs CPU alive step {k}",
                        bg.alive.cpu(), bc.alive)
            ex = max(ex, periodic_err(bg.x.cpu(), bc.x, length))
            vmax = float(bc.v.abs().max())
            ev = max(ev, max_err(bg.v.cpu(), bc.v) / (1.0 + vmax))
        for rc, rg in zip(cpu.rings, card.rings):
            for f in ("slots", "head", "count"):
                check_equal(f"engine card vs CPU ring {f} step {k}",
                            getattr(rg, f).cpu(), getattr(rc, f))
        for pc, pg in zip(cpu.pending, card.pending):
            for f in ("dest", "alive"):
                check_equal(f"engine card vs CPU pending {f} step {k}",
                            getattr(pg, f).cpu(), getattr(pc, f))
        er = max_err(card.rho.cpu(), cpu.rho)
        rmax = float(cpu.rho.abs().max())
        if ex > 1e-5 * length or ev > 1e-4 or er > RHO_TOL * (1.0 + rmax):
            raise AssertionError(f"engine card vs CPU step {k}: x {ex}, v "
                                 f"{ev} (of 1+max|v|), rho {er} (max {rmax})")
        log(f"engine card vs CPU step {k} (D 4, async_n 2): counts, masks, "
            f"rings and pending equal, ionized {int(dg['n_ionized'])}, max "
            f"|dx| {ex:.3g}, max |dv|/(1+max|v|) {ev:.3g}, max |drho| "
            f"{er:.3g}")
    del cpu, card


LAUNCHER_LINES = (
    r"mc sources \(last step\): \{'n_ionized': \d+, 'birth_overflow': 0\}",
    r"3 steps, 4 domain\(s\), async_n=4, rebalance_every=0, "
    r"strategy=fused: \d+\.\d\ds \(\d+\.\d ms/step\)",
    r"final populations: \{'e/count': \d+, 'D\+/count': \d+, "
    r"'D/count': \d+\}",
    r"queue balance: \{'e/queue_occ': \[\d+, \d+, \d+, \d+\], "
    r"'e/queue_skew': \d+, .*\}",
    r"per-phase \(us/step\): \{'ingest': [\d.]+, 'field': [\d.]+, "
    r"'push': [\d.]+, 'collide': [\d.]+, 'migrate': [\d.]+, "
    r"'merge': [\d.]+, 'diag': [\d.]+\} total=[\d.]+")


def engine_launcher(counters):
    """``pic_run --domains 4 --async-n 4 --field-solve --phases`` at full
    size, 3 steps: its lines in the reference launcher's form."""
    import contextlib
    import io

    from repro_torch.launch import pic_run

    reset_launches(counters)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        pic_run.main(["--domains", "4", "--async-n", "4", "--field-solve",
                      "--phases", "--nc", "102400", "--particles",
                      "10485760", "--strategy", "fused", "--steps", "3"])
    lines = buf.getvalue().strip().splitlines()
    for line in lines:
        log(f"  pic_run: {line}")
    for pat, line in zip(LAUNCHER_LINES, lines):
        if not re.fullmatch(pat, line):
            raise AssertionError(f"pic_run line {line!r} is not in the "
                                 f"reference launcher's form {pat!r}")
    if len(lines) < len(LAUNCHER_LINES) or not all(
            ln.startswith("probe flag: ")
            for ln in lines[len(LAUNCHER_LINES):]):
        raise AssertionError(f"pic_run printed {lines}")
    counts = launches(counters)
    log(f"engine pic_run --domains 4 --async-n 4: launches {counts}")
    return counts


def engine_phase(dev):
    """The multi-domain engine at the §3.3 configuration and beside it;
    returns (launches summed over the engine's paths, numbers)."""
    from repro_torch.distributed import engine, perf
    from repro_torch.kernels import collide, deposit, fused_cycle, mover

    t0 = time.perf_counter()
    counters = {"fused_push_deposit": fused_cycle.fused_push_deposit,
                "mover_push": mover.mover_push, "deposit": deposit.deposit,
                "ta_kick": collide.ta_kick}
    paths, numbers = {}, {}
    numbers["calibration_overlap_ms"] = trace_calibration()
    for d, n_q in ENGINE_RUNS:
        label = f"D{d}xq{n_q}"
        ecfg = engine_config(d, n_q)
        state, ms, paths[label], _, _ = drive_engine(
            ecfg, ENGINE_STEPS, f"§3.3 field + ionization, D {d}, async_n "
            f"{n_q}", counters, dev)
        busy, overlap = profile_engine(ecfg, state, label, ms)
        probe = perf.phase_breakdown(ecfg, iters=3, warmup=1, state=state)
        log(f"engine {label} per-phase (device µs a step, CUDA events): "
            + ", ".join(f"{k} {v:.1f}" for k, v in probe["phases"].items())
            + f"; total {probe['total']:.1f}; cumulative medians "
            + ", ".join(f"{k} {v['median']:.1f}"
                        for k, v in probe["cumulative"].items()))
        for flag in probe["flags"]:
            log(f"  probe flag: {flag}")
        numbers[label] = dict(host_ms=ms, busy_ms=busy, overlap_ms=overlap,
                              phases_us=probe["phases"])
        del state
        torch.cuda.empty_cache()

    # the queue split is scheduling only: async_n 1 and 4 at D = 4 see the
    # same particles (ionization off, field on)
    diags = {}
    for n_q in (1, 4):
        ecfg = engine_config(4, n_q, dataclasses.replace(
            engine_config(1, 1).pic, ionization=None))
        state, _, paths[f"parity_q{n_q}"], diags[n_q], sums = drive_engine(
            ecfg, 3, f"queue parity D 4, async_n {n_q}", counters, dev)
        diags[n_q]["migrated"] = sum(v for k, v in sums.items()
                                     if "migrated" in k)
        del state
    for key in diags[1]:
        if key.endswith(("/count", "/charge")) or key == "migrated":
            if int(diags[1][key]) != int(diags[4][key]):
                raise AssertionError(f"queue parity: {key} {diags[1][key]} "
                                     f"!= {diags[4][key]}")
        if key.endswith("/ke"):
            a, b = float(diags[1][key]), float(diags[4][key])
            if abs(a - b) > 1e-5 * abs(a):
                raise AssertionError(f"queue parity: {key} {a} vs {b}")
    log("engine queue parity (D 4, async_n 1 vs 4, 3 steps): counts, charge "
        "and migrations equal, KE within 1e-5")

    ecfg = engine_config(4, 4, collision_config())
    state, ms, paths["collisions"], _, sums = drive_engine(
        ecfg, 2, "collisions (menu + T-A kernel), D 4, async_n 4", counters,
        dev)
    numbers["collisions_host_ms"] = ms
    del state
    torch.cuda.empty_cache()

    numbers["kernels"] = engine_kernel_times(dev)
    engine_card_vs_cpu(dev)
    paths["pic_run"] = engine_launcher(counters)
    counts = {name: sum(p[name] for p in paths.values())
              for name in paths[f"D{ENGINE_RUNS[0][0]}xq1"]}
    for name in ("fused_push_deposit", "deposit", "ta_kick",
                 "fused_push_deposit/block", "fused_push_deposit/pair",
                 "deposit/block", "deposit/pair"):
        if counts[name] <= 0:
            raise AssertionError(f"engine: kernel {name} never launched")
    numbers["seconds"] = time.perf_counter() - t0
    log(f"engine phase: {numbers['seconds']:.1f} s, launches summed over "
        f"its paths {counts}")
    return counts, numbers


# ---------------------------------------------------------------- phase 7 --

def rel_err(got, want) -> float:
    g, w = got.float(), want.float()
    return float((g - w).abs().max() / w.abs().max())


def check_logits(label, logits, vocab):
    if logits.shape[-1] != vocab or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{label}: logits {tuple(logits.shape)} not "
                             f"finite of width {vocab}")


def lm_serve_phase(dev):
    """The serving path at full qwen2-0.5b; returns (flash launches summed
    over the paths, numbers for the summary)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve_lm
    from repro_torch.models.registry import build
    from repro_torch.train.serve_step import make_prefill, make_serve_step

    cfg = get_config(LM_ARCH)
    model = build(cfg)
    params = model.init_params(torch.Generator(device=dev).manual_seed(0))
    gen = torch.Generator(device=dev).manual_seed(1)
    prefill = make_prefill(cfg)
    out, launches = {}, 0

    def run_prefill(tokens, label):
        nonlocal launches
        fa.flash_attention.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hidden, _ = prefill(params, tokens)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        n = fa.flash_attention.launches
        if n != cfg.n_layers:
            raise AssertionError(f"{label}: {n} flash launches, expected "
                                 f"one a layer ({cfg.n_layers})")
        launches += n
        return hidden, ms

    # prefill: 8 prompts x 4,096 tokens, logits at the last position only
    b, s = 8, 4096
    tokens = torch.randint(0, cfg.vocab, (b, s), generator=gen, device=dev)
    times = []
    for k in range(2):
        torch.cuda.reset_peak_memory_stats(dev)
        hidden, ms = run_prefill(tokens, f"prefill {k}")
        times.append(ms)
        last = model.logits(params, hidden[:, -1:])
        check_logits("prefill", last, cfg.vocab)
        del hidden, last
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    out["prefill_ms"] = times[-1]
    out["prefill_tok_s"] = b * s / (times[-1] / 1e3)
    log(f"LM prefill {LM_ARCH} {b} x {s}: ms {[round(t, 3) for t in times]} "
        f"(steady {times[-1]:.3f} ms, {out['prefill_tok_s']:.0f} prompt "
        f"tok/s), peak memory {peak:.2f} GiB, flash launches "
        f"{cfg.n_layers} a prefill")
    torch.cuda.empty_cache()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        hidden, _ = prefill(params, tokens)
        torch.cuda.synchronize()
    report_profile(prof, f"one {LM_ARCH} prefill of {b} x {s}", 1,
                   times[-1])
    del hidden, tokens
    torch.cuda.empty_cache()

    # serve: 4 requests of 512-token prompts, teacher-forced decode steps,
    # then 32 greedy tokens
    b, plen, new = 4, 512, 32
    prompts = torch.randint(0, cfg.vocab, (b, plen), generator=gen,
                            device=dev)
    cache = model.init_cache(b, plen + new + 1, dev)   # + the profiled step
    serve = make_serve_step(cfg)
    dec = torch.empty(b, plen, cfg.vocab, dtype=cfg.dtype, device=dev)
    fa.flash_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(plen):
        lg, cache = model.decode_step(params, prompts[:, t:t + 1], cache, t)
        dec[:, t] = lg[:, 0]
    torch.cuda.synchronize()
    prompt_ms = (time.perf_counter() - t0) * 1e3 / plen
    nxt = torch.argmax(dec[:, -1], dim=-1).to(torch.int32)[:, None]
    generated, step_ms = [nxt], []
    for t in range(plen, plen + new):
        t0 = time.perf_counter()
        nxt, cache = serve(params, nxt, cache, t)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        generated.append(nxt)
    if fa.flash_attention.launches:
        raise AssertionError(f"decode launched flash "
                             f"{fa.flash_attention.launches} times")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        serve(params, nxt, cache, plen + new)
        torch.cuda.synchronize()
    report_profile(prof, f"one {LM_ARCH} decode step at batch {b}", 1,
                   statistics.median(step_ms))
    gen_tok = torch.cat(generated, dim=1)
    check_logits("decode", dec, cfg.vocab)
    if not bool(((gen_tok >= 0) & (gen_tok < cfg.vocab)).all()):
        raise AssertionError("a generated token lies outside the vocabulary")
    out["decode_ms"] = statistics.median(step_ms)
    out["decode_tok_s"] = b * new / (sum(step_ms) / 1e3)
    log(f"LM serve {LM_ARCH}: batch {b}, {plen}-token prompts by decode "
        f"steps ({prompt_ms:.3f} ms a step), then {new} greedy tokens: "
        f"{out['decode_ms']:.3f} ms a decode step (median; steps "
        f"{[round(t, 3) for t in step_ms[:4]]}...), {out['decode_tok_s']:.1f}"
        f" tok/s, flash launches 0; first row {gen_tok[0, :8].tolist()}")
    del cache

    # decode against prefill on the same prompts
    hidden, _ = run_prefill(prompts, "prefill of the serve prompts")
    ref = model.logits(params, hidden)
    rel = rel_err(dec, ref)
    if not rel < 0.02:
        raise AssertionError(f"decode vs prefill logits: rel {rel}")
    log(f"LM decode vs prefill logits over {b} x {plen} prompt positions: "
        f"max |diff| / max |logits| = {rel:.4g} (band 0.02)")
    out["decode_vs_prefill_rel"] = rel
    del hidden, ref, dec
    torch.cuda.empty_cache()

    fa.flash_attention.launches = 0
    serve_lm.main(["--full", "--batch", "4", "--prompt-len", "512",
                   "--tokens", "32"])
    n = fa.flash_attention.launches
    # two prefills of one launch a layer: an untimed one, then the timed one
    if n != 2 * cfg.n_layers:
        raise AssertionError(f"serve_lm --full: {n} flash launches")
    launches += n
    log(f"main path serve_lm --full: flash launches {n}")
    del params
    torch.cuda.empty_cache()
    return launches, out


# ---------------------------------------------------------------- phase 8 --

def lm_card_vs_cpu_phase(dev):
    """qwen2-0.5b at full width, 2 layers, f32, one 128-token prompt: the
    same weights and tokens on the card and on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build

    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=2,
                              dtype=torch.float32)
    model = build(cfg)
    cpu = model.init_params(torch.Generator().manual_seed(3))
    card = {k: ({n: {w: t.to(dev) for w, t in sub.items()}
                 for n, sub in v.items()} if k == "blocks" else v.to(dev))
            for k, v in cpu.items()}
    tokens = torch.randint(0, cfg.vocab, (1, 128),
                           generator=torch.Generator().manual_seed(4))
    band = 1e-4

    def agree(label, got, want):
        """Logits within band of max |want|; greedy tokens equal wherever
        the top-2 gap of the CPU's logits exceeds the band."""
        got = got.cpu()
        rel = rel_err(got, want)
        top2 = torch.topk(want, 2, dim=-1).values
        clear = (top2[..., 0] - top2[..., 1]) > band * float(
            want.abs().max())
        same = torch.argmax(got, -1) == torch.argmax(want, -1)
        if not (rel < band and bool(same[clear].all())):
            raise AssertionError(f"LM card vs CPU {label}: rel {rel}, "
                                 f"{int((~same & clear).sum())} clear greedy "
                                 f"tokens differ")
        return rel, int(clear.sum()), int(clear.numel())

    results = []
    for label, params, device in (("cpu", cpu, "cpu"), ("card", card, dev)):
        h, _ = model.forward(params, tokens.to(device))
        pre = model.logits(params, h)
        cache = model.init_cache(1, 128 + 9, device)
        steps = []
        for t in range(128):
            lg, cache = model.decode_step(params, tokens[:, t:t + 1]
                                          .to(device), cache, t)
            steps.append(lg[:, 0])
        results.append((pre, torch.stack(steps, 1), cache))
    (pc, dc, cc), (pg, dg, cg) = results
    r_pre = agree("prefill", pg, pc)
    r_dec = agree("decode", dg, dc)
    # 8 greedy tokens, both fed the CPU's choice
    nxt = torch.argmax(dc[:, -1], -1)[:, None]
    gaps = []
    for t in range(128, 136):
        lc, cc = model.decode_step(cpu, nxt, cc, t)
        lg, cg = model.decode_step(card, nxt.to(dev), cg, t)
        gaps.append(agree(f"greedy step {t}", lg[:, 0], lc[:, 0])[0])
        nxt = torch.argmax(lc[:, 0], -1)[:, None]
    log(f"LM card vs CPU ({LM_ARCH}, width {cfg.d_model}, 2 layers, f32, "
        f"128-token prompt): prefill rel {r_pre[0]:.3g} (greedy equal on "
        f"{r_pre[1]}/{r_pre[2]} clear positions), decode rel {r_dec[0]:.3g} "
        f"({r_dec[1]}/{r_dec[2]}), 8 greedy steps max rel {max(gaps):.3g}")



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
    for src in ("mover", "collide"):
        for line in (out / f"{src}.log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {src}: {line.strip()}")
    flash_build_phase(out)
    pic_build_phase(out)

    from repro_torch.configs.pic_bit1 import make_config

    kernels = kernel_phase(dev)
    counts, ms = main_path_phase(dev)
    profile_phase(dev, make_config(mover_strategy="fused"), "fused §3.3",
                  ms["fused"], 2)
    profile_phase(dev, dataclasses.replace(make_config(mover_strategy="fused"),
                                           field_solve=True),
                  "fused + field §3.3", ms["fused_field"], 2)
    profile_phase(dev, collision_config(), "collision §3.3", ms["collisions"],
                  1)
    card_vs_cpu_phase(dev)
    collision_card_vs_cpu_phase(dev)
    engine_counts, eng = engine_phase(dev)
    for k in ("fused_push_deposit", "mover_push", "deposit", "ta_kick"):
        counts[k] += engine_counts[k]
    kernels["flash_attention"] = flash_phase(dev)
    counts["flash_attention"], lm = lm_serve_phase(dev)
    lm_card_vs_cpu_phase(dev)

    log("kernels: " + "; ".join(
        f"{k} launches={counts[k]} max_abs_err={kernels[k]['max_abs_err']:.3g}"
        for k in kernels))
    log(f"main path ms/step (median after the first step): "
        + ", ".join(f"{k} {v:.3f}" for k, v in ms.items()))
    for label in (f"D{d}xq{n}" for d, n in ENGINE_RUNS):
        r = eng[label]
        log(f"engine {label}: host {r['host_ms']:.3f} ms/step, device busy "
            f"{r['busy_ms']} ms, cross-stream overlap {r['overlap_ms']} ms")
    log(f"engine phase: {eng['seconds']:.1f} s")
    log(f"LM {LM_ARCH}: prefill 8 x 4096 {lm['prefill_ms']:.3f} ms "
        f"({lm['prefill_tok_s']:.0f} tok/s), decode {lm['decode_ms']:.3f} "
        f"ms/step at batch 4 ({lm['decode_tok_s']:.1f} tok/s), decode vs "
        f"prefill rel {lm['decode_vs_prefill_rel']:.4g}")
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
