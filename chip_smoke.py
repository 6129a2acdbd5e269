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
   electron slots, standalone, and the Coulomb pairing kernel that pairs
   and deflects those slots on the main path; the cell density of those
   slots beside the histogram it replaced, and the bin starts that
   ``charge_exchange`` searches in the neutrals' sorted cell keys beside
   ``cell_bins``; the births kernel landing the hits of one ionization step
   in the electrons and the ions, the neutrals killed) and at ragged small
   shapes
   (every boundary with and without a magnetic field; the deposit kernels'
   two forms on either side of the grid size that parts them; deflection
   rows along z and with delta = 0; pairs in odd and single cells, one row,
   no eligible row; the density at cell edges, outside [0, L), with
   weights 1, 0.37 and random and every row dead; births with no hit, more
   hits than free slots, a full target, a hit on the last row into the
   last slot), each deposit checked to
   launch in the form its grid gives;
   times by CUDA events (and the deposit kernels' device time behind a spin
   kernel) beside the least time the card allows, also at an engine
   domain's grid (25,601 nodes, the block form) and at 600,001 nodes;
   the periodic wrap at positions on and just past each wall, at L = 10,
   3.7 and 7, equal to the plain version's to the bit;
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
   4,096, 16/16 heads, D 256), and for phase 13's prefill layers:
   recurrentgemma-2b (B 4, S 4,096, 10/1 heads, D 256, window 2,048; SDPA
   with a boolean mask), whisper-base's encoder (B 4, 1,500 frames,
   non-causal), decoder (448 tokens) and cross-attention (448 queries over
   1,500 keys), and dbrx-132b (B 2, S 4,096, 48/8 heads, D 128), each
   within FLASH_TOL of the plain version, timed for information;
7. the LM serving paths at full width (run after phase 12, one loop with
   phase 13's), weights from a seeded generator on the card, through
   ``get_config``, ``registry.build``, ``make_prefill`` and
   ``make_serve_step``, the flash launches set to 0 before each path and
   read after: qwen2-0.5b at full width and depth, a prefill of 8 prompts
   x 4,096 tokens twice (logits at the last position; exactly one flash
   launch a layer; a profile of one prefill), 4 requests of 512-token
   prompts fed by teacher-forced decode steps then 32 greedy tokens (no
   flash launch; a profile of one step), the decode logits at every
   prompt position against the prefill's on the same prompts (rel <
   0.02), and the ``serve_lm --full`` command line;
8. card against CPU for the LM in f32, on the same weights and a 128-token
   prompt: qwen2-0.5b at full width cut to 2 layers (and phase 13's
   families): prefill and decode logits within 1e-4 of max |logits|, 8
   greedy steps on with both fed the CPU's choice, greedy tokens equal
   wherever the top-2 gap exceeds that band;
9. the multi-domain engine (run after phase 5), with the kernels' launch
   counts set to 0 before each of its paths and read after: the §3.3
   configuration with the field solve on (rho carried) and ionization at
   (domains, async_n) = (1, 1), (4, 1), (4, 4), 5 steps each, with exact
   pair accounting, every overflow counter 0, charge equal to the counts,
   the launches of every step pinned by kernel and deposit form
   (``engine_launches``; the first step runs eagerly, the second
   captures the step's CUDA graph, which calls every wrapper and launches
   nothing, and replays it; a replay launches a step's kernels and calls
   no wrapper: ``graph_runs`` counts what ran on the card), host ms/step,
   a 2-step profile of replays (device busy, the time kernels on
   different streams overlap, read from the trace's stream ids after a
   calibration with two spin kernels, and each hand-written kernel's
   launches a replay, by name in the trace, held to ``engine_launches``) and
   ``perf.phase_breakdown``; async_n 1 against 4 at D = 4 (ionization
   off: counts and charge equal, KE within 1e-5); the collision menu with
   ``collide_kernel=True`` at D = 4, async_n 4 (``coulomb_pairs`` once a
   queue a domain, ``cell_density`` twice a domain); the queue push and
   the small deposits timed at D = 4's shapes; card against CPU on the
   bench configuration at D = 4, async_n 2 with the same draws (counts, masks, rings and pending exact, x
   within 1e-5 of the slab, v 1e-4 of max|v|, rho 1e-3); and ``pic_run
   --domains 4 --async-n 4 --field-solve --phases`` at full size, its
   lines in the reference launcher's form, then one line a span name
   (host self and device ms a step);
9b. ``tests/test_torch_engine_graph_card.py`` in a pytest subprocess: the
   engine step replayed as a CUDA graph equal to the eager step bit for
   bit (rows, rings, pending blocks, diagnostics; the carried rho within
   1e-6), with the generators and with draws, field off and on, across
   an episode restore (``python3 chip_smoke.py --engine-graph`` runs it
   alone, after the build);
10. the engine's observability and resilience (after phase 9), at the
   §3.3 configuration with the field solve and ionization at D 4 x
   async_n 4, and at its bitwise configuration (field solve and ionization
   off: no float atomics), with the kernels' launch counts set to 0
   before each path and every step's launches pinned by
   ``engine_launches``: (a) two eager steps under
   ``obs.tracing.trace_session``, whose trace holds every scope name the
   steps entered; then the host
   ms/step plain, under the profiler and with the metrics stream, in
   alternating windows on one state of the §3.3 test with the field
   solve off (quartiles, and the device busy a traced step from each
   trace); (b) five steps streamed to a metrics JSONL file that
   ``validate_stream`` accepts, the stream's own cost, and the metrics
   toggle bitwise in the bitwise configuration; (c) the restart drill (``run_engine`` with a checkpoint
   every 2 steps and a failure at step 4, ``resume_engine``, on to step
   6): the restored state equal in every leaf and generator state to
   the failed run's in memory, and the resumed run against that run
   continued without the failure: bitwise in the bitwise configuration
   (and equal to a second run from the start), at §3.3 counts, masks and
   rings exact and x, v, rho in phase 9's card-vs-CPU bands, with each
   checkpoint's bytes, fetch and write times; (d) elastic restores of
   the §3.3 checkpoint of step 2 at D 2 and D 1: counts and charge exact,
   rings consistent, two steps on with the overflow counters 0; (e) the auto-tuner for 8 steps from a migration
   budget that overflows: at least one retune, pairs exact at every
   step; (f) a checkpoint written on the card restored on the CPU and
   one written on the CPU restored on the card, leaves equal, and
   ``resume_training`` of parameters on the card resuming there; (g) the
   launcher's restart drill (``--ckpt-dir --ckpt-every 2 --fail-at-step
   3``, then ``--resume``), ``--profile-dir`` and ``--metrics-jsonl``
   once each, and ``--autotune`` for 10 steps (one retune after its
   window of 8);
11. one line of JSON with every kernel's numbers (launches summed over
   the main paths, the engine's, phase 10's, phase 12's, phase 13's,
   phase 14's and phase 15's),
   then the result line;
12. runtime parameters and the serving layer (run after phase 10), with
   the kernels' launch counts set to 0 before each of its paths and read
   after: (a) ``SimService(width=4)`` at the §3.3 configuration (fused,
   field off, ionization), 8 sessions of 3 steps on the launcher's dt x
   ionization-rate grid with slots reused: exact pair accounting for
   every session at every step, every overflow counter 0, the launches of
   every ensemble step equal to the running members times the solo
   step's, no kernel build after the first step, host ms an ensemble step
   beside 4 x phase 3's solo step, a 1-step profile and the peak memory;
   (a') the collision menu with the deflection kernel at W 2, one
   member's rates doubled; (b) the bitwise configuration at W 3: a
   member equal to its solo run bit for bit, a parked slot frozen with
   zero diagnostics, params equal to static bit for bit single-domain and
   on the engine at D 4 x async_n 2; (c) a width-2 ensemble card against
   CPU on the bench configuration (field on) with the same draws, within
   phase 5's bands; (d) ``make_engine_step(with_params=True)`` at §3.3
   (field on, ionization, D 4 x async_n 4), 3 steps with a second
   parameter point from the second, pairs exact, launches pinned, no
   build after the first step; (e) ``pic_run --ensemble 8 --steps 5
   --strategy fused``, its lines in the reference launcher's form;
13. the MoE, SSM, hybrid and encoder-decoder families, in phase 7's and
   8's loops: recurrentgemma-2b and mamba2-2.7b at full width and depth,
   whisper-base at full size, dbrx-132b at full width with 2 of its 40
   layers; for each two prefills (4 x 4,096 tokens; whisper 4 x 448
   tokens over 4 x 1,500 frames; dbrx 2 x 4,096) with the flash launches
   pinned (8, 0, 18, 2 a prefill; dbrx's share of routes dropped at
   capacity 1.25; a profile of one recurrentgemma prefill), then 4
   prompts of 512 tokens (whisper 64, after ``prefill_cross``) by decode
   steps and 32 greedy tokens (kernels a decode step from a profile), and
   decode against prefill: within 0.02 for recurrentgemma and whisper,
   reported for dbrx (the MoE at capacity_factor 100; a bf16 route may
   differ) and mamba2 (bf16 rounding grows through its 64 layers, as in
   the reference), whose decode is held to its prefill in f32 at full
   size within 1e-3; llama4-maverick and internvl2 at their SMOKE
   configs; ``serve_lm --full --arch recurrentgemma-2b``; and card
   against CPU in f32 (recurrentgemma at full width cut to 3 layers,
   mamba2 to 2, whisper to 2 + 2, dbrx and llama4 at SMOKE width with
   256-token prompts so that routes drop), the MoE's experts and
   keep-masks equal.

14. LM training (after phase 13), the flash launches set to 0 before
   each train step and read after, weights from a seeded generator:
   (a) qwen2-0.5b at full width and depth, bf16, AdamW with f32 state,
   4 x 4,096 tokens a step, ``loss_chunk`` 512, remat, 6 steps on one
   batch (lr 1e-3, 2 warm-up steps): loss and grad norm finite, the loss
   falling from step 1 to step 6, 48 flash launches a step (24 in the
   forward, 24 in the remat recompute; the backward launches none), ms a
   step (median of steps 2..6), tokens/s, peak GiB, 6 N T over the bf16
   peak, and the 1-step profile of a copy cut to 4 layers; (b) one step
   with ``microbatches=2`` against one with 1 from the same state: params
   within 5e-2; (c) one Adafactor step: finite; (d) one step of
   recurrentgemma-2b, mamba2-2.7b, dbrx-132b, llama4-maverick and
   internvl2 at their SMOKE configs and of whisper-base at full size
   (4 x 448 tokens over 4 x 1,500 frames): loss and every gradient
   finite, the MoE aux loss live, flash launches pinned; (e) card
   against CPU in f32 for one step's loss (1e-5 relative) and every
   gradient leaf (1e-4 of its max |grad|): qwen2-0.5b at full width cut
   to 2 layers (2 x 256 tokens) and the SMOKE configs of dbrx, mamba2,
   recurrentgemma and whisper; (f) ``launch.train --full
   --arch qwen2-0.5b --steps 3 --batch 4 --seq 1024 --ckpt-every 2``, its
   last line; (g) the restart drill in a subprocess with deterministic
   algorithms (``run_training`` failing at step 7, ``resume_training``
   from step 4's checkpoint): params and optimizer state bit for bit
   those of the run without the failure.
15. the mesh, the dry-run and the roofline (after phase 14), the
   kernels' launch counts set to 0 before each path and read after: (a)
   phase 14's qwen2-0.5b run (full width and depth, bf16 seeded weights,
   4 x 4,096 tokens of ``data.pipeline`` seed 7, AdamW, remat,
   ``loss_chunk`` 512) for 2 steps plain and 2 steps on
   ``make_debug_mesh(1, 1)`` over NCCL at world 1, every parameter and
   moment a DTensor placed by ``sharding.rules`` (the path of
   ``launch.train --full --mesh debug``): the losses and every parameter
   leaf equal bit for bit, 48 flash launches a step through the
   registered operator, host ms a step of both; (c) one more mesh step
   under ``roofline.analysis.CostMode``: the counted FLOPs at least
   ``dryrun.model_flops`` for 4 x 4,096 tokens (6 N T), the flash
   operator's share 48 times its formula, t_compute and t_memory at the
   H100 constants beside the measured ms; (a') ``launch.train --full
   --mesh debug`` for 2 steps at 4 x 1,024, its last line, its
   checkpoint and its group stopped; (b) ``dryrun.run_cell`` of
   qwen2-0.5b x train_4k on the 16 x 16 mesh and x decode_32k on the 2 x
   16 x 16 mesh, traced under torch's fake process group at world 512 in
   this process (both ``ok``, useful flops ratio <= 1), and
   ``run_pic_dryrun`` at D 16 for one real engine step on the card; the
   rows in ``roofline.report``'s table.
Exits non-zero and prints no result without a CUDA device, or when the
port's sources are not beside this script.
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
import shutil
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
# a row of the Coulomb pairing kernel: order 8, cell 4, v 12, nrm 4, phi 4
# read, v 12 written; a head's u, |u| and delta add 16 flops to the
# deflection's (counted per row, as the deflection's bound counts them)
PAIR_BYTES = 44
PAIR_FLOPS = TA_FLOPS + 16
# the cell density kernel: alive 1 B a row, then x 4 and w 4 an eligible
# row (a dead row's need not be read), the (nc,) table 4 a cell written;
# a floor, a multiply and an add an eligible row
DENSITY_ALIVE_BYTES = 1
DENSITY_ROW_BYTES = 8
DENSITY_FLOPS = 3
# the births kernel: mask 1 B a candidate and alive 1 B a slot a target
# read; a birth's rows, x, v, w read and written with alive, 41 B a
# target, and the kill's alive and w (w read), 9 B
BIRTH_MASK_BYTES = 1
BIRTH_SLOT_BYTES = 1
BIRTH_ROW_BYTES = 41
BIRTH_KILL_BYTES = 9
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


def wall_positions(length: float, dev):
    """float32 positions on and within 64 steps of -L, 0, L and 2L (at 0,
    multiples of L's ulp; an ulp of 0 is subnormal)."""
    import numpy as np

    f32 = np.float32
    step = np.spacing(f32(length))
    out = [f32(k) * step for k in range(-64, 65)]
    for wall in (-f32(length), f32(length), f32(2) * f32(length)):
        lo = hi = wall
        out.append(wall)
        for _ in range(64):
            lo = np.nextafter(lo, f32(-np.inf))
            hi = np.nextafter(hi, f32(np.inf))
            out += [lo, hi]
    return torch.tensor(np.asarray(out, f32), device=dev)


def compare_wrap(fused, mover, length, dev):
    """The periodic wrap at positions on and just past each wall (v = 0,
    E = 0, so the push leaves x as it is): kernel and plain version equal
    to the bit, not only modulo L (the mover, and the fused kernel with
    and without its deposit)."""
    x = wall_positions(length, dev)
    n, nc = x.numel(), 64
    v = torch.zeros(n, 3, device=dev)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    w = torch.ones(n, device=dev)
    e = torch.zeros(nc + 1, device=dev)
    kw = dict(x0=0.0, dx=length / nc, nc=nc, length=length,
              b=(0.0, 0.0, 0.0), boundary="periodic")
    got = mover.mover_push(x, v, alive, e, qm_dt=-0.05, dt=0.05, **kw)[0]
    want = mover.mover_push_plain(x, v, alive, e, qm_dt=-0.05, dt=0.05,
                                  **kw)[0]
    check_equal(f"mover wrap at L = {length}", got, want)
    one = torch.ones(1, device=dev)
    fargs = (x[None], v[None], w[None], alive[None], e, -0.05 * one,
             0.05 * one, -one)
    for dep in (False, True):
        got = fused.fused_push_deposit(*fargs, deposit=dep, **kw)[0]
        want = fused.fused_push_deposit_plain(*fargs, deposit=dep, **kw)[0]
        check_equal(f"fused wrap at L = {length} (deposit {dep})", got, want)
    return int(((x < 0) | (x >= length)).sum())


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


def pair_inputs(gen, buf, grid, rate, dt):
    """The arguments ``coulomb_intra`` hands the Coulomb pairing kernel for
    the species buffer ``buf``: (order, cell, v, n_cell, nrm, phi, rate,
    dt), drawn from ``gen`` as it draws them."""
    from repro_torch.core import collisions

    ok = collisions._eligible(buf.x, buf.alive, grid.length)
    cell = collisions._cells(buf.x, ok, grid.dx, grid.nc)
    order = collisions.cell_shuffled_order(gen, cell, ok)
    nrm, phi = collisions._coulomb_draws(gen, None, order.shape[0],
                                         torch.float32, buf.x.device)
    return (order, cell, buf.v, collisions.cell_density(grid, buf), nrm, phi,
            rate, dt)


def ragged_pair_inputs(gen, dev, rows, nc, alive_share):
    """``pair_inputs`` of ``rows`` random slots over ``nc`` cells,
    ``alive_share`` of them alive, with rate and dt as 0-d tensors on the
    card (the runtime-parameter path)."""
    from repro_torch.core.grid import Grid1D
    from repro_torch.core.particles import SpeciesBuffer

    grid = Grid1D(nc=nc, dx=1.0)
    x = torch.rand(rows, generator=gen, device=dev) * grid.length
    v = torch.randn(rows, 3, generator=gen, device=dev)
    alive = torch.rand(rows, generator=gen, device=dev) < alive_share
    buf = SpeciesBuffer(x=x, v=v, w=alive.float(), alive=alive)
    return pair_inputs(gen, buf, grid, torch.tensor(1e-2, device=dev),
                       torch.tensor(0.2, device=dev))


def main_path_ta_inputs(pargs):
    """The deflection's rows on the main path (u, delta, phi), each sorted
    position's pair, built by the plain composition from the pairing
    kernel's arguments ``pargs``."""
    from repro_torch.kernels import collide

    *_, u, delta = collide.coulomb_pair_rows(*pargs[:5], *pargs[6:])
    return u, delta, pargs[5]


def compare_coulomb_pairs(collide, pargs):
    """Kernel vs plain on the same arguments: the pair count exact, rows
    outside a pair equal (``==``: the kernel copies a -0.0 that index_add
    turns into +0.0), paired rows within 2 ulp of the row's largest
    component. Returns (max |kernel - plain|, pairs, largest gap in ulp)."""
    got, got_n = collide.coulomb_pairs(*pargs)
    want, want_n = collide.coulomb_pairs_plain(*pargs)
    torch.cuda.synchronize()
    if int(got_n) != int(want_n):
        raise AssertionError(f"coulomb_pairs: {int(got_n)} pairs, plain "
                             f"{int(want_n)}")
    ia, ib, valid, _, _ = collide.coulomb_pair_rows(*pargs[:5], *pargs[6:])
    paired = torch.zeros(got.shape[0], dtype=torch.bool, device=got.device)
    paired[ia[valid]] = True
    paired[ib[valid]] = True
    check_equal("coulomb_pairs rows outside a pair", got[~paired],
                want[~paired])
    top = want[paired].abs().amax(1, keepdim=True)
    ulp = torch.nextafter(top, torch.full_like(top, float("inf"))) - top
    gap = float(((got[paired] - want[paired]).abs() / ulp).max()) \
        if int(want_n) else 0.0
    if not gap <= 2.0:
        raise AssertionError(f"coulomb_pairs: a paired row {gap} ulp off")
    return max_err(got, want), int(want_n), gap


def compare_cell_density(collide, x, alive, w, kw, exact):
    """Kernel vs plain on the same rows: bit for bit where ``exact`` (every
    bin a sum of equal weights), else each bin within twice the rounding
    of a sum of its count of positive terms. Returns max |kernel - plain|."""
    got = collide.cell_density(x, alive, w, **kw)
    want = collide.cell_density_plain(x, alive, w, **kw)
    torch.cuda.synchronize()
    if exact:
        check_equal("cell_density", got, want)
    else:
        ones = collide.cell_density_plain(x, alive, torch.ones_like(w), **kw)
        tol = 2 * ones * 2.0 ** -24 * want
        if bool(((got - want).abs() > tol).any()):
            raise AssertionError("cell_density: a bin off by more than the "
                                 "rounding of its sum")
    return max_err(got, want)


def compare_cell_starts(keys, nc):
    """``charge_exchange``'s bin starts (a search in the sorted keys) vs
    ``particles.cell_bins``: the starts equal, and their differences equal
    its counts."""
    from repro_torch.core import collisions
    from repro_torch.core.particles import cell_bins

    got = collisions._cell_starts(keys, nc)
    counts, starts = cell_bins(keys, nc)
    check_equal("cell starts against cell_bins", got, starts)
    check_equal("cell starts' counts", torch.diff(
        got, append=got.new_full((1,), keys.shape[0])), counts)


def binning_phase(collide, gen, dev, st, grid):
    """The cell density kernel on ragged cases, then on the §3.3 electrons'
    slots, timed beside its bound, its plain version and the histogram it
    replaced; the bin starts that ``charge_exchange`` searches in the
    neutrals' sorted cell keys, checked and timed beside ``cell_bins``.
    Returns the density's result row."""
    from repro_torch.core import collisions
    from repro_torch.core.particles import cell_bins

    nc, rows = 37, 5001
    kw = dict(dx=1.0, nc=nc, length=float(nc))
    x = torch.rand(rows, generator=gen, device=dev) * (nc + 2.0) - 1.0
    x[:nc + 1] = torch.arange(nc + 1, dtype=torch.float32, device=dev)
    alive = torch.rand(rows, generator=gen, device=dev) < 0.7
    ones = torch.ones(rows, device=dev)
    for w, exact in ((ones, True), (0.37 * ones, True),
                     (torch.rand(rows, generator=gen, device=dev), False)):
        compare_cell_density(collide, x, alive, w, kw, exact)
    compare_cell_density(collide, x, torch.zeros_like(alive), ones, kw, True)
    log(f"kernels: cell_density on {rows} rows over {nc} cells (cell edges, "
        f"rows outside [0, L), weights 1, 0.37 and random, all dead) agrees "
        f"with its plain version")

    results = {}
    kw = dict(dx=grid.dx, nc=grid.nc, length=grid.length)
    dargs = (st.x[0], st.alive[0], st.w[0])
    n = dargs[0].shape[0]
    err = compare_cell_density(collide, *dargs, kw, True)
    live = int(collisions._eligible(dargs[0], dargs[1], grid.length).sum())
    bms, by = bound_ms(n * DENSITY_ALIVE_BYTES + live * DENSITY_ROW_BYTES
                       + grid.nc * 4, live * DENSITY_FLOPS)
    ms, _ = timed(f"cell_density ({n} rows, {grid.nc} cells)",
                  lambda: collide.cell_density(*dargs, **kw), bms)
    results["cell_density"] = dict(
        name="cell_density", route="cuda",
        source="src/repro_torch/csrc/collide.cu",
        replaces="src/repro/core/collisions.py cell_density's .at[c].add",
        max_abs_err=err, ms=ms,
        plain_ms=median_ms(lambda: collide.cell_density_plain(*dargs, **kw),
                           5),
        bound_ms=bms, bound_by=by, library_ms=None)

    ok = collisions._eligible(st.x[2], st.alive[2], grid.length)
    cell = collisions._cells(st.x[2], ok, grid.dx, grid.nc)
    keys = torch.sort(cell).values
    compare_cell_starts(keys, grid.nc)
    search = median_ms(lambda: collisions._cell_starts(keys, grid.nc), 20)
    log(f"cell binning at the §3.3 rows: the density's plain index_add_ "
        f"{results['cell_density']['plain_ms']:.4f} ms; the neutrals' bin "
        f"starts by searchsorted {search:.4f} ms "
        f"against cell_bins (bincount, a host sync) "
        f"{median_ms(lambda: cell_bins(cell, grid.nc), 5):.4f} ms; "
        f"{int(ok.sum())} eligible neutrals, {live} live electrons")
    return results


def compare_births(births, mask, dests, srcs, kill):
    """The births kernel and its plain version on copies of the targets
    and the kill buffer (a source's w is the kill buffer's, as in
    ``ionize``): every field, ``ok`` and both counters bit for bit.
    Returns the count landed."""
    def land(fn):
        d = [tuple(a.clone() for a in t) for t in dests]
        k = None if kill is None else tuple(a.clone() for a in kill)
        src = [(x, v, w if k is None else k[1]) for x, v, w in srcs]
        return fn(mask, d, src, k), d, k

    got, got_d, got_k = land(births.place_births)
    want, want_d, want_k = land(births.place_births_plain)
    pairs = list(zip(got, want)) + [
        p for gd, wd in zip(got_d, want_d) for p in zip(gd, wd)]
    if kill is not None:
        pairs += list(zip(got_k, want_k))
    for g, w in pairs:
        if g.dtype != w.dtype or not torch.equal(g, w):
            raise AssertionError("place_births: differs from its plain "
                                 "version")
    return int(got[1])


def births_phase(gen, dev, st, cfg):
    """The births kernel on ragged cases (no hit, a few, more than the
    free slots, a full target, a hit on the last row into the last slot,
    two targets of unequal capacity with a kill), then on the §3.3 step's
    ionization: the hits of the initial state landing in the electrons and
    the ions, the neutrals killed, timed beside its bound and its plain
    version. Returns its result row."""
    from repro_torch.core import collisions
    from repro_torch.core.grid import deposit_density, gather
    from repro_torch.core.particles import SpeciesBuffer
    from repro_torch.kernels import births

    def rows(cap, alive):
        return (torch.rand(cap, generator=gen, device=dev),
                torch.randn(cap, 3, generator=gen, device=dev),
                torch.where(alive, torch.rand(cap, generator=gen,
                                              device=dev) + 0.5, 0.0), alive)

    def alive_share(cap, share):
        return torch.rand(cap, generator=gen, device=dev) < share

    m = 4000
    every = torch.ones(m, dtype=torch.bool, device=dev)
    last = torch.zeros(m, dtype=torch.bool, device=dev)
    last[-1] = True
    only_last = torch.ones(5000, dtype=torch.bool, device=dev)
    only_last[-1] = False
    cases = [(~every, [alive_share(5000, 0.6)], False),
             (alive_share(m, 0.01), [alive_share(5000, 0.6)], False),
             (alive_share(m, 0.5), [alive_share(5000, 0.9)], False),
             (alive_share(m, 0.01), [alive_share(5000, 0.6),
                                     alive_share(3000, 1.0)], True),
             (last, [only_last], False),
             (alive_share(m, 0.1), [alive_share(5000, 0.6),
                                    alive_share(3000, 0.7)], True)]
    landed = []
    for mask, alive, kill in cases:
        src = rows(m, every)
        srcs = [(src[0], torch.randn(m, 3, generator=gen, device=dev),
                 src[2]) for _ in alive]
        landed.append(compare_births(
            births, mask, [rows(a.shape[0], a) for a in alive], srcs,
            (every.clone(), src[2].clone()) if kill else None))
    log(f"kernels: place_births on {m} candidates into 5,000 and 3,000 "
        f"slots (landed {landed}: no hit, a few, more than the free slots, "
        f"a full target, the last row into the last slot, two targets with "
        f"a kill) equals its plain version")

    ni, ei, ii = cfg.ionization
    grid = cfg.grid
    neutrals = SpeciesBuffer(st.x[ni], st.v[ni], st.w[ni], st.alive[ni])
    electrons = SpeciesBuffer(st.x[ei], st.v[ei], st.w[ei], st.alive[ei])
    params = collisions.IonizationParams(rate=cfg.ionization_rate,
                                         vth_electron=cfg.ionization_vth_e)
    ne = deposit_density(grid, electrons)
    hit, ve = collisions.ionization_events(
        torch.Generator(device=dev).manual_seed(97), neutrals.x,
        neutrals.alive, gather(grid, ne, neutrals.x), params,
        cfg.dt)
    dests = [tuple(a.clone() for a in (st.x[i], st.v[i], st.w[i],
                                       st.alive[i])) for i in (ei, ii)]
    srcs = [(neutrals.x, ve, neutrals.w), (neutrals.x, neutrals.v,
                                           neutrals.w)]
    kill = (neutrals.alive.clone(), neutrals.w.clone())
    n = compare_births(births, hit, dests, srcs, kill)
    if n <= 0:
        raise AssertionError("place_births: no birth at the §3.3 step")
    m, caps = hit.shape[0], [d[0].shape[0] for d in dests]
    bms, by = bound_ms(m * BIRTH_MASK_BYTES + sum(caps) * BIRTH_SLOT_BYTES
                       + n * (len(dests) * BIRTH_ROW_BYTES
                              + BIRTH_KILL_BYTES), 0)
    srcs = [(x, v, kill[1]) for x, v, _ in srcs]

    def call():
        births.place_births(hit, dests, srcs, kill)

    ms, _ = timed(f"place_births ({m} candidates, {n} births into 2 x "
                  f"{caps[0]} slots, with the kill)", call, bms)
    row = dict(
        name="place_births", route="cuda",
        source="src/repro_torch/csrc/births.cu",
        replaces="src/repro/core/particles.py inject_masked's free_slots "
                 "scan and .at[dest].set scatter",
        max_abs_err=0.0, ms=ms,
        plain_ms=median_ms(lambda: births.place_births_plain(
            hit, dests, srcs, kill), 5),
        bound_ms=bms, bound_by=by, library_ms=None)
    log(f"place_births at the §3.3 step: {n} births of {int(hit.sum())} "
        f"hits, plain {row['plain_ms']:.4f} ms")
    return row


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
    from repro_torch.configs.pic_bit1 import make_collision_menu, make_config
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
    # the wrap x - floor(x * float32(1 / L)) * L (jitted JAX's rounding of
    # x / L): at 3.7 and 7 that reciprocal rounds L * (1 / L) off 1, so a
    # division would put a position on a wall on the other side
    outside = {length: compare_wrap(fused_cycle, mover, length, dev)
               for length in (10.0, 3.7, 7.0)}
    log(f"kernels: the periodic wrap at positions on and just past each "
        f"wall equals the plain version's to the bit (positions outside "
        f"[0, L) by length: {outside})")
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
    for rows, nc, share in ((5001, 37, 0.8), (4096, 1, 1.0), (1, 4, 1.0),
                            (777, 9, 0.0)):
        compare_coulomb_pairs(collide, ragged_pair_inputs(gen, dev, rows, nc,
                                                          share))
    log(f"kernels: ragged shapes (cap 5000, 3 boundaries x b on/off; the "
        f"deposit kernels at 257, 513, {edge} (block, dx = 10 / {edge - 1}) "
        f"and {edge + 1} (pair) nodes; 5000 deflection rows with u along z "
        f"and delta = 0; Coulomb pairs of 5001 rows in 37 cells, 4096 in "
        f"one, a single row and 777 dead rows, rate and dt on the card) agree "
        f"with their plain versions")

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

    # the Coulomb operator of the collision path on the §3.3 electrons, one
    # row per slot: the pairing kernel, and the standalone deflection on
    # each sorted position's pair
    electrons = SpeciesBuffer(x=st.x[0], v=st.v[0], w=st.w[0],
                              alive=st.alive[0])
    pargs = pair_inputs(torch.Generator(device=dev).manual_seed(99),
                        electrons, cfg.grid,
                        make_collision_menu(("coulomb",))[0].rate, cfg.dt)
    rows = pargs[0].shape[0]
    err, pairs, gap = compare_coulomb_pairs(collide, pargs)
    bms, by = bound_ms(rows * PAIR_BYTES, rows * PAIR_FLOPS)
    results["coulomb_pairs"] = dict(
        name="coulomb_pairs", route="cuda",
        source="src/repro_torch/csrc/collide.cu",
        replaces="src/repro/core/collisions.py pair_in_cells + "
                 "src/repro/kernels/collide.py:36", max_abs_err=err,
        ms=median_ms(lambda: collide.coulomb_pairs(*pargs), 20),
        plain_ms=median_ms(lambda: collide.coulomb_pairs_plain(*pargs), 5),
        bound_ms=bms, bound_by=by, library_ms=None)
    log(f"coulomb_pairs rows: {rows}, {pairs} pairs, paired rows within "
        f"{gap} ulp of the plain version")
    targs = main_path_ta_inputs(pargs)
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
    results.update(binning_phase(collide, gen, dev, st, cfg.grid))
    results["place_births"] = births_phase(gen, dev, st, cfg)
    for r in results.values():
        extra = (f" (no deposit {r['ms_no_deposit']:.4f} ms)"
                 if "ms_no_deposit" in r else "")
        lib = (f", index_add_ {r['library_ms']:.4f} ms"
               if r["library_ms"] is not None else "")
        log(f"kernel {r['name']} at the main-path shape: max_abs_err "
            f"{r['max_abs_err']:.3g}, {r['ms']:.4f} ms{extra}, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}){lib}")
    del st, fargs, margs, electrons, pargs, targs
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

# launches the wrappers' counters miscount on the engine's CUDA-graph
# path, by counter name (``graph_runs``): a capture calls every wrapper
# and launches nothing, a replay launches a step's kernels and calls no
# wrapper. ``launches`` adds them, ``reset_launches`` clears them.
GRAPH_LAUNCHES: dict = {}


def launches(counters):
    """Each kernel's launches on the card and, for the two deposit
    kernels, its launches by form ("fused_push_deposit/block", ...): the
    wrappers' counts, corrected by ``GRAPH_LAUNCHES``."""
    out = {}
    for name, fn in counters.items():
        out[name] = fn.launches
        for attr, n in sorted(vars(fn).items()):
            if attr.startswith("launches_"):
                out[f"{name}/{attr.removeprefix('launches_')}"] = n
    return {k: n + GRAPH_LAUNCHES.get(k, 0) for k, n in out.items()}


def reset_launches(counters):
    GRAPH_LAUNCHES.clear()
    for fn in counters.values():
        for attr in list(vars(fn)):
            if attr.startswith("launches"):
                setattr(fn, attr, 0)


# kernels that no main path launches: phase 2 times them on their own
STANDALONE = ("ta_kick",)


def pic_counters():
    """The PIC kernels' wrappers by name, whose ``launches`` the phases
    read."""
    from repro_torch.kernels import (births, collide, deposit, fused_cycle,
                                     mover)

    return {"fused_push_deposit": fused_cycle.fused_push_deposit,
            "mover_push": mover.mover_push, "deposit": deposit.deposit,
            "ta_kick": collide.ta_kick,
            "coulomb_pairs": collide.coulomb_pairs,
            "cell_density": collide.cell_density,
            "place_births": births.place_births}


def expected(form, fused=0, fused_dep=0, mover=0, deposit=0, pairs=0,
             density=0, births=0):
    """Launches a step: totals, and the deposit kernels' launches by form,
    all of them in ``form`` (fused_dep of the fused kernel's launches carry
    a deposit)."""
    from repro_torch.kernels.deposit import FORMS

    out = {"fused_push_deposit": fused, "mover_push": mover,
           "deposit": deposit, "ta_kick": 0, "coulomb_pairs": pairs,
           "cell_density": density, "place_births": births}
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
    growth = []            # (field energy, e- KE) a step, field on
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
        if cfg.field_solve:
            if not bool(torch.isfinite(diag["field_energy"])):
                raise AssertionError(f"{label}: non-finite field energy")
            growth.append((float(diag["field_energy"]), float(diag["e/ke"])))
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
    if growth:
        extra += (f", omega_p*dt {omega_p_dt(cfg):.4f}, field energy a step "
                  f"{[f'{f:.4g}' for f, _ in growth]}, e- KE a step "
                  f"{[f'{e:.4g}' for _, e in growth]}")
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


def omega_p_dt(cfg) -> float:
    """The electrons' plasma frequency times dt at the mean density of
    ``cfg``: the leapfrog push is stable below 2."""
    e = cfg.species[0]
    n = e.n_init * e.weight / (cfg.nc * cfg.dx)
    return math.sqrt(n * e.charge ** 2 / (cfg.eps0 * e.mass)) * cfg.dt


def collision_config(strategy="fused"):
    """The §3.3 configuration with the collision menu on and ionization
    off, as ``make_collision_config`` chooses, at the published widths;
    the Coulomb pairs deflect through the kernel."""
    from repro_torch.configs.pic_bit1 import make_collision_menu, make_config

    return dataclasses.replace(
        make_config(mover_strategy=strategy), ionization=None,
        collisions=make_collision_menu(), collide_kernel=True)


def menu_launches(cfg):
    """The collide kernels' launches a step of ``cfg``'s collision menu, as
    ``expected``'s arguments: the Coulomb pairing kernel once a Coulomb
    entry (with ``collide_kernel``), the density once a density species."""
    from repro_torch.core import collisions

    kinds = [cc.kind for cc in cfg.collisions]
    return {"pairs": kinds.count("coulomb") if cfg.collide_kernel else 0,
            "density": len(collisions.density_species(cfg.collisions))}


def run_launcher(argv, counters, label):
    from repro_torch.launch import pic_run

    reset_launches(counters)
    pic_run.main(argv)
    counts = launches(counters)
    log(f"main path {label}: launches {counts}")
    return counts


def main_path_phase(dev):
    from repro_torch.configs.pic_bit1 import make_config
    from repro_torch.kernels import deposit

    counters = pic_counters()
    ms, paths = {}, {}
    cfg = make_config(mover_strategy="fused")
    # the form of the §3.3 grid; every deposit of every path below must
    # launch in it
    form = deposit.deposit_form(cfg.nc + 1)
    ms["fused"], paths["fused"] = drive(
        cfg, 5, "fused (field solve off)", counters,
        expected(form, fused=1, deposit=1, births=1), dev)
    ms["fused_field"], paths["fused_field"] = drive(
        dataclasses.replace(cfg, field_solve=True), 5,
        "fused + field solve (rho carried)", counters,
        expected(form, fused=1, fused_dep=1, deposit=2, births=1), dev)
    ms["explicit"], paths["explicit"] = drive(
        make_config(mover_strategy="explicit"), 3, "explicit",
        counters, expected(form, mover=3, deposit=1, births=1), dev)
    ms["collisions"], paths["collisions"] = drive(
        collision_config(), 3, "collisions (menu + T-A kernel, field off)",
        counters, expected(form, fused=1, **menu_launches(collision_config())),
        dev)
    paths["pic_run"] = run_launcher(
        ["--nc", "102400", "--particles", "10485760", "--strategy",
         "fused", "--steps", "3"], counters, "pic_run")
    if paths["pic_run"]["fused_push_deposit"] != 3:
        raise AssertionError("pic_run did not run the fused kernel per step")
    # the reference launcher deflects through ta_kick_ref, and so does the
    # port's: no coulomb_pairs launch here
    paths["pic_run_collisions"] = run_launcher(
        ["--nc", "102400", "--particles", "10485760", "--strategy",
         "fused", "--steps", "2", "--collisions", "elastic,cx,coulomb"],
        counters, "pic_run --collisions")
    if (paths["pic_run_collisions"]["fused_push_deposit"] != 2
            or paths["pic_run_collisions"]["coulomb_pairs"] != 0):
        raise AssertionError("pic_run --collisions: unexpected launches "
                             f"{paths['pic_run_collisions']}")
    counts = {name: sum(p[name] for p in paths.values())
              for name in paths["fused"]}
    for name, c in counts.items():
        main = "/" not in name or name.endswith("/" + form)
        if name in STANDALONE:
            if c:
                raise AssertionError(f"{name}: {c} launches on the main "
                                     f"paths, which no longer run it")
            continue
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
    report_profile(prof.key_averages(), f"a {label} step", steps, step_ms)
    del state
    torch.cuda.empty_cache()


def report_profile(events, label, reps, host_ms):
    """Device time by operator and by kernel, per repetition, and the
    device's busy share of ``host_ms`` (the unprofiled host-clock time of
    one repetition), from a trace's ``key_averages()``. Returns (device
    busy ms, kernels) a repetition, or None when the profiler recorded no
    device time."""
    from torch.autograd import DeviceType

    # device kernels carry the device time; the aten ops that launched
    # them carry the same time again as their self device time, and so do
    # the engine's record_function ranges (engine/..., halo/...)
    kernels, ops = [], []
    for e in events:
        if e.key.startswith(("engine/", "halo/")):
            continue
        if e.self_device_time_total > 0:
            row = (e.self_device_time_total / (1e3 * reps),
                   e.count / reps, e.key)
            (ops if e.device_type == DeviceType.CPU else kernels).append(row)
    if not kernels:
        log(f"profile of {label}: the profiler recorded no device time (not "
            f"measured)")
        return None
    busy = sum(r[0] for r in kernels)
    log(f"profile of {label}: device busy {busy:.3f} ms of "
        f"{host_ms:.3f} ms ({100 * busy / host_ms:.1f} %), "
        f"{sum(r[1] for r in kernels):.0f} kernels")
    for title, rows in (("by operator", ops), ("by kernel", kernels)):
        log(f"  device ms {title}:")
        for ms, count, name in sorted(rows, reverse=True)[:12]:
            log(f"  {ms:8.3f} ms  x{count:4.0f}  {name[:90]}")
    return busy, sum(r[1] for r in kernels)


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

    # one layer of the other configs' head shapes, and the prefill layers
    # of phase 13's families: (label, arch, B, Sq, Skv, causal, window)
    layers = [("", "qwen2-7b", 2, s, s, True, 0),
              ("", "gemma-7b", 1, s, s, True, 0),
              ("", "recurrentgemma-2b", 4, s, s, True, 2048),
              (" encoder", "whisper-base", 4, 1500, 1500, False, 0),
              (" decoder", "whisper-base", 4, 448, 448, True, 0),
              (" cross", "whisper-base", 4, 448, 1500, False, 0),
              ("", "dbrx-132b", 2, s, s, True, 0)]
    for what, arch, b, sq, skv, causal, window in layers:
        c = get_config(arch)
        q, k, v = qkv(b, sq, skv, c.n_heads, c.kv_heads, c.hd, c.dtype)
        e = compare_flash(fa, q, k, v, causal, window, f"{arch}{what} layer")
        t = time_flash(fa, q, k, v, causal, window)
        log(f"flash one {arch}{what} layer (B {b}, Sq {sq}, Skv {skv}, H "
            f"{c.n_heads}, KVH {c.kv_heads}, D {c.hd}, "
            f"{'causal' if causal else 'non-causal'}"
            f"{f', window {window}' if window else ''}, bf16): max_abs_err "
            f"{e:.3g}, {t['ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
            f"({t['bound_by']}: {t['gflop']:.1f} GFLOP, {t['mb']:.1f} MB), "
            f"scaled_dot_product_attention {t['library_ms']:.4f} ms")
        del q, k, v
        torch.cuda.empty_cache()
    return {key: r[key] for key in (
        "name", "route", "source", "replaces", "max_abs_err", "ms",
        "plain_ms", "bound_ms", "bound_by", "library_ms")}


def time_flash(fa, q, k, v, causal=True, window=0):
    """Flash on (B, S, H, D) inputs by CUDA events, beside its compute
    bound and SDPA on the same tensors (a boolean mask for a window)."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    pairs = b * h * attention_pairs(sq, skv, causal, window)
    nbytes = q.element_size() * (2 * q.numel() + k.numel() + v.numel())
    bms, by = bound_ms(nbytes, 4 * d * pairs, BF16_FLOPS)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    kw = {"enable_gqa": True}
    if window > 0:
        qpos = torch.arange(sq, device=q.device)[:, None]
        kpos = torch.arange(skv, device=q.device)[None, :]
        kw["attn_mask"] = (kpos > qpos - window) & (kpos <= qpos if causal
                                                    else True)
    else:
        kw["is_causal"] = causal
    return dict(ms=median_ms(lambda: fa.flash_attention(
                    q, k, v, causal=causal, window=window), 20),
                library_ms=median_ms(lambda: sdpa(qt, kt, vt, **kw), 20),
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
    once a domain (rho carried), the Coulomb pairing kernel once a
    queue a domain a Coulomb entry (with ``collide_kernel``), the cell
    density once a domain a density species and the bin starts twice a
    queue a domain a CX entry; every deposit in the form of a domain's
    grid."""
    from repro_torch.distributed import engine
    from repro_torch.kernels.deposit import deposit_form

    cfg = ecfg.pic
    d, n_q = ecfg.domains, ecfg.async_n
    carried = engine._carries_rho(ecfg)
    queues = d * n_q
    dep = ((d if cfg.ionization is not None else 0)
           + (queues + d if carried else 0))
    menu = menu_launches(cfg)
    return expected(deposit_form(ecfg.local_nc() + 1), fused=queues,
                    fused_dep=queues if carried else 0, deposit=dep,
                    pairs=queues * menu["pairs"],
                    density=d * menu["density"])


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
    from repro_torch.obs import tracing

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
    replays = 0
    for k in range(steps):
        before = launches(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with tracing.capture_scopes() as names:
            state, diag = step(state)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        ran = graph_runs(names, per_step)
        after = launches(counters)
        delta = {n: after[n] - before[n] for n in after}
        want = {n: v * ran for n, v in per_step.items()}
        if delta != want:
            raise AssertionError(f"{label} step {k}: launches {delta}, "
                                 f"expected {want}")
        replays += names.count("engine/graph/replay")
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
    if steps > 1 and replays != steps - 1:
        raise AssertionError(f"{label}: {replays} of the {steps - 1} steps "
                             f"after the first replayed the step's graph")
    steady = statistics.median(times[2:] or times[1:] or times)
    log(f"engine {label}: {steps} steps, ms/step "
        f"{[round(t, 3) for t in times]} (median of the replays after the "
        f"capture {steady:.3f}), populations {counts}, sums {sums}; launches "
        f"a step run eagerly or replayed {per_step}; peak memory "
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


# each launch counter's kernels by the names they run under in a trace;
# a deposit in the block form adds a ``sum_rows_kernel``, one in the pair
# form a ``pair_finish_kernel``
TRACE_KERNELS = {
    "fused_push_deposit": ("fused_push_deposit_kernel", "fused_block_kernel"),
    "mover_push": ("mover_push_kernel",),
    "deposit": ("deposit_kernel", "deposit_block_kernel"),
    "ta_kick": ("ta_kick_kernel",),
    "coulomb_pairs": ("coulomb_pairs_kernel",),
    "cell_density": ("cell_density_kernel",),
    "place_births": ("place_births_kernel",),
    "deposit rows": ("sum_rows_kernel",),
    "deposit finish": ("pair_finish_kernel",),
}


def trace_launches(events, steps) -> dict:
    """Launches a step of ``TRACE_KERNELS``' kernels in a trace's
    ``key_averages()`` over ``steps`` steps, matched by the kernel's own
    name (``deposit_kernel`` is not ``fused_push_deposit_kernel``)."""
    import re

    from torch.autograd import DeviceType

    out = dict.fromkeys(TRACE_KERNELS, 0)
    for e in events:
        if e.device_type == DeviceType.CPU:
            continue
        for key, names in TRACE_KERNELS.items():
            if any(re.search(rf"(^|[\s:]){n}[<(]", e.key) for n in names):
                out[key] += e.count
    return {k: n / steps for k, n in out.items()}


def trace_want(per_step) -> dict:
    """``trace_launches``' counts of a step that launches ``per_step``."""
    want = {k: per_step[k] for k in TRACE_KERNELS if k in per_step}
    for key, form in (("deposit rows", "block"), ("deposit finish", "pair")):
        want[key] = (per_step[f"fused_push_deposit/{form}"]
                     + per_step[f"deposit/{form}"])
    return want


def profile_engine(ecfg, state, label, host_ms, steps=2):
    """Device busy of an engine step and the time kernels on different
    streams overlap, from a torch.profiler trace of ``steps`` replays of
    the step's graph; device time by kernel beside ``host_ms``, the
    unprofiled step; each hand-written kernel's launches a replay, by name
    in the trace, held to ``engine_launches``. Returns (busy ms, overlap
    ms) a step."""
    from repro_torch.distributed import engine
    from repro_torch.obs import tracing

    step = engine.make_engine_step(ecfg)
    for _ in range(2):             # eager, then the graph's capture
        state, _ = step(state)
    torch.cuda.synchronize()
    box = [state]

    def run():
        for _ in range(steps):
            box[0], _ = step(box[0])

    with tracing.capture_scopes() as names:
        prof, iv = trace_overlap(run, f"engine_{label}")
    if names.count("engine/graph/replay") != steps:
        raise AssertionError(f"profile {label}: {steps} steps, "
                             f"{names.count('engine/graph/replay')} replays")
    if not iv:
        log(f"profile of an engine step {label}: no device events in the "
            f"trace (not measured)")
        return None, None
    got = trace_launches(prof.key_averages(), steps)
    want = trace_want(engine_launches(ecfg))
    if got != want:
        raise AssertionError(f"profile {label}: launches a replay by name "
                             f"in the trace {got}, expected {want}")
    log(f"profile of an engine step {label}: launches a replay by name in "
        f"the trace {got}, as engine_launches has them")
    busy, overlap, n_streams = busy_and_overlap(iv)
    kernel_sum = sum(e - s for s, e, _ in iv)
    log(f"profile of an engine step {label}: device busy "
        f"{busy / 1e3 / steps:.3f} ms a step (kernels, copies and memsets "
        f"{kernel_sum / 1e3 / steps:.3f} ms summed over {n_streams} "
        f"streams; {overlap / 1e3 / steps:.3f} ms with two or more streams "
        f"running), {len(iv) / steps:.0f} device events a step")
    report_profile(prof.key_averages(), f"an engine step {label}", steps,
                   host_ms)
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
    r"spans \(ms/step over 3 steps\): host self, device")
# one line a span name after the last of LAUNCHER_LINES
SPAN_LINE = r"  [\w/+]+: -?[\d.]+, [\d.]+"


def engine_launcher(counters):
    """``pic_run --domains 4 --async-n 4 --field-solve --phases`` at full
    size, 3 steps: its lines in the reference launcher's form, then its
    spans."""
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
    spans = lines[len(LAUNCHER_LINES):]
    if (not all(re.fullmatch(SPAN_LINE, ln) for ln in spans)
            or not any(ln.startswith("  engine/queue/q3: ")
                       for ln in spans)):
        raise AssertionError(f"pic_run printed {lines}")
    counts = launches(counters)
    log(f"engine pic_run --domains 4 --async-n 4: launches {counts}")
    return counts


def engine_phase(dev):
    """The multi-domain engine at the §3.3 configuration and beside it;
    returns (launches summed over the engine's paths, numbers)."""
    from repro_torch.distributed import engine, perf

    t0 = time.perf_counter()
    counters = pic_counters()
    paths, numbers = {}, {}
    numbers["calibration_overlap_ms"] = trace_calibration()
    for d, n_q in ENGINE_RUNS:
        label = f"D{d}xq{n_q}"
        ecfg = engine_config(d, n_q)
        state, ms, paths[label], _, _ = drive_engine(
            ecfg, ENGINE_STEPS, f"§3.3 field + ionization, D {d}, async_n "
            f"{n_q}", counters, dev)
        # phase_breakdown steps a copy of the state; profile_engine then
        # donates it
        probe = perf.phase_breakdown(ecfg, iters=3, warmup=1, state=state)
        busy, overlap = profile_engine(ecfg, state, label, ms)
        log(f"engine {label} per-phase (device µs a step, from the spans): "
            + ", ".join(f"{k} {v:.1f}" for k, v in probe["phases"].items())
            + f"; total {probe['total']:.1f}")
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
    for name in ("fused_push_deposit", "deposit", "coulomb_pairs",
                 "cell_density",
                 "fused_push_deposit/block", "fused_push_deposit/pair",
                 "deposit/block", "deposit/pair"):
        if counts[name] <= 0:
            raise AssertionError(f"engine: kernel {name} never launched")
    numbers["seconds"] = time.perf_counter() - t0
    log(f"engine phase: {numbers['seconds']:.1f} s, launches summed over "
        f"its paths {counts}")
    return counts, numbers


# the flag that runs phase 9b alone, after the build
ENGINE_GRAPH_FLAG = "--engine-graph"


def engine_graph_phase() -> float:
    """Phase 9b: ``tests/test_torch_engine_graph_card.py`` (the engine step
    replayed as a CUDA graph against the eager step, bit for bit, with
    the generators and with draws, field off and on) in a pytest
    subprocess on the card. Returns its seconds."""
    import os

    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    run = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         str(ROOT / "tests" / "test_torch_engine_graph_card.py")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=1800)
    for line in run.stdout.strip().splitlines()[-12:]:
        log(f"  engine graph: {line}")
    if run.returncode != 0 or " passed" not in run.stdout \
            or "skipped" in run.stdout:
        raise AssertionError(f"phase 9b: the engine graph tests failed "
                             f"(exit {run.returncode}):\n{run.stdout[-4000:]}"
                             f"\n{run.stderr[-2000:]}")
    secs = time.perf_counter() - t0
    log(f"phase 9b: the engine step's graph replays equal its eager steps "
        f"({secs:.1f} s)")
    return secs


# ---------------------------------------------------------------- phase 10 --

# the observability and resilience phase's files, under build/ of the
# checkout (checkpoints of the §3.3 state take ~1.3 GB each)
OBS_DIR = ROOT / "build" / "phase10"
# the scope names one step at D 4 x async_n 4 with the field solve and
# ionization enters (tests/test_torch_obs.py holds them to the reference's)
STEP_SCOPES = (("engine/ingest", "engine/field", "engine/sources",
                "engine/merge", "engine/diag", "halo/sum", "halo/smooth",
                "halo/poisson", "halo/efield", "halo/ppermute")
               + tuple(f"engine/{p}/q{k}" for p in ("push", "ionize",
                                                    "migrate")
                       for k in range(4)))


def bitwise_pic():
    """The §3.3 configuration with the field solve and ionization off: no
    kernel of its step adds floats atomically (no deposit runs, and no
    ionization reads a deposited density), so two runs on the card from
    one state agree bit for bit."""
    return dataclasses.replace(engine_config(1, 1).pic, field_solve=False,
                               ionization=None)


def graph_runs(names, per_step) -> int:
    """Engine steps among the scope names ``names`` that ran on the card,
    each launching ``per_step``: the eager steps and the replays of the
    step's CUDA graph. Every step that ran its phases entered
    ``engine/ingest`` once, eagerly or into a capture, and called the
    wrappers; a capture launches nothing and a replay calls no wrapper,
    so ``GRAPH_LAUNCHES`` takes ``per_step`` off for each capture and
    adds it for each replay. Then the wrappers' calls were right exactly
    where ``launches`` moved by ``per_step`` times the steps returned."""
    extra = (names.count("engine/graph/replay")
             - names.count("engine/graph/capture"))
    for n, v in per_step.items():
        GRAPH_LAUNCHES[n] = GRAPH_LAUNCHES.get(n, 0) + extra * v
    return names.count("engine/ingest") + extra


def pinned(step, ecfg, counters, label):
    """``step`` with the kernels' launches of each call held to
    ``engine_launches(ecfg)`` (``graph_runs``: a capture launches none, a
    replay launches a step's)."""
    from repro_torch.obs import tracing

    per_step = engine_launches(ecfg)

    def run(state, *args):
        before = launches(counters)
        with tracing.capture_scopes() as names:
            out = step(state, *args)
        ran = graph_runs(names, per_step)
        after = launches(counters)
        delta = {n: after[n] - before[n] for n in after}
        want = {n: v * ran for n, v in per_step.items()}
        if delta != want:
            raise AssertionError(f"{label}: launches {delta}, expected "
                                 f"{want}")
        return out

    return run


def state_leaves(state):
    """{checkpoint key: tensor or array} of an engine state."""
    from repro_torch.ckpt import checkpoint
    from repro_torch.distributed import engine

    return {checkpoint._path_str(p): v
            for p, v in checkpoint._leaves(engine.state_tree(state))}


def same_leaf(a, b) -> bool:
    import numpy as np

    if isinstance(a, torch.Tensor):
        b = b.to(a.device) if isinstance(b, torch.Tensor) else \
            torch.as_tensor(b, device=a.device)
        return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
    return np.array_equal(np.asarray(a), np.asarray(b))


def check_states_bitwise(label, a, b, gens=True):
    """Every leaf of two engine states equal (and each domain's generator
    state, with ``gens``)."""
    la, lb = state_leaves(a), state_leaves(b)
    if sorted(la) != sorted(lb):
        raise AssertionError(f"{label}: leaves {sorted(la)} vs {sorted(lb)}")
    bad = [k for k in la if not same_leaf(la[k], lb[k])]
    if bad:
        raise AssertionError(f"{label}: leaves {bad} differ")
    if gens and not all(torch.equal(x.get_state(), y.get_state())
                        for x, y in zip(a.gens, b.gens)):
        raise AssertionError(f"{label}: generator states differ")


def check_diags_bitwise(label, a, b):
    import numpy as np

    if len(a) != len(b):
        raise AssertionError(f"{label}: {len(a)} vs {len(b)} diags")
    for i, (da, db) in enumerate(zip(a, b)):
        if set(da) != set(db) or not all(np.array_equal(da[k], db[k])
                                         for k in da):
            raise AssertionError(f"{label}: diag of step +{i} differs")


def check_pairs(label, n0, counts, ionized):
    """Exact pair accounting: every ionization took one neutral and made
    one electron and one ion."""
    ne, ni, nn = counts
    if not (ne - n0[0] == ni - n0[1] == ionized == n0[2] - nn
            and ionized > 0):
        raise AssertionError(
            f"{label}: pair accounting broken: e {n0[0]}->{ne}, D+ "
            f"{n0[1]}->{ni}, D {n0[2]}->{nn}, ionized {ionized}")


def restart_drill(ecfg, label, exact, counters, dev, ckdir):
    """``run_engine`` 6 steps with a checkpoint every 2 and a failure at
    step 4, ``resume_engine`` (the restored state equal in every leaf and
    generator state to the failed run's state in memory), and on to step
    6, against the same run continued in memory without the failure:
    every leaf, generator state and diag equal with ``exact`` (and equal
    to a second run from the start too); otherwise counts, masks and
    rings equal and x, v, rho within the card-vs-CPU bands of phase 9,
    with exact pair accounting. Returns (the checkpointer, numbers)."""
    from repro_torch.ckpt.checkpoint import Checkpointer
    from repro_torch.distributed import engine
    from repro_torch.obs.metrics import MetricsStream
    from repro_torch.runtime import resilience
    from repro_torch.runtime.fault_tolerance import (FailureInjector,
                                                     SimulatedFailure)

    last = {}

    def stepper():
        # one step function a run, as each run is a process of its own: on
        # the card a step's output lives in its function's buffers until
        # that function's next call
        pinned_step = pinned(engine.make_engine_step(ecfg), ecfg, counters,
                             label)

        def step(state):
            out = pinned_step(state)
            last["state"] = out[0]
            return out

        return step

    step = stepper()
    init = engine.init_engine_state(ecfg, 0, device=dev)
    n0 = resident_counts(init)
    ck = Checkpointer(str(ckdir))
    stream = MetricsStream()
    inj = FailureInjector(fail_at_step=4)
    try:
        resilience.run_engine(ecfg, init, num_steps=6, ckpt=ck,
                              ckpt_every=2, injector=inj, step_fn=step,
                              stream=stream)
    except SimulatedFailure:
        pass
    else:
        raise AssertionError(f"{label}: no failure at step 4")
    mem = last.pop("state")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step_r, state = resilience.resume_engine(ecfg, ck, device=dev)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    if step_r != 4 or state.step != 4:
        raise AssertionError(f"{label}: resumed at {step_r}, expected 4")
    check_states_bitwise(f"{label} restored vs in memory", state, mem)
    fin, diags = resilience.run_engine(
        ecfg, state, num_steps=6, ckpt=ck, ckpt_every=2, injector=inj,
        step_fn=stepper(), stream=stream)
    last_write_ms = ck.last_write_us / 1e3
    # the failed run's own step function, on its last output
    ref, ref_diags = resilience.run_engine(ecfg, mem, num_steps=6,
                                           step_fn=step)
    recs = [m for m in stream.window(99) if "ckpt/bytes" in m.counters]
    if [m.step for m in recs] != [1, 3, 5]:
        raise AssertionError(f"{label}: checkpoints at steps "
                             f"{[m.step for m in recs]}")
    counts = [int(diags[-1][f"{sc.name}/count"]) for sc in ecfg.pic.species]
    if counts != resident_counts(fin):
        raise AssertionError(f"{label}: diag counts {counts} != resident + "
                             f"pending {resident_counts(fin)}")
    if exact:
        check_states_bitwise(label, fin, ref)
        check_diags_bitwise(label, ref_diags, diags)
        again, _ = resilience.run_engine(
            ecfg, engine.init_engine_state(ecfg, 0, device=dev),
            num_steps=6, step_fn=stepper(), collect=False)
        check_states_bitwise(f"{label} second run", fin, again)
        del again
        extra = ("the restored state, every leaf, generator state and "
                 "resumed diag equal, and equal to a second run")
    else:
        ionized = int(sum(m.counters["n_ionized"]
                          for m in stream.window(99)))
        check_pairs(f"{label} resumed", n0, counts, ionized)
        for bf, br in zip(fin.species, ref.species):
            check_equal(f"{label} alive", bf.alive, br.alive)
        if [int(ref_diags[-1][f"{sc.name}/count"])
                for sc in ecfg.pic.species] != counts:
            raise AssertionError(f"{label}: counts differ from the run "
                                 f"without the failure")
        length = ecfg.local_nc() * ecfg.pic.dx
        ex = ev = 0.0
        for bf, br in zip(fin.species, ref.species):
            ex = max(ex, periodic_err(bf.x, br.x, length))
            ev = max(ev, max_err(bf.v, br.v)
                     / (1.0 + float(br.v.abs().max())))
        for rf, rr in zip(fin.rings, ref.rings):
            for f in ("slots", "head", "count"):
                check_equal(f"{label} ring {f}", getattr(rf, f),
                            getattr(rr, f))
        er = max_err(fin.rho, ref.rho)
        rmax = float(ref.rho.abs().max())
        if ex > 1e-5 * length or ev > 1e-4 or er > RHO_TOL * (1.0 + rmax):
            raise AssertionError(f"{label}: x {ex}, v {ev} (of 1+max|v|), "
                                 f"rho {er} (max {rmax})")
        # the field grows from step to step (PERF.md §7): the e- kinetic
        # energy of each step, the failed run's steps 0-3, then the
        # resumed run's 4-5
        ke = [f"{m.counters['e/ke']:.4g}" for m in stream.window(99)]
        extra = (f"the restored state equal to the one in memory; after 2 "
                 f"steps counts {counts}, masks and rings equal, ionized "
                 f"{ionized}, max |dx| {ex:.3g}, max |dv|/(1+max|v|) "
                 f"{ev:.3g}, max |drho| {er:.3g} (max {rmax:.4g}); "
                 f"omega_p*dt {omega_p_dt(ecfg.pic):.4f}, e- KE a step "
                 f"{ke}")
    nums = dict(bytes=recs[0].counters["ckpt/bytes"],
                fetch_ms=[m.counters["ckpt/fetch_us"] / 1e3 for m in recs],
                write_ms=[m.counters["ckpt/write_us"] / 1e3
                          for m in recs[1:]] + [last_write_ms],
                restore_s=restore_s)
    log(f"phase 10 (c) restart drill, {label}: failed at step 4, resumed "
        f"from step {step_r}, on to 6: {extra}; checkpoint "
        f"{nums['bytes'] / 2**30:.3f} GiB, fetch ms "
        f"{[round(v, 1) for v in nums['fetch_ms']]}, write ms "
        f"{[round(v, 1) for v in nums['write_ms']]}, restore "
        f"{restore_s:.2f} s")
    del ref, fin, state, mem
    torch.cuda.empty_cache()
    return ck, nums


def elastic_restore(ecfg, d_new, ck, counters, dev, step=2):
    """The §3.3 checkpoint of D 4 at ``step`` restored at D = ``d_new``
    (step 2: with the field on, ω_p·dt = 2.024 at the §3.3 density, past
    the leapfrog's limit of 2, so the field and the electrons' energy
    grow ~2x a step, in the reference too (PERF.md §7), and by step 6 the
    electrons cross the domains faster than the migration budget
    allows): count and
    charge of every species equal to the checkpoint's resident + pending
    rows, pending empty, each ring holding exactly its dead slots; then 2
    steps with their launches pinned, overflow counters 0 and exact pair
    accounting. Returns the restore's seconds."""
    import numpy as np

    from repro_torch.distributed import engine
    from repro_torch.runtime import resilience

    _, flat, _ = ck.restore_flat(step)
    want = []
    for g, idxs in enumerate(engine._capacity_groups(ecfg)):
        for j, i in enumerate(idxs):
            a, w = flat[f"pic/species/{i}/alive"], flat[f"pic/species/{i}/w"]
            pa = flat[f"pending/{g}/alive"][:, j]
            pw = flat[f"pending/{g}/w"][:, j]
            want.append((i, int(a.sum()) + int(pa.sum()),
                         float((w.astype(np.float64) * a).sum()
                               + (pw.astype(np.float64) * pa).sum())))
    del flat
    e2 = dataclasses.replace(ecfg, domains=d_new)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step_r, st = resilience.resume_engine(e2, ck, step=step, device=dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    label = f"elastic D 4 -> {d_new}"
    if st.species[0].x.shape[0] != d_new:
        raise AssertionError(f"{label}: {st.species[0].x.shape[0]} domains")
    for i, n, q in sorted(want):
        b = st.species[i]
        got_n = int(b.alive.sum())
        got_q = float((b.w.double() * b.alive).sum())
        if got_n != n or got_q != q:
            raise AssertionError(f"{label}: species {i} count {got_n} "
                                 f"charge {got_q}, checkpoint {n} {q}")
    for rg, g in zip(st.rings, st.groups):
        check_equal(f"{label} ring count", rg.count,
                    (~g.alive).sum(-1, dtype=torch.int32))
    if any(bool(p.alive.any()) for p in st.pending):
        raise AssertionError(f"{label}: pending not empty")
    n0 = resident_counts(st)
    step_fn = pinned(engine.make_engine_step(e2), e2, counters, label)
    ionized = 0
    for k in range(2):
        st, diag = step_fn(st)
        ionized += int(diag["n_ionized"])
        for key, v in diag.items():
            if key.rsplit("/", 1)[-1] in ("birth_overflow",
                                          "migration_overflow",
                                          "merge_dropped") and int(v):
                raise AssertionError(f"{label} step {k}: {key} = {int(v)}")
    check_pairs(label, n0, resident_counts(st), ionized)
    log(f"phase 10 (d) {label} at step {step_r}: counts and charge exact "
        f"({[n for _, n, _ in sorted(want)]}), rings consistent, pending "
        f"empty; 2 steps on, overflow counters 0, ionized {ionized}; "
        f"restore {secs:.2f} s")
    del st
    torch.cuda.empty_cache()
    return secs


def cross_device_restore(dev):
    """A checkpoint written on the card restores on the CPU, and one
    written on the CPU on the card (bench configuration, field on, D 4 x
    async_n 2, after 2 steps): every leaf equal."""
    from repro_torch.ckpt.checkpoint import Checkpointer
    from repro_torch.configs.pic_bit1 import make_bench_config
    from repro_torch.distributed import engine
    from repro_torch.runtime import resilience

    ecfg = engine_config(4, 2, dataclasses.replace(
        make_bench_config(strategy="fused"), field_solve=True))
    for src, dst in ((dev, torch.device("cpu")), (torch.device("cpu"), dev)):
        state, _ = resilience.run_engine(
            ecfg, engine.init_engine_state(ecfg, 0, device=src), num_steps=2,
            collect=False)
        ckdir = OBS_DIR / f"cross_{src.type}"
        ck = Checkpointer(str(ckdir))
        resilience.save_engine(ck, ecfg, 2, state, blocking=True)
        _, out = resilience.resume_engine(ecfg, ck, device=dst)
        if out.groups[0].x.device.type != dst.type:
            raise AssertionError(f"restore {src} -> {dst} is on "
                                 f"{out.groups[0].x.device}")
        check_states_bitwise(f"cross-device {src.type} -> {dst.type}", out,
                             state, gens=False)
        log(f"phase 10 (f) a checkpoint written on {src.type} restores on "
            f"{dst.type} with every leaf equal (bench config, D 4 x 2)")
        shutil.rmtree(ckdir)
    resume_training_on_card(dev)


def resume_training_on_card(dev):
    """``fault_tolerance.resume_training`` with parameters on the card
    resumes on the card, bit-equal to the run without the failure
    (``tests/test_torch_resilience.py::test_resume_training_stays_on_the_card``
    here)."""
    from repro_torch.ckpt.checkpoint import Checkpointer
    from repro_torch.runtime import fault_tolerance as ft

    def step_fn(params, opt, batch):
        grad = params["w"] - batch
        opt = {"m": 0.9 * opt["m"] + grad}
        return {"w": params["w"] - 0.1 * opt["m"]}, opt, {
            "loss": (grad * grad).sum()}

    def batch_fn(step):
        return torch.full((4096,), 1.0 + 0.01 * step, device=dev)

    p0 = {"w": torch.zeros(4096, device=dev)}
    o0 = {"m": torch.zeros(4096, device=dev)}
    ckdir = OBS_DIR / "training"
    ref, _, _ = ft.run_training(step_fn, batch_fn, p0, o0, num_steps=6,
                                ckpt=Checkpointer(str(ckdir / "ref")),
                                ckpt_every=100)
    ck = Checkpointer(str(ckdir / "run"))
    try:
        ft.run_training(step_fn, batch_fn, p0, o0, num_steps=6, ckpt=ck,
                        ckpt_every=2,
                        injector=ft.FailureInjector(fail_at_step=3))
    except ft.SimulatedFailure:
        pass
    else:
        raise AssertionError("(f) resume_training: no failure at step 3")
    ck.wait()
    p, o, _ = ft.resume_training(step_fn, batch_fn, num_steps=6, ckpt=ck,
                                 ckpt_every=2,
                                 like={"params": p0, "opt": o0})
    if p["w"].device.type != "cuda" or o["m"].device.type != "cuda":
        raise AssertionError(f"(f) resume_training resumed on "
                             f"{p['w'].device}, {o['m'].device}")
    check_equal("(f) resume_training", p["w"], ref["w"])
    log("phase 10 (f) resume_training with parameters on the card resumes "
        "on the card, equal to the run without the failure")
    shutil.rmtree(ckdir)


PIC_RUN_BASE = ["--domains", "4", "--async-n", "4", "--field-solve",
                "--strategy", "fused", "--steps", "4"]


def pic_run_config():
    """The EngineConfig ``pic_run`` builds from ``PIC_RUN_BASE``."""
    from repro_torch.configs.pic_bit1 import (make_bench_config,
                                              make_engine_config)

    return make_engine_config(
        dataclasses.replace(make_bench_config(strategy="fused"),
                            field_solve=True), domains=4, async_n=4,
        max_migration=8192, max_births=8192)


def pic_run_lines(argv, counters, steps, label):
    """``pic_run`` with ``argv`` in this process: its lines, and its
    launches held to those of its ``steps`` engine steps (``graph_runs``:
    a capture launches none, a replay launches a step's) plus the initial
    state's deposit of the carried rho (one a domain)."""
    import contextlib
    import io

    from repro_torch.distributed import engine
    from repro_torch.kernels.deposit import deposit_form
    from repro_torch.launch import pic_run

    ecfg = pic_run_config()
    per_step = engine_launches(ecfg)
    init = ecfg.domains * len(engine._capacity_groups(ecfg))
    form = deposit_form(ecfg.local_nc() + 1)
    from repro_torch.obs import tracing

    reset_launches(counters)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), \
            tracing.capture_scopes() as names:
        pic_run.main(argv)
    lines = buf.getvalue().strip().splitlines()
    for line in lines:
        log(f"  pic_run {label}: {line[:240]}")
    if names.count("engine/step") != steps:
        raise AssertionError(f"pic_run {label}: {names.count('engine/step')}"
                             f" engine steps, expected {steps}")
    ran = graph_runs(names, per_step)
    counts = launches(counters)
    if ran != steps:
        raise AssertionError(f"pic_run {label}: {ran} engine steps ran on "
                             f"the card, expected {steps}")
    want = {n: ran * v + (init if n in ("deposit", f"deposit/{form}")
                          else 0) for n, v in per_step.items()}
    if counts != want:
        raise AssertionError(f"pic_run {label}: launches {counts}, expected "
                             f"{want}")
    return lines, counts


def pic_run_drill(counters):
    """The launcher's new flags: the restart drill (a failure at step 3,
    checkpoints every 2, then the same command with --resume), then
    --profile-dir and --metrics-jsonl once each and --autotune for 10
    steps, so that its tuner retunes once."""
    from repro_torch.obs import metrics, tracing

    paths = {}
    ck = OBS_DIR / "pic_run_ckpt"
    drill = PIC_RUN_BASE + ["--ckpt-dir", str(ck), "--ckpt-every", "2",
                            "--fail-at-step", "3"]
    lines, paths["fail"] = pic_run_lines(drill, counters, 3, "fail")
    if not lines[-1].startswith("simulated failure: injected failure at "
                                "step 3"):
        raise AssertionError(f"pic_run fail: {lines}")
    lines, paths["resume"] = pic_run_lines(drill + ["--resume"], counters,
                                           2, "resume")
    if (lines[0] != f"resumed from checkpoint step 2 in {ck}"
            or not re.fullmatch(LAUNCHER_LINES[1].replace("3 steps",
                                                          "4 steps"),
                                lines[2])
            or not re.fullmatch(LAUNCHER_LINES[2], lines[3])):
        raise AssertionError(f"pic_run resume: {lines}")
    trace = OBS_DIR / "pic_run_trace"
    lines, paths["profile"] = pic_run_lines(
        PIC_RUN_BASE + ["--profile-dir", str(trace)], counters, 4, "profile")
    files = list(trace.glob("*.trace.json"))
    if (f"profiler trace written to {trace}" not in lines or len(files) != 1
            or "engine/push/q3" not in tracing.trace_scope_names(
                str(files[0]))):
        raise AssertionError(f"pic_run --profile-dir: {lines}, {files}")
    jsonl = OBS_DIR / "pic_run_metrics.jsonl"
    lines, paths["metrics"] = pic_run_lines(
        PIC_RUN_BASE + ["--metrics-jsonl", str(jsonl)], counters, 4,
        "metrics")
    header, steps = metrics.read_jsonl(str(jsonl))
    errs = metrics.validate_stream([header] + steps)
    if errs or len(steps) != 4 or not lines[0].startswith("metrics: "):
        raise AssertionError(f"pic_run --metrics-jsonl: {errs}, {lines}")
    # the tuner decides after a window of 8 steps (TunerPolicy.window):
    # 10 steps make it retune once and run 2 steps on the new config,
    # whose launches a step are the old one's (the budgets change no
    # launch)
    lines, paths["autotune"] = pic_run_lines(
        PIC_RUN_BASE + ["--steps", "10", "--autotune"], counters, 10,
        "autotune")
    tuned = [ln.removeprefix("autotune: ") for ln in lines
             if ln.startswith("autotune: ")]
    if len(tuned) != 1 or not any(ln.startswith("metrics: ")
                                  for ln in lines):
        raise AssertionError(f"pic_run --autotune: no single retune: "
                             f"{lines}")
    base = pic_run_config()
    changes = {}
    for item in tuned[0].split(", "):
        knob, change = item.split(": ")
        changes[knob] = int(change.split(" -> ")[1])
    if engine_launches(dataclasses.replace(base, **changes)) != \
            engine_launches(base):
        raise AssertionError(f"pic_run --autotune: {changes} changes the "
                             f"launches a step")
    log(f"phase 10 (g) pic_run: the restart drill (fail at 3, --resume from "
        f"2), --profile-dir, --metrics-jsonl and --autotune (10 steps, "
        f"retuned after 8: {tuned[0]}) ran, with their launches pinned")
    return paths


def timed_steps(step, state, n, record=None):
    """``n`` steps of ``step`` from ``state``, each timed on the host from a
    synchronized card to the end of its work (``record(k, diag, t0)``, if
    given, waits for it and records the diag). Returns (state, ms a
    step)."""
    times = []
    for k in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, diag = step(state)
        if record is None:
            torch.cuda.synchronize()
        else:
            record(k, diag, t0)
        times.append((time.perf_counter() - t0) * 1e3)
    return state, times


# the windows of the overhead measurement: P plain, T under the profiler,
# M with the metrics stream; each order reversed after it, so that a drift
# in the host's speed cancels
OVERHEAD_ORDER = "PTMMTP" * 2
OVERHEAD_WINDOW = 2


def quartiles(xs):
    q = statistics.quantiles(xs, n=4)
    return [round(q[0], 3), round(statistics.median(xs), 3), round(q[2], 3)]


def overhead_windows(counters, dev):
    """The host's ms a step of the engine at D 4 x async_n 4 plain, under
    ``trace_session`` and with the metrics stream, in windows of
    ``OVERHEAD_WINDOW`` steps alternating as ``OVERHEAD_ORDER`` on one
    state. The configuration is the paper's §3.3 test (field solve off,
    ionization on), whose work holds from step to step; with the field on
    the state grows (PERF.md §7). The metrics toggle keeps the state's
    layout (``retarget_state`` is the identity), so both step functions
    take one state. Each trace gives the device busy ms a step. Returns
    the numbers."""
    from repro_torch.configs.pic_bit1 import make_config
    from repro_torch.distributed import engine
    from repro_torch.obs import metrics, tracing

    plain = engine_config(4, 4, make_config(mover_strategy="fused"))
    on = dataclasses.replace(plain, metrics=True)
    steps = {"P": pinned(engine.make_engine_step(plain), plain, counters,
                         "(a) overhead plain"),
             "M": pinned(engine.make_engine_step(on), on, counters,
                         "(a) overhead metrics")}
    steps["T"] = steps["P"]
    cfgs = {"P": plain, "T": plain, "M": on}
    state, _ = timed_steps(steps["P"], engine.init_engine_state(
        plain, 0, device=dev), 1)
    stream = metrics.MetricsStream()

    def record(k, diag, t0):
        torch.cuda.synchronize()
        stream.record(metrics.host_values(diag),
                      wall_us=(time.perf_counter() - t0) * 1e6)

    ms = {m: [] for m in "PTM"}
    busy, export, mib = [], [], []
    cur = "P"
    for w, mode in enumerate(OVERHEAD_ORDER):
        state = engine.retarget_state(cfgs[cur], cfgs[mode], state)
        cur = mode
        if mode == "T":
            tdir = OBS_DIR / f"overhead_trace{w}"
            t0 = time.perf_counter()
            with tracing.trace_session(str(tdir)):
                state, t = timed_steps(steps["T"], state, OVERHEAD_WINDOW)
            export.append(time.perf_counter() - t0 - sum(t) / 1e3)
            files = list(tdir.glob("*.trace.json"))
            if len(files) != 1:
                raise AssertionError(f"(a) overhead trace files {files}")
            mib.append(files[0].stat().st_size / 2**20)
            busy.append(busy_and_overlap(trace_intervals(files[0]))[0]
                        / 1e3 / OVERHEAD_WINDOW)
            shutil.rmtree(tdir)
        else:
            state, t = timed_steps(steps[mode], state, OVERHEAD_WINDOW,
                                   record if mode == "M" else None)
        ms[mode] += t
    if len(stream.window(999)) != len(ms["M"]):
        raise AssertionError("(a) overhead: metrics records missing")
    del state
    q = {m: quartiles(v) for m, v in ms.items()}
    out = dict(plain_ms=q["P"][1], traced_ms=q["T"][1],
               metrics_ms=q["M"][1], quartiles=q,
               busy_ms=statistics.median(busy),
               export_s=statistics.median(export),
               mib=statistics.median(mib))
    log(f"phase 10 (a) overhead, §3.3 field off D 4 x 4, windows of "
        f"{OVERHEAD_WINDOW} steps in the order {OVERHEAD_ORDER}: host "
        f"ms/step plain {[round(t, 3) for t in ms['P']]}, under the "
        f"profiler {[round(t, 3) for t in ms['T']]}, with the metrics "
        f"stream {[round(t, 3) for t in ms['M']]}; quartiles (25/50/75 %) "
        f"plain {q['P']}, profiler {q['T']}, metrics {q['M']}; device busy "
        f"a traced step {[round(b, 3) for b in busy]} ms; traces "
        f"{[round(m, 1) for m in mib]} MiB exported in "
        f"{[round(e, 2) for e in export]} s")
    return out


def obs_phase(dev):
    """Phase 10: the engine's observability and resilience at the §3.3
    configuration (field on, ionization, D 4 x async_n 4) and at its
    bitwise configuration; returns (launches summed over its paths,
    numbers)."""
    from repro_torch.distributed import engine
    from repro_torch.obs import metrics, tracing
    from repro_torch.obs.autotune import AutoTuner, TunerPolicy

    t_start = time.perf_counter()
    counters = pic_counters()
    shutil.rmtree(OBS_DIR, ignore_errors=True)
    OBS_DIR.mkdir(parents=True)
    full = engine_config(4, 4)
    exact = engine_config(4, 4, bitwise_pic())
    paths, numbers = {}, {}

    # (a) tracing: two steps under trace_session; every scope the steps
    # entered is a range of the trace, and the card's work is in it
    reset_launches(counters)
    # the phases' ranges: eager steps (a replay opens engine/graph/replay
    # alone)
    step = pinned(engine.make_engine_step(full, graph=False), full,
                  counters, "(a)")
    state, _ = timed_steps(step, engine.init_engine_state(
        full, 0, device=dev), 1)
    tdir = OBS_DIR / "trace"
    with tracing.capture_scopes() as seen:
        with tracing.trace_session(str(tdir)):
            state, _ = timed_steps(step, state, 2)
    files = list(tdir.glob("*.trace.json"))
    if len(files) != 1:
        raise AssertionError(f"(a) trace files {files}")
    names = tracing.trace_scope_names(str(files[0]))
    missing = sorted((set(seen) | set(STEP_SCOPES)) - names)
    device_events = len(trace_intervals(files[0]))
    if missing or not device_events:
        raise AssertionError(f"(a) the trace lacks {missing} ("
                             f"{device_events} device events)")
    mib = files[0].stat().st_size / 2**20
    log(f"phase 10 (a) tracing: 2 steps under trace_session hold all "
        f"{len(set(seen))} scope names entered ({len(names)} ranges), "
        f"{device_events} device events, {mib:.1f} MiB")
    shutil.rmtree(tdir)
    del state
    numbers["overhead"] = overhead_windows(counters, dev)
    paths["trace"] = launches(counters)

    # (b) metrics: five steps streamed to JSONL and validated; the
    # stream's own cost; the toggle bitwise
    reset_launches(counters)
    mcfg = dataclasses.replace(full, metrics=True)
    step = pinned(engine.make_engine_step(mcfg), mcfg, counters, "(b) on")
    jsonl = OBS_DIR / "metrics.jsonl"
    cost = []              # the stream's own host ms once the step is done
    with metrics.MetricsStream(jsonl_path=str(jsonl),
                               config={"domains": 4, "async_n": 4}) as st:
        def record(k, diag, t0):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            st.record(metrics.host_values(diag), wall_us=(t1 - t0) * 1e6,
                      step=k)
            cost.append((time.perf_counter() - t1) * 1e3)

        state, on = timed_steps(step, engine.init_engine_state(
            mcfg, 0, device=dev), 5, record)
    header, recs = metrics.read_jsonl(str(jsonl))
    errs = metrics.validate_stream([header] + recs)
    if errs or len(recs) != 5 or not all(
            f"{sc.name}/{k}" in r["counters"] for r in recs
            for sc in full.pic.species for k in ("ring_free",
                                                 "pending_rows")):
        raise AssertionError(f"(b) metrics stream: {errs[:5]}, "
                             f"{len(recs)} records")
    del state
    outs = {}
    for flag in (False, True):
        c = dataclasses.replace(exact, metrics=flag)
        stp = pinned(engine.make_engine_step(c), c, counters, "(b) exact")
        s = engine.init_engine_state(c, 0, device=dev)
        for _ in range(3):
            s, d = stp(s)
        outs[flag] = (s, metrics.host_values(d))
    check_states_bitwise("(b) metrics on vs off", outs[False][0],
                         outs[True][0])
    shared = outs[False][1]
    check_diags_bitwise("(b) metrics on vs off", [shared],
                        [{k: outs[True][1][k] for k in shared}])
    del outs, s
    torch.cuda.empty_cache()
    paths["metrics"] = launches(counters)
    numbers["metrics"] = dict(record_ms=statistics.median(cost))
    log(f"phase 10 (b) metrics: 5 records valid "
        f"({jsonl.stat().st_size} bytes); host ms/step with the stream "
        f"{[round(t, 3) for t in on]}; the stream's own ms a step, the "
        f"step done "
        f"{[round(t, 3) for t in cost]}"
        f"; the bitwise configuration (field and ionization off) equal in "
        f"every leaf and shared diag with metrics on and off after 3 steps")

    # (c) the restart drill, bitwise and at §3.3
    reset_launches(counters)
    ck_exact, numbers["ckpt_exact"] = restart_drill(
        exact, "bitwise configuration D 4 x 4", True, counters, dev,
        OBS_DIR / "ckpt_exact")
    shutil.rmtree(ck_exact.dir)
    ck, numbers["ckpt"] = restart_drill(
        full, "§3.3 field + ionization D 4 x 4", False, counters, dev,
        OBS_DIR / "ckpt")
    paths["restart"] = launches(counters)

    # (d) elastic restores of the §3.3 checkpoint
    reset_launches(counters)
    numbers["elastic_s"] = {d: elastic_restore(full, d, ck, counters, dev)
                            for d in (2, 1)}
    paths["elastic"] = launches(counters)
    shutil.rmtree(ck.dir)

    # (e) the auto-tuner from a migration budget that overflows
    reset_launches(counters)
    tuner = AutoTuner(dataclasses.replace(full, max_migration=4),
                      policy=TunerPolicy(window=2))
    state = engine.init_engine_state(tuner.ecfg, 0, device=dev)
    n0 = resident_counts(state)
    ionized = 0
    for k in range(8):
        per_step = engine_launches(tuner.ecfg)
        before = launches(counters)
        with tracing.capture_scopes() as names:
            state, diag = tuner.run_step(state)
        if graph_runs(names, per_step) != 1:
            raise AssertionError(f"(e) step {k}: scopes {names}")
        after = launches(counters)
        delta = {n: after[n] - before[n] for n in after}
        if delta != per_step:
            raise AssertionError(f"(e) step {k}: launches {delta}, "
                                 f"expected {per_step}")
        ionized += int(diag["n_ionized"])
        check_pairs(f"(e) step {k}", n0, [int(diag[f"{sc.name}/count"])
                                          for sc in full.pic.species],
                    ionized)
        if resident_counts(state) != [int(diag[f"{sc.name}/count"])
                                      for sc in full.pic.species]:
            raise AssertionError(f"(e) step {k}: resident counts moved")
    if tuner.retunes < 1:
        raise AssertionError(f"(e) no retune: {tuner.log}")
    overflow = sum(m.counters.get(f"{sc.name}/migration_overflow", 0.0)
                   for m in tuner.stream.window(99)
                   for sc in full.pic.species)
    numbers["retunes"] = tuner.retunes
    paths["autotune"] = launches(counters)
    log(f"phase 10 (e) auto-tuner: {tuner.retunes} retunes in 8 steps "
        f"({tuner.log}), migration overflow {overflow:.0f} rows in all, "
        f"pairs exact at every step (ionized {ionized}), launches pinned "
        f"for the config in force")
    del state
    torch.cuda.empty_cache()

    # (f) cross-device restore, (g) the launcher's command lines
    cross_device_restore(dev)
    paths.update({f"pic_run_{k}": v
                  for k, v in pic_run_drill(counters).items()})
    counts = {name: sum(p[name] for p in paths.values())
              for name in paths["trace"]}
    numbers["seconds"] = time.perf_counter() - t_start
    log(f"phase 10: {numbers['seconds']:.1f} s, launches summed over its "
        f"paths {counts}")
    shutil.rmtree(OBS_DIR, ignore_errors=True)
    return counts, numbers


# ---------------------------------------------------------------- phase 12 --

SERVE_WIDTH = 4
SERVE_SESSIONS = 8
SERVE_STEPS = 3
# the launcher's lines, as the reference launcher prints them
SERVE_LINE = re.compile(r"session s(\d+): slot=(\d+) steps=(\d+) "
                        r"ke=\{'D\+/ke': \S+, 'D/ke': \S+, 'e/ke': \S+\}")
SERVE_LAST = re.compile(r"(\d+) sessions x (\d+) steps, width=(\d+): "
                        r"[\d.]+s — stats (\{.*\})")
PIC_KERNELS = ("fused_push_deposit", "mover_push", "deposit", "ta_kick",
               "coulomb_pairs", "cell_density", "place_births")
SERVE_ARGV = ["--ensemble", "8", "--steps", "5", "--strategy", "fused"]


def serve_point(cfg, i, w):
    """Session i's point on the launcher's dt x ionization-rate grid."""
    return {"dt": cfg.dt * (1.0 + 0.1 * (i % w)),
            "ionization_rate": cfg.ionization_rate * (1 + i)}


def times_steps(svc):
    """Replace ``svc``'s ensemble step by one timed on the host from a
    synchronized card to the end of its work; returns the list the times
    (ms) go to."""
    inner, times = svc._step, []

    def step(es):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(es)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        return out

    svc._step = step
    return times


def serve_section(dev, cfg, solo, solo_ms, counters):
    """(a) ``SimService(width=4)`` at the §3.3 configuration: 8 sessions of
    3 steps on the launcher's grid, slots reused; exact pair accounting for
    every session at every step, every overflow counter 0, the launches of
    every ensemble step = running sessions x ``solo``, no build after the
    first step; host ms per ensemble step beside ``SERVE_WIDTH`` x
    ``solo_ms``, a 1-step profile and the peak memory."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import _build
    from repro_torch.serve import SimService

    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches(counters)
    svc = SimService(cfg, width=SERVE_WIDTH, device=dev)
    times = times_steps(svc)
    sids = [svc.submit(serve_point(cfg, i, SERVE_WIDTH), seed=i,
                       steps=SERVE_STEPS) for i in range(SERVE_SESSIONS)]
    prev = {sid: [sc.n_init for sc in cfg.species] for sid in sids}
    slots, ionized, built, k = {}, dict.fromkeys(sids, 0), None, 0
    while svc.stats()["running"]:
        running = [s for s in sids if svc.poll(s)["status"] == "running"]
        for s in running:
            slots.setdefault(s, svc.poll(s)["slot"])
        want = {n: len(running) * v for n, v in solo.items()}
        before = launches(counters)
        svc.step(1)
        after = launches(counters)
        delta = {n: after[n] - before[n] for n in after}
        if delta != want:
            raise AssertionError(f"(a) ensemble step {k}: launches {delta}, "
                                 f"expected {want}")
        if built is None:
            built = _build.builds
        elif _build.builds != built:
            raise AssertionError(f"(a) step {k}: {_build.builds - built} "
                                 f"kernel builds after the first step")
        for s in running:
            d = svc.poll(s)["diag"]
            now = [int(d[f"{sc.name}/count"]) for sc in cfg.species]
            n_ion = int(d["n_ionized"])
            check_pairs(f"(a) session {s} step {k}", prev[s], now, n_ion)
            for key in ("birth_overflow", "ionize_dropped"):
                if int(d[key]):
                    raise AssertionError(f"(a) session {s}: {key} = "
                                         f"{int(d[key])}")
            prev[s], ionized[s] = now, ionized[s] + n_ion
        k += 1
    done = [svc.poll(s) for s in sids]
    if (any(p["status"] != "done" or p["steps_done"] != SERVE_STEPS
            for p in done) or sorted(set(slots.values())) != list(
                range(SERVE_WIDTH))):
        raise AssertionError(f"(a) sessions {done}, slots {slots}")
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    paths = {"serve": launches(counters)}
    # one more wave of 4 for a 1-step profile (its first step)
    for i in range(SERVE_WIDTH):
        svc.submit(serve_point(cfg, i, SERVE_WIDTH), seed=100 + i, steps=2)
    svc.step(1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        svc.step(1)
        torch.cuda.synchronize()
    steady = statistics.median(times[1:k])
    report_profile(prof.key_averages(),
                   f"an ensemble step (W {SERVE_WIDTH}, §3.3)", 1, steady)
    if svc.stats()["compiles"] != built:
        raise AssertionError("(a) a kernel was built after the first step")
    log(f"phase 12 (a) SimService W {SERVE_WIDTH} at §3.3: "
        f"{SERVE_SESSIONS} sessions x {SERVE_STEPS} steps in {k} ensemble "
        f"steps, slots {slots}, ionized a session {list(ionized.values())}"
        f", pairs exact at every step, overflow 0; host ms an ensemble "
        f"step {[round(t, 3) for t in times[:k]]} (median after the first "
        f"{steady:.3f}) against {SERVE_WIDTH} x the solo step "
        f"{SERVE_WIDTH * solo_ms:.3f}; peak memory {peak:.2f} GiB; "
        f"launches a member step {solo}; builds {built} (none after the "
        f"first step)")
    numbers = {"ensemble_ms": steady, "solo_ms": solo_ms, "peak_gib": peak,
               "step_ms": times[:k]}
    del svc
    torch.cuda.empty_cache()
    return paths, numbers


def collision_serve(dev, counters):
    """(a') the collision menu with the deflection kernel at §3.3, W 2,
    its rates moved in one member: launches = active x the solo step's."""
    from repro_torch.kernels.deposit import deposit_form
    from repro_torch.serve import SimService

    cfg = collision_config()
    solo = expected(deposit_form(cfg.nc + 1), fused=1, **menu_launches(cfg))
    reset_launches(counters)
    svc = SimService(cfg, width=2, device=dev)
    base = tuple(cc.rate for cc in cfg.collisions)
    a = svc.submit({}, seed=1, steps=2)
    b = svc.submit({"collision_rates": tuple(2 * r for r in base),
                    "dt": 0.25}, seed=1, steps=2)
    svc.run_until_drained()
    got = launches(counters)
    want = {n: 4 * v for n, v in solo.items()}
    if got != want:
        raise AssertionError(f"(a') launches {got}, expected {want}")
    da, db = svc.poll(a)["diag"], svc.poll(b)["diag"]
    tallies = {s: {key: int(d[key]) for key in COLL_KEYS}
               for s, d in ((a, da), (b, db))}
    if min(min(t.values()) for t in tallies.values()) <= 0 or \
            tallies[a] == tallies[b]:
        raise AssertionError(f"(a') collision tallies {tallies}")
    log(f"phase 12 (a') collision menu W 2 at §3.3 (T-A kernel): last-step "
        f"tallies {tallies} (rates doubled in {b}), launches {got}")
    del svc
    torch.cuda.empty_cache()
    return got


def bitwise_section(dev, counters):
    """(b) the bitwise configuration (§3.3, field and ionization off: no
    float atomics) at W 3: a member equal to its solo run bit for bit, a
    parked slot frozen with zero diagnostics, and the params path equal to
    the static path, single-domain and on the engine at D 4 x async_n 2."""
    from repro_torch.core import pic
    from repro_torch.core.params import runtime_params
    from repro_torch.distributed import engine
    from repro_torch.kernels.deposit import deposit_form
    from repro_torch.serve import ensemble

    cfg = bitwise_pic()
    solo = expected(deposit_form(cfg.nc + 1), fused=1)
    paths = {}
    reset_launches(counters)
    points = [runtime_params(cfg, dt=cfg.dt * f, device=dev)
              for f in (1.0, 0.9, 1.1)]
    es = ensemble.init_ensemble(cfg, 3, device=dev)
    init = ensemble.make_member_init(cfg, device=dev)
    insert = ensemble.make_member_insert(cfg)
    for slot, rp in enumerate(points):
        es = insert(es, init(20 + slot), rp, slot)
    step = ensemble.make_ensemble_step(cfg)
    es, _ = step(es)
    es = ensemble.make_member_release(cfg)(es, 2)
    parked = es.pic[2]
    fields = ("x", "v", "w", "alive")
    frozen = [getattr(b, f).clone() for b in parked.species for f in fields]
    gen_parked = parked.gen.get_state().clone()
    for k in range(2):
        before = launches(counters)
        es, diag = step(es)
        after = launches(counters)
        delta = {n: after[n] - before[n] for n in after}
        if delta != {n: 2 * v for n, v in solo.items()}:
            raise AssertionError(f"(b) step {k}: launches {delta}")
        if any(bool(v[2].any()) for v in diag.values()):
            raise AssertionError("(b) the parked slot reported diagnostics")
    now = [getattr(b, f) for b in parked.species for f in fields]
    if not (all(torch.equal(a, b) for a, b in zip(frozen, now))
            and torch.equal(parked.gen.get_state(), gen_parked)
            and es.pic[2] is parked and parked.step == 1):
        raise AssertionError("(b) the parked slot's state moved")
    del frozen, now
    paths["ensemble"] = launches(counters)
    # the member of slot 1 against the same member run alone
    reset_launches(counters)
    alone = init(21)
    for _ in range(3):
        alone, _ = pic.step_fn(alone, cfg, points[1])
    check_pic_bitwise("(b) member 1 vs alone", es.pic[1], alone)
    del es, alone, parked
    torch.cuda.empty_cache()
    # params against static, single-domain
    a = pic.init_state(cfg, 7, device=dev)
    b = pic.init_state(cfg, 7, device=dev)
    rp = runtime_params(cfg, device=dev)
    for _ in range(3):
        a, da = pic.step_fn(a, cfg)
        b, db = pic.step_fn(b, cfg, rp)
        if any(not torch.equal(da[key], db[key]) for key in da):
            raise AssertionError("(b) params vs static: diag differs")
    check_pic_bitwise("(b) params vs static", a, b)
    paths["single"] = launches(counters)
    del a, b
    torch.cuda.empty_cache()
    # params against static on the engine, D 4 x async_n 2
    reset_launches(counters)
    ecfg = engine_config(4, 2, cfg)
    sa = engine.init_engine_state(ecfg, 7, device=dev)
    sb = engine.init_engine_state(ecfg, 7, device=dev)
    static = pinned(engine.make_engine_step(ecfg), ecfg, counters,
                    "(b) engine static")
    params = pinned(engine.make_engine_step(ecfg, with_params=True), ecfg,
                    counters, "(b) engine params")
    da_all, db_all = [], []
    for _ in range(3):
        sa, da = static(sa)
        sb, db = params(sb, rp)
        da_all.append({key: v.cpu().numpy() for key, v in da.items()})
        db_all.append({key: v.cpu().numpy() for key, v in db.items()})
    check_states_bitwise("(b) engine params vs static", sa, sb)
    check_diags_bitwise("(b) engine params vs static", da_all, db_all)
    paths["engine"] = launches(counters)
    log(f"phase 12 (b) bitwise configuration: W 3 member 1 equal to its "
        f"solo run bit for bit (every tensor and the generator), the "
        f"parked slot frozen with zero diagnostics (launches 2 x {solo} a "
        f"step), params = static bit for bit single-domain (3 steps) and "
        f"on the engine at D 4 x async_n 2 (3 steps, every leaf, generator "
        f"and diagnostic)")
    del sa, sb
    torch.cuda.empty_cache()
    return paths


def check_pic_bitwise(label, a, b):
    """Every tensor of two PICStates and their generator states equal."""
    same = all(torch.equal(getattr(x, f), getattr(y, f))
               for x, y in zip(a.species, b.species)
               for f in ("x", "v", "w", "alive"))
    same = same and (a.rho is None) == (b.rho is None) and (
        a.rho is None or torch.equal(a.rho, b.rho))
    if not (same and a.step == b.step
            and torch.equal(a.gen.get_state(), b.gen.get_state())):
        raise AssertionError(f"{label}: states differ")


def ensemble_card_vs_cpu(dev, counters):
    """(c) a width-2 ensemble on the small bench configuration (field solve
    on, rho carried), card against CPU on the same states and draws for 3
    steps: each member within phase 5's bands."""
    import numpy as np

    from repro_torch.configs.pic_bit1 import make_bench_config
    from repro_torch.core import pic
    from repro_torch.core.params import runtime_params
    from repro_torch.serve import ensemble

    cfg = dataclasses.replace(make_bench_config(strategy="fused"),
                              field_solve=True)
    reset_launches(counters)
    pts = ({"dt": 0.2, "ionization_rate": 2e-4},
           {"dt": 0.23, "ionization_rate": 5e-4})
    cpu = ensemble.init_ensemble(cfg, 2, device="cpu")
    card = ensemble.init_ensemble(cfg, 2, device=dev)
    insert = ensemble.make_member_insert(cfg)
    for slot, pt in enumerate(pts):
        m = pic.init_state(cfg, 30 + slot, device="cpu")
        arrays = [{"x": b.x.numpy(), "v": b.v.numpy(), "w": b.w.numpy(),
                   "alive": b.alive.numpy()} for b in m.species]
        insert(cpu, m, runtime_params(cfg, device="cpu", **pt), slot)
        insert(card, pic.state_from_numpy(cfg, arrays, 0, m.rho.numpy(),
                                       device=dev),
            runtime_params(cfg, device=dev, **pt), slot)
    step = ensemble.make_ensemble_step(cfg)
    rng = np.random.default_rng(12)
    cap = cfg.species[cfg.ionization[0]].capacity
    length = cfg.length
    worst = [0.0, 0.0, 0.0]
    for k in range(3):
        draws = {s: [{"uniform": rng.random(cap, dtype=np.float32),
                      "normal": rng.standard_normal((cap, 3),
                                                    dtype=np.float32)}]
                 for s in range(2)}
        cpu, dc = step(cpu, draws)
        card, dg = step(card, draws)
        for key in ("n_ionized", "birth_overflow", "e/count", "D+/count",
                    "D/count"):
            if not torch.equal(dc[key], dg[key].cpu()):
                raise AssertionError(f"(c) step {k}: {key} {dg[key]} vs "
                                     f"{dc[key]}")
        for s in range(2):
            mc, mg = cpu.pic[s], card.pic[s]
            ex = ev = 0.0
            for bc, bg in zip(mc.species, mg.species):
                check_equal(f"(c) alive step {k} member {s}", bg.alive.cpu(),
                            bc.alive)
                ex = max(ex, periodic_err(bg.x.cpu(), bc.x, length))
                vmax = float(bc.v.abs().max())
                ev = max(ev, max_err(bg.v.cpu(), bc.v) / (1.0 + vmax))
            er = max_err(mg.rho.cpu(), mc.rho)
            rmax = float(mc.rho.abs().max())
            if ex > 1e-5 * length or ev > 1e-4 or \
                    er > RHO_TOL * (1.0 + rmax):
                raise AssertionError(f"(c) step {k} member {s}: x {ex}, v "
                                     f"{ev}, rho {er} (max {rmax})")
            worst = [max(worst[0], ex), max(worst[1], ev),
                     max(worst[2], er)]
    ion = [int(v) for v in dg["n_ionized"].cpu()]
    log(f"phase 12 (c) ensemble W 2 card vs CPU (bench, field on, 3 "
        f"steps): counts and alive equal, ionized at the last step {ion}, "
        f"max |dx| {worst[0]:.3g}, max |dv|/(1+max|v|) {worst[1]:.3g}, max "
        f"|drho| {worst[2]:.3g}")
    return launches(counters)


def engine_params_section(dev, counters):
    """(d) ``make_engine_step(with_params=True)`` at §3.3 (field on,
    ionization, D 4 x async_n 4), 3 steps, a second parameter point from
    the second step: exact pair accounting, every overflow counter 0,
    launches pinned by ``engine_launches``, no build after the first step."""
    from repro_torch.core.params import runtime_params
    from repro_torch.distributed import engine
    from repro_torch.kernels import _build

    ecfg = engine_config(4, 4)
    cfg = ecfg.pic
    reset_launches(counters)
    points = [runtime_params(cfg, device=dev),
              runtime_params(cfg, dt=cfg.dt * 0.9,
                             ionization_rate=2 * cfg.ionization_rate,
                             device=dev)]
    step = pinned(engine.make_engine_step(ecfg, with_params=True), ecfg,
                  counters, "(d)")
    state = engine.init_engine_state(ecfg, 0, device=dev)
    n0 = resident_counts(state)
    ionized, built, times = 0, None, []
    for k in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, diag = step(state, points[min(k, 1)])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        built = _build.builds if built is None else built
        if _build.builds != built:
            raise AssertionError("(d) a kernel was built after the first "
                                 "step")
        for key, v in diag.items():
            if key.rsplit("/", 1)[-1] in ("birth_overflow",
                                          "migration_overflow",
                                          "merge_dropped") and int(v):
                raise AssertionError(f"(d) step {k}: {key} = {int(v)}")
        ionized += int(diag["n_ionized"])
        counts = [int(diag[f"{sc.name}/count"]) for sc in cfg.species]
        check_pairs(f"(d) step {k}", n0, counts, ionized)
    if counts != resident_counts(state):
        raise AssertionError("(d) diag counts are not resident + pending")
    log(f"phase 12 (d) engine with_params at §3.3 (field, ionization, D 4 x "
        f"async_n 4): 3 steps, point 2 from the second, ms/step "
        f"{[round(t, 3) for t in times]}, ionized {ionized}, pairs exact, "
        f"overflow 0, launches a step {engine_launches(ecfg)}, no build "
        f"after the first step")
    del state
    torch.cuda.empty_cache()
    return launches(counters)


def serve_launcher(counters):
    """(e) ``pic_run --ensemble 8 --steps 5 --strategy fused`` at its
    defaults: the reference launcher's lines, 16 sessions of 5 steps, one
    fused, one deposit and one births launch a member step."""
    import contextlib
    import io

    from repro_torch.launch import pic_run

    argv = SERVE_ARGV
    reset_launches(counters)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        pic_run.main(argv)
    lines = buf.getvalue().strip().splitlines()
    got = launches(counters)
    sessions = [SERVE_LINE.fullmatch(ln) for ln in lines[:-1]]
    last = SERVE_LAST.fullmatch(lines[-1])
    if (len(lines) != 17 or not all(sessions) or not last
            or last.groups()[:3] != ("16", "5", "8")
            or any(m.group(3) != "5" for m in sessions)
            or got["fused_push_deposit"] != 80 or got["deposit"] != 80
            or got["place_births"] != 80):
        raise AssertionError(f"(e) pic_run {' '.join(argv)}: lines {lines}, "
                             f"launches {got}")
    for ln in (lines[0], lines[-1]):
        log(f"phase 12 (e) pic_run {' '.join(argv)}: {ln}")
    log(f"phase 12 (e) launches {got}")
    return got


def serve_phase(dev, solo_ms):
    """Phase 12: runtime parameters and the serving layer on the card;
    returns (launches summed over its paths, numbers)."""
    from repro_torch.configs.pic_bit1 import make_config
    from repro_torch.kernels import deposit

    t_start = time.perf_counter()
    counters = pic_counters()
    cfg = make_config(mover_strategy="fused")
    solo = expected(deposit.deposit_form(cfg.nc + 1), fused=1, deposit=1,
                    births=1)
    paths, numbers = serve_section(dev, cfg, solo, solo_ms, counters)
    paths["collisions"] = collision_serve(dev, counters)
    paths.update(bitwise_section(dev, counters))
    paths["card_vs_cpu"] = ensemble_card_vs_cpu(dev, counters)
    paths["engine_params"] = engine_params_section(dev, counters)
    paths["pic_run"] = serve_launcher(counters)
    counts = {name: sum(p[name] for p in paths.values())
              for name in PIC_KERNELS}
    # the mover kernel serves 'explicit' only, which refuses params
    for name in ("fused_push_deposit", "deposit", "coulomb_pairs",
                 "cell_density", "place_births"):
        if counts[name] <= 0:
            raise AssertionError(f"phase 12: {name} never launched")
    numbers["seconds"] = time.perf_counter() - t_start
    log(f"phase 12: {numbers['seconds']:.1f} s, launches summed over its "
        f"paths {counts}")
    return counts, numbers


# ---------------------------------------------------------------- phase 7 --

def rel_err(got, want) -> float:
    g, w = got.float(), want.float()
    return float((g - w).abs().max() / w.abs().max())


def check_logits(label, logits, vocab):
    if logits.shape[-1] != vocab or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{label}: logits {tuple(logits.shape)} not "
                             f"finite of width {vocab}")


# ---------------------------------------------------------------- phase 8 --

CARD_CPU_BAND = 1e-4


def agree(label, got, want, band=CARD_CPU_BAND):
    """Card logits within band of max |CPU logits|; greedy tokens equal
    wherever the top-2 gap of the CPU's logits exceeds the band."""
    got = got.cpu()
    rel = rel_err(got, want)
    top2 = torch.topk(want, 2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > band * float(want.abs().max())
    same = torch.argmax(got, -1) == torch.argmax(want, -1)
    if not (rel < band and bool(same[clear].all())):
        raise AssertionError(f"LM card vs CPU {label}: rel {rel}, "
                             f"{int((~same & clear).sum())} clear greedy "
                             f"tokens differ")
    return rel, int(clear.sum()), int(clear.numel())


def tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: tree_to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


# ---------------------------------------------------------------- phase 13 --

# the LM serving runs at full width: (batch, prompt) of the prefill, the
# flash launches a prefill makes (one an attention: qwen2's 24 layers,
# recurrentgemma's 8 local layers, none in mamba2, whisper's 6 encoder + 6
# decoder + 6 cross, dbrx's 2 layers), and the prompt of the serving run
# fed by decode steps
FAMILIES = {LM_ARCH: ((8, 4096), 24, 512),
            "recurrentgemma-2b": ((4, 4096), 8, 512),
            "mamba2-2.7b": ((4, 4096), 0, 512),
            "whisper-base": ((4, 448), 18, 64),
            "dbrx-132b": ((2, 4096), 2, 512)}
# decode vs prefill in bf16 is a gate where the two paths' rounding stays
# within 0.02: not for the MoE, whose bf16 router may pick another expert
# for a token whose logits the two paths round differently, nor for
# mamba2's 64 layers, through which bf16 rounding grows with depth in the
# reference as in the port (``tests/test_torch_ssm.py``); mamba2's decode
# is gated against its prefill in f32 instead, at F32_DECODE_BAND
DECODE_GATED = (LM_ARCH, "recurrentgemma-2b", "whisper-base")
F32_DECODE_GATED = ("mamba2-2.7b",)
F32_DECODE_BAND = 1e-3
SERVE_BATCH, SERVE_NEW = 4, 32
# the runs profiled whole: one prefill each
PROFILED_PREFILL = (LM_ARCH, "recurrentgemma-2b")
# the launcher at full size, once for each of these archs
SERVE_LM_ARCHS = (LM_ARCH, "recurrentgemma-2b")
SERVE_LM_ARGV = ["--full", "--batch", "4", "--prompt-len", "512",
                 "--tokens", "32"]


def family_config(arch):
    """The arch's published config; dbrx cut to 2 of its 40 layers (every
    matrix keeps its published shape)."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    return dataclasses.replace(cfg, n_layers=2) if arch == "dbrx-132b" \
        else cfg


class RouteLog:
    """Records the MoE's routes while open: per moe_ffn call, the chosen
    experts (g, s, k) and the keep-mask (g, s, k), on the host."""

    def __enter__(self):
        from repro_torch.models import moe

        self.moe, self.calls = moe, []
        self.route, self.plan = moe.route_topk, moe.dispatch_plan

        def route(logits, k):
            w, idx = self.route(logits, k)
            self.calls.append({"idx": idx.cpu()})
            return w, idx

        def plan(idx, e, cap):
            pos, keep = self.plan(idx, e, cap)
            self.calls[-1]["keep"] = keep.cpu()
            return pos, keep

        moe.route_topk, moe.dispatch_plan = route, plan
        return self

    def __exit__(self, *exc):
        self.moe.route_topk, self.moe.dispatch_plan = self.route, self.plan

    def dropped(self) -> float:
        keep = torch.cat([c["keep"].flatten() for c in self.calls])
        return 1.0 - float(keep.float().mean())


def frames_for(cfg, b, dev, seed=2):
    """whisper's stub frames, 0.1 x normal (b, enc_seq, d) from a seed."""
    return 0.1 * torch.randn((b, cfg.enc_seq, cfg.d_model), device=dev,
                             generator=torch.Generator(
                                 device=dev).manual_seed(seed)).to(cfg.dtype)


def family_serve(dev, arch):
    """One family at full width through the entry points: two prefills
    (flash launches pinned, logits at the last position), then decode
    steps over SERVE_BATCH prompts and SERVE_NEW greedy tokens (no flash
    launch), and decode vs prefill over the prompts. Returns (flash
    launches, numbers)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import whisper
    from repro_torch.models.registry import build
    from repro_torch.train.serve_step import make_prefill, make_serve_step

    (b, s), want, plen = FAMILIES[arch]
    cfg = family_config(arch)
    model = build(cfg)
    t0 = time.perf_counter()
    params = model.init_params(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    out = {"init_s": time.perf_counter() - t0,
           "params_b": cfg.num_params() / 1e9}
    gen = torch.Generator(device=dev).manual_seed(1)
    encdec = cfg.kind == "encdec"
    launches = 0

    def run_prefill(prefill, tokens, aux, label):
        nonlocal launches
        fa.flash_attention.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hidden, aux_loss = prefill(params, tokens, aux)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        n = fa.flash_attention.launches
        if n != want:
            raise AssertionError(f"{arch} {label}: {n} flash launches, "
                                 f"expected {want}")
        launches += n
        return hidden, aux_loss, ms

    prefill = make_prefill(cfg)
    tokens = torch.randint(0, cfg.vocab, (b, s), generator=gen, device=dev)
    aux = frames_for(cfg, b, dev) if encdec else None
    times = []
    for k in range(2):
        torch.cuda.reset_peak_memory_stats(dev)
        with RouteLog() as routes:
            hidden, aux_loss, ms = run_prefill(prefill, tokens, aux,
                                               f"prefill {k}")
        times.append(ms)
        last = model.logits(params, hidden[:, -1:])
        check_logits(f"{arch} prefill", last, cfg.vocab)
        del hidden, last
    out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    out["prefill_ms"] = times[-1]
    out["prefill_tok_s"] = b * s / (times[-1] / 1e3)
    moe_line = ""
    if cfg.kind == "moe":
        out["dropped"] = routes.dropped()
        moe_line = (f", {100 * out['dropped']:.3f} % of (token, k) routes "
                    f"dropped at capacity {cfg.capacity_factor}, aux "
                    f"{float(aux_loss):.4f}")
    log(f"{arch} ({out['params_b']:.3f} B parameters, {cfg.n_layers} layers"
        f", init {out['init_s']:.1f} s) prefill {b} x {s}: ms "
        f"{[round(x, 3) for x in times]} ({out['prefill_tok_s']:.0f} prompt "
        f"tok/s), peak memory {out['peak_gib']:.2f} GiB, flash launches "
        f"{want} a prefill{moe_line}")
    if arch in PROFILED_PREFILL:
        torch.cuda.empty_cache()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            hidden, _ = prefill(params, tokens, aux)
            torch.cuda.synchronize()
        report_profile(prof.key_averages(),
                       f"one {arch} prefill of {b} x {s}", 1, times[-1])
        del hidden
    del tokens
    torch.cuda.empty_cache()

    # serve: prompts fed by teacher-forced decode steps, then greedy tokens
    bs = SERVE_BATCH
    prompts = torch.randint(0, cfg.vocab, (bs, plen), generator=gen,
                            device=dev)
    frames = frames_for(cfg, bs, dev, seed=3) if encdec else None
    cache = model.init_cache(bs, plen + SERVE_NEW + 1, dev)
    if encdec:
        fa.flash_attention.launches = 0
        cache = whisper.prefill_cross(cfg, params, cache, frames)
        n = fa.flash_attention.launches
        if n != cfg.enc_layers:
            raise AssertionError(f"{arch} prefill_cross: {n} flash launches")
        launches += n
    serve = make_serve_step(cfg)
    dec = torch.empty(bs, plen, cfg.vocab, dtype=cfg.dtype, device=dev)
    fa.flash_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with RouteLog() as dec_routes:
        for t in range(plen):
            lg, cache = model.decode_step(params, prompts[:, t:t + 1], cache,
                                          t)
            dec[:, t] = lg[:, 0]
    torch.cuda.synchronize()
    prompt_ms = (time.perf_counter() - t0) * 1e3 / plen
    nxt = torch.argmax(dec[:, -1], dim=-1).to(torch.int32)[:, None]
    generated, step_ms = [nxt], []
    for t in range(plen, plen + SERVE_NEW):
        t0 = time.perf_counter()
        nxt, cache = serve(params, nxt, cache, t)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        generated.append(nxt)
    if fa.flash_attention.launches:
        raise AssertionError(f"{arch} decode launched flash "
                             f"{fa.flash_attention.launches} times")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        serve(params, nxt, cache, plen + SERVE_NEW)
        torch.cuda.synchronize()
    prof_row = report_profile(prof.key_averages(),
                              f"one {arch} decode step at batch {bs}", 1,
                              statistics.median(step_ms))
    out["decode_kernels"] = prof_row[1] if prof_row else None
    gen_tok = torch.cat(generated, dim=1)
    check_logits(f"{arch} decode", dec, cfg.vocab)
    if not bool(((gen_tok >= 0) & (gen_tok < cfg.vocab)).all()):
        raise AssertionError(f"{arch}: a generated token lies outside the "
                             f"vocabulary")
    out["decode_ms"] = statistics.median(step_ms)
    out["decode_tok_s"] = bs * SERVE_NEW / (sum(step_ms) / 1e3)
    log(f"{arch} serve: batch {bs}, {plen}-token prompts by decode steps "
        f"({prompt_ms:.3f} ms a step), then {SERVE_NEW} greedy tokens: "
        f"{out['decode_ms']:.3f} ms a decode step (median), "
        f"{out['decode_tok_s']:.1f} tok/s, {out['decode_kernels']} kernels "
        f"a decode step, flash launches 0; first row "
        f"{gen_tok[0, :8].tolist()}")
    del cache

    # decode against prefill on the same prompts (the MoE without drops,
    # as a decode step never drops: capacity_factor 100)
    cmp_cfg = dataclasses.replace(cfg, capacity_factor=100.0) \
        if cfg.kind == "moe" else cfg
    with RouteLog() as pre_routes:
        hidden, _, _ = run_prefill(make_prefill(cmp_cfg), prompts, frames,
                                   "prefill of the serve prompts")
    ref = model.logits(params, hidden)
    rel = rel_err(dec, ref)
    out["decode_vs_prefill_rel"] = rel
    route_line = ""
    if cfg.kind == "moe":
        # decode calls run step-major, layer-minor; the prefill's by layer
        d_idx = torch.stack([c["idx"][:, 0] for c in dec_routes.calls])
        d_idx = d_idx.reshape(plen, cfg.n_layers, bs, -1).permute(1, 2, 0, 3)
        p_idx = torch.stack([c["idx"] for c in pre_routes.calls])
        same = (torch.sort(d_idx, -1).values
                == torch.sort(p_idx, -1).values).all(-1)
        route_line = (f"; expert sets equal on "
                      f"{100 * float(same.float().mean()):.3f} % of (layer, "
                      f"token)")
    log(f"{arch} decode vs prefill logits over {bs} x {plen} prompt "
        f"positions: max |diff| / max |logits| = {rel:.4g} (band 0.02"
        f"{'' if arch in DECODE_GATED else ', reported'}){route_line}")
    if arch in DECODE_GATED and not rel < 0.02:
        raise AssertionError(f"{arch} decode vs prefill logits: rel {rel}")
    del hidden, ref, dec, params
    torch.cuda.empty_cache()
    return launches, out


def f32_decode_vs_prefill(dev, arch, plen=128):
    """The family at full width and depth in f32: decode steps over
    SERVE_BATCH prompts of ``plen`` tokens against the prefill of the same
    prompts, within F32_DECODE_BAND of max |logits|."""
    from repro_torch.models.registry import build
    from repro_torch.train.serve_step import make_prefill

    cfg = dataclasses.replace(family_config(arch), dtype=torch.float32)
    model = build(cfg)
    params = model.init_params(torch.Generator(device=dev).manual_seed(0))
    prompts = torch.randint(0, cfg.vocab, (SERVE_BATCH, plen), device=dev,
                            generator=torch.Generator(
                                device=dev).manual_seed(6))
    cache = model.init_cache(SERVE_BATCH, plen, dev)
    dec = torch.empty(SERVE_BATCH, plen, cfg.vocab, device=dev)
    for t in range(plen):
        lg, cache = model.decode_step(params, prompts[:, t:t + 1], cache, t)
        dec[:, t] = lg[:, 0]
    hidden, _ = make_prefill(cfg)(params, prompts)
    rel = rel_err(dec, model.logits(params, hidden))
    log(f"{arch} in f32 (full width and depth): decode vs prefill logits "
        f"over {SERVE_BATCH} x {plen} prompt positions: max |diff| / max "
        f"|logits| = {rel:.4g} (band {F32_DECODE_BAND})")
    if not rel < F32_DECODE_BAND:
        raise AssertionError(f"{arch} f32 decode vs prefill logits: rel "
                             f"{rel}")
    del params, cache, dec, hidden
    torch.cuda.empty_cache()
    return rel


def smoke_families(dev):
    """llama4-maverick and internvl2 at their SMOKE configs: a prefill
    (internvl2 with its prefix embeddings), 16 decode steps, decode vs
    prefill reported. Returns the flash launches."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.registry import build
    from repro_torch.train.serve_step import make_prefill

    launches = 0
    for arch in ("llama4-maverick-400b-a17b", "internvl2-26b"):
        cfg = get_smoke_config(arch)
        model = build(cfg)
        params = model.init_params(torch.Generator(device=dev).manual_seed(0))
        gen = torch.Generator(device=dev).manual_seed(1)
        b, s = 2, 256
        tokens = torch.randint(0, cfg.vocab, (b, s), generator=gen,
                               device=dev)
        prefix = None
        if cfg.kind == "vlm":
            prefix = 0.1 * torch.randn((b, cfg.frontend_tokens, cfg.d_model),
                                       generator=gen, device=dev)
        fa.flash_attention.launches = 0
        hidden, aux = make_prefill(cfg)(params, tokens, prefix)
        n = fa.flash_attention.launches
        if n != cfg.n_layers or hidden.shape[1] != s + cfg.frontend_tokens:
            raise AssertionError(f"{arch} smoke prefill: {n} flash launches,"
                                 f" hidden {tuple(hidden.shape)}")
        launches += n
        check_logits(f"{arch} smoke", model.logits(params, hidden),
                     cfg.vocab)
        steps = 16
        cache = model.init_cache(b, steps, dev)
        dec = []
        for t in range(steps):
            lg, cache = model.decode_step(params, tokens[:, t:t + 1], cache,
                                          t)
            dec.append(lg[:, 0])
        cmp_cfg = dataclasses.replace(cfg, capacity_factor=100.0) \
            if cfg.kind == "moe" else cfg
        fa.flash_attention.launches = 0
        h, _ = make_prefill(cmp_cfg)(params, tokens[:, :steps])
        launches += fa.flash_attention.launches
        rel = rel_err(torch.stack(dec, 1), model.logits(params, h))
        with_prefix = (f" + a prefix of {cfg.frontend_tokens}"
                       if prefix is not None else "")
        log(f"{arch} smoke config on the card: prefill {b} x {s}"
            f"{with_prefix}, {n} flash launches, aux {float(aux):.4f}; "
            f"{steps} decode steps vs prefill rel {rel:.4g} (reported)")
        del params, cache
    return launches


# card against CPU in f32: the cut of each family's config and its prompt
CARD_CPU_FAMILIES = ((LM_ARCH, "CONFIG", dict(n_layers=2), 128),
                     ("recurrentgemma-2b", "CONFIG", dict(n_layers=3), 128),
                     ("mamba2-2.7b", "CONFIG", dict(n_layers=2), 128),
                     ("whisper-base", "CONFIG",
                      dict(n_layers=2, enc_layers=2), 128),
                     ("dbrx-132b", "SMOKE", {}, 256),
                     ("llama4-maverick-400b-a17b", "SMOKE", {}, 256))


def family_card_vs_cpu(dev):
    """Each family in f32 on the same weights and prompt, card against
    CPU: prefill and decode logits within CARD_CPU_BAND of max |logits|
    and 8 greedy steps on, both fed the CPU's choice; greedy tokens equal
    wherever the CPU's top-2 gap exceeds the band; the MoE's experts and
    keep-masks equal."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models import whisper
    from repro_torch.models.registry import build

    for arch, which, cut, plen in CARD_CPU_FAMILIES:
        base = (get_config if which == "CONFIG" else get_smoke_config)(arch)
        cfg = dataclasses.replace(base, dtype=torch.float32, **cut)
        model = build(cfg)
        cpu = model.init_params(torch.Generator().manual_seed(3))
        card = tree_to(cpu, dev)
        tokens = torch.randint(0, cfg.vocab, (1, plen),
                               generator=torch.Generator().manual_seed(4))
        frames = None
        if cfg.kind == "encdec":
            frames = 0.1 * torch.randn(
                (1, cfg.enc_seq, cfg.d_model),
                generator=torch.Generator().manual_seed(5))
        results = []
        for params, device in ((cpu, "cpu"), (card, dev)):
            with RouteLog() as routes:
                h, _ = model.forward(params, tokens.to(device),
                                     None if frames is None else
                                     frames.to(device))
                pre = model.logits(params, h)
                cache = model.init_cache(1, plen + 8, device)
                if frames is not None:
                    cache = whisper.prefill_cross(cfg, params, cache,
                                                  frames.to(device))
                steps = []
                for t in range(plen):
                    lg, cache = model.decode_step(
                        params, tokens[:, t:t + 1].to(device), cache, t)
                    steps.append(lg[:, 0])
            results.append((pre, torch.stack(steps, 1), cache, routes.calls))
        (pc, dc, cc, rc), (pg, dg, cg, rg) = results
        r_pre = agree(f"{arch} prefill", pg, pc)
        r_dec = agree(f"{arch} decode", dg, dc)
        nxt, gaps = torch.argmax(dc[:, -1], -1)[:, None], []
        for t in range(plen, plen + 8):
            lc, cc = model.decode_step(cpu, nxt, cc, t)
            lg, cg = model.decode_step(card, nxt.to(dev), cg, t)
            gaps.append(agree(f"{arch} greedy step {t}", lg[:, 0],
                              lc[:, 0])[0])
            nxt = torch.argmax(lc[:, 0], -1)[:, None]
        line = ""
        if cfg.kind == "moe":
            if len(rc) != len(rg):
                raise AssertionError(f"{arch}: {len(rc)} vs {len(rg)} routes")
            for a, b in zip(rc, rg):
                check_equal(f"{arch} card vs CPU experts", a["idx"], b["idx"])
                check_equal(f"{arch} card vs CPU keep", a["keep"], b["keep"])
            drops = sum(int((~c["keep"]).sum()) for c in rc)
            line = (f"; experts and keep-masks equal in all {len(rc)} MoE "
                    f"calls ({drops} routes dropped)")
            if drops == 0:
                raise AssertionError(f"{arch}: no route dropped at "
                                     f"{plen} tokens")
        log(f"{arch} card vs CPU ({which} width {cfg.d_model}, "
            f"{cfg.n_layers} layers, f32, {plen}-token prompt): prefill rel "
            f"{r_pre[0]:.3g} (greedy equal on {r_pre[1]}/{r_pre[2]} clear "
            f"positions), decode rel {r_dec[0]:.3g} ({r_dec[1]}/{r_dec[2]})"
            f", 8 greedy steps max rel {max(gaps):.3g}{line}")
        del cpu, card
        torch.cuda.empty_cache()


def family_phase(dev):
    """Phases 7, 8 and 13: every LM serving run, the launcher, and card
    against CPU. Returns (flash launches summed over the paths, numbers by
    arch)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve_lm

    t0 = time.perf_counter()
    launches, nums = 0, {}
    for arch in FAMILIES:
        n, nums[arch] = family_serve(dev, arch)
        launches += n
        if arch in F32_DECODE_GATED:
            nums[arch]["f32_decode_vs_prefill_rel"] = f32_decode_vs_prefill(
                dev, arch)
    launches += smoke_families(dev)
    for arch in SERVE_LM_ARCHS:
        fa.flash_attention.launches = 0
        serve_lm.main(SERVE_LM_ARGV + ["--arch", arch])
        n = fa.flash_attention.launches
        # two prefills of one launch an attention: untimed, then timed
        if n != 2 * FAMILIES[arch][1]:
            raise AssertionError(f"serve_lm --full --arch {arch}: {n} flash "
                                 f"launches")
        launches += n
        log(f"main path serve_lm --full --arch {arch}: flash launches {n}")
        torch.cuda.empty_cache()
    family_card_vs_cpu(dev)
    nums["seconds"] = time.perf_counter() - t0
    return launches, nums


# ---------------------------------------------------------------- phase 14 --

TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 4096, 6
TRAIN_FLASH = 48            # qwen2-0.5b: 24 forward + 24 remat recompute
TRAIN_PROFILE_LAYERS = 4    # the depth of the profiled copy
# one step each at their SMOKE configs (whisper-base at full size)
TRAIN_SMOKE = ("recurrentgemma-2b", "mamba2-2.7b", "dbrx-132b",
               "llama4-maverick-400b-a17b", "internvl2-26b")
TRAIN_CARD_CPU = ((LM_ARCH, "CONFIG", dict(n_layers=2), 2, 256),
                  ("dbrx-132b", "SMOKE", {}, 2, 64),
                  ("mamba2-2.7b", "SMOKE", {}, 2, 64),
                  ("recurrentgemma-2b", "SMOKE", {}, 2, 64),
                  ("whisper-base", "SMOKE", {}, 2, 64))
# f32 on both sides: the loss read equal and the gradients within 3.3e-6
# of their max |grad|; a TF32 matmul would move them by ~1e-3
TRAIN_LOSS_BAND, TRAIN_GRAD_BAND = 1e-5, 1e-4
TRAIN_ARGV = ["--full", "--arch", LM_ARCH, "--steps", "3", "--batch", "4",
              "--seq", "1024", "--ckpt-every", "2"]
TRAIN_LINE = re.compile(r"^3 steps in [0-9.]+s; loss ([0-9.]+) -> "
                        r"([0-9.]+)$")
TRAIN_DIR = ROOT / "build" / "phase14"
DRILL_FLAG = "--train-restart-drill"


def train_flash_launches(cfg) -> int:
    """Flash launches of one train step: one an attention in the forward,
    again in the remat recompute of each checkpointed layer (the hybrid's
    full pattern groups, not its tail); the backward launches none."""
    if cfg.kind == "encdec":
        return cfg.enc_layers + 2 * cfg.n_layers
    if cfg.kind == "ssm":
        return 0
    if cfg.kind != "hybrid":
        return 2 * cfg.n_layers
    from repro_torch.models.lm import _hybrid_layers

    return sum(2 if key.startswith("slot") else 1
               for kind, key, _ in _hybrid_layers(cfg) if kind == "attn")


def train_setup(cfg, dev, kind="adamw", microbatches=1, loss_chunk=512,
                batch=TRAIN_BATCH, seq=TRAIN_SEQ, params=None):
    """(params, optimizer state, train step, batch 0 of the synthetic
    pipeline) at ``tests/test_substrate.py``'s optimizer settings; the
    params drawn from seed 0 unless given."""
    from repro_torch.data.pipeline import DataConfig, synthetic_batch
    from repro_torch.models.registry import build
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import TrainConfig, make_train_step

    tcfg = TrainConfig(opt=opt.OptConfig(kind=kind, lr=1e-3,
                                         warmup_steps=2),
                       loss_chunk=loss_chunk, microbatches=microbatches,
                       remat=True)
    if params is None:
        params = build(cfg).init_params(
            torch.Generator(device=dev).manual_seed(0))
    data = synthetic_batch(DataConfig(seed=7, global_batch=batch,
                                      seq_len=seq), cfg, 0, dev)
    return (params, opt.init(params, tcfg.opt), make_train_step(cfg, tcfg),
            data)


def scalar(x) -> float:
    """A 0-d tensor (a DTensor's full value) as a float."""
    from repro_torch.sharding.rules import is_dtensor

    return float(x.full_tensor() if is_dtensor(x) else x)


def pinned_step(step, params, state, data, want, label):
    """One train step with the flash launches pinned at ``want``; returns
    (params, state, loss, grad norm, host ms)."""
    from repro_torch.kernels import flash_attention as fa

    fa.flash_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, state, m = step(params, state, data)
    loss, gnorm = scalar(m["loss"]), scalar(m["grad_norm"])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    n = fa.flash_attention.launches
    if n != want:
        raise AssertionError(f"{label}: {n} flash launches, expected {want}")
    if not (math.isfinite(loss) and math.isfinite(gnorm)):
        raise AssertionError(f"{label}: loss {loss}, grad norm {gnorm}")
    return params, state, loss, gnorm, ms


def tree_finite(tree) -> bool:
    from repro_torch.train.optimizer import tree_leaves

    return all(bool(torch.isfinite(x.float()).all())
               for x in tree_leaves(tree))


def train_profile(cfg, dev):
    """Device time by operator of one train step at ``cfg``'s widths and
    batch, cut to TRAIN_PROFILE_LAYERS layers: reading the trace of the
    full depth's 65.6 K kernels takes ~44 s of host time. Returns the
    flash launches of its four steps."""
    from torch.profiler import ProfilerActivity, profile

    cut = dataclasses.replace(cfg, n_layers=TRAIN_PROFILE_LAYERS)
    want = train_flash_launches(cut)
    params, state, step, data = train_setup(cut, dev)
    label = f"{LM_ARCH} cut to {TRAIN_PROFILE_LAYERS} layers"
    times = []
    for i in range(3):
        params, state, _, _, ms = pinned_step(step, params, state, data,
                                              want, f"{label} step {i + 1}")
        times.append(ms)
    ms = statistics.median(times[1:])
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        params, state, _, _, _ = pinned_step(step, params, state, data, want,
                                             f"{label} profiled step")
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    # one aggregation of the trace serves the report and the sums below
    events = prof.key_averages()
    report_profile(events, f"one train step of {label}, {TRAIN_BATCH} x "
                   f"{TRAIN_SEQ}", 1, ms)
    # the autograd engine runs each backward node inside a range of this
    # name, whose device time totals the kernels launched in it: here the
    # attention's (chunked_attention recomputed, and its gradient)
    attn_bwd_ms = sum(
        e.device_time_total for e in events if e.key ==
        "autograd::engine::evaluate_function: _AttentionBackward") / 1e3
    flash_ms = sum(e.self_device_time_total for e in events
                   if "flash_" in e.key) / 1e3
    log(f"phase 14 (a) {label}: {ms:.3f} ms a step (median of steps 2..3); "
        f"device ms inside the attention's backward: {attn_bwd_ms:.3f} "
        f"({100 * attn_bwd_ms / ms:.1f} % of the step); the flash kernel: "
        f"{flash_ms:.3f} ms for its {want} launches (0.000 "
        f"means not measured); the profiled step took {t1 - t0:.1f} s and "
        f"reading its trace {time.perf_counter() - t1:.1f} s")
    del params, state, prof, events
    torch.cuda.empty_cache()
    return 4 * want


def train_qwen(dev):
    """(a), (b), (c): qwen2-0.5b at full width and depth."""
    from repro_torch.configs import get_config
    from repro_torch.train.optimizer import tree_leaves

    cfg = get_config(LM_ARCH)
    want = train_flash_launches(cfg)
    if want != TRAIN_FLASH:
        raise AssertionError(f"{LM_ARCH}: {want} flash launches a step")
    params0, state0, step, data = train_setup(cfg, dev)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    out, launches = {}, 0
    torch.cuda.reset_peak_memory_stats(dev)
    params, state, losses, norms, times = params0, state0, [], [], []
    for i in range(TRAIN_STEPS):
        params, state, loss, gnorm, ms = pinned_step(
            step, params, state, data, want, f"{LM_ARCH} train step {i + 1}")
        launches += want
        losses.append(loss)
        norms.append(gnorm)
        times.append(ms)
    out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{LM_ARCH}: the loss did not fall: {losses}")
    out["ms"] = statistics.median(times[1:])
    out["tok_s"] = tokens / (out["ms"] / 1e3)
    out["flops"] = 6 * cfg.num_params() * tokens
    out["peak_share"] = out["flops"] / (out["ms"] / 1e3 * BF16_FLOPS)
    out["losses"] = losses
    log(f"phase 14 (a) {LM_ARCH} train ({cfg.num_params() / 1e9:.3f} B "
        f"parameters, bf16, AdamW f32 state, {TRAIN_BATCH} x {TRAIN_SEQ} "
        f"tokens, loss_chunk 512, remat): losses "
        f"{[round(x, 4) for x in losses]}, grad norms "
        f"{[round(x, 4) for x in norms]}, host ms "
        f"{[round(x, 3) for x in times]}; {out['ms']:.3f} ms a step (median "
        f"of steps 2..{TRAIN_STEPS}), {out['tok_s']:.0f} tok/s, peak "
        f"{out['peak_gib']:.2f} GiB, 6 N T = {out['flops'] / 1e12:.2f} TFLOP "
        f"= {100 * out['peak_share']:.2f} % of the bf16 peak; {want} flash "
        f"launches a step")
    del params, state
    torch.cuda.empty_cache()
    launches += train_profile(cfg, dev)

    # (b) microbatches 2 against 1 from the same state
    p1, _, l1, _, _ = pinned_step(step, params0, state0, data, want,
                                  f"{LM_ARCH} microbatches=1")
    _, _, step2, _ = train_setup(cfg, dev, microbatches=2, params=params0)
    p2, _, l2, _, _ = pinned_step(step2, params0, state0, data, 2 * want,
                                  f"{LM_ARCH} microbatches=2")
    launches += 3 * want
    diff = max(float((a.float() - b.float()).abs().max())
               for a, b in zip(tree_leaves(p1), tree_leaves(p2)))
    if not diff < 5e-2:
        raise AssertionError(f"{LM_ARCH} microbatches 2 vs 1: params differ "
                             f"by {diff}")
    out["mb_diff"] = diff
    log(f"phase 14 (b) {LM_ARCH} one step with microbatches=2 against 1: "
        f"loss {l2:.5f} vs {l1:.5f}, params max |diff| {diff:.4g} (band "
        f"5e-2)")
    del p1, p2, step2
    torch.cuda.empty_cache()

    # (c) one Adafactor step
    _, state_af, step_af, _ = train_setup(cfg, dev, kind="adafactor",
                                          params=params0)
    p_af, s_af, l_af, g_af, ms_af = pinned_step(
        step_af, params0, state_af, data, want, f"{LM_ARCH} Adafactor")
    launches += want
    if not (tree_finite(p_af) and tree_finite(s_af)):
        raise AssertionError(f"{LM_ARCH} Adafactor: a non-finite leaf")
    log(f"phase 14 (c) {LM_ARCH} one Adafactor step: loss {l_af:.5f}, grad "
        f"norm {g_af:.4f}, {ms_af:.3f} ms, params and state finite")
    del params0, state0, state_af, p_af, s_af, data
    torch.cuda.empty_cache()
    return launches, out


def train_families(dev):
    """(d): one step of each other family; returns the flash launches."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models import lm
    from repro_torch.train.optimizer import tree_leaves

    launches, rows = 0, []
    runs = [(a, get_smoke_config(a), 2, 256) for a in TRAIN_SMOKE]
    runs.append(("whisper-base", get_config("whisper-base"), 4, 448))
    for arch, cfg, b, s in runs:
        want = train_flash_launches(cfg)
        params, state, step, data = train_setup(cfg, dev, loss_chunk=256,
                                                batch=b, seq=s)
        p1, s1, loss, gnorm, ms = pinned_step(step, params, state, data,
                                              want, f"{arch} train step")
        launches += want
        if not (tree_finite(p1) and tree_finite(s1)):
            raise AssertionError(f"{arch}: a non-finite leaf after a step")
        line = ""
        if cfg.kind == "moe":
            with torch.no_grad():
                _, aux = lm.forward(cfg, params, data["tokens"])
            aux = float(aux)
            if not (math.isfinite(aux) and aux > 0):
                raise AssertionError(f"{arch}: MoE aux loss {aux}")
            line = f", aux {aux:.4f}"
        n_par = sum(x.numel() for x in tree_leaves(params))
        rows.append(f"{arch} {want}")
        size = "full" if arch == "whisper-base" else "SMOKE"
        log(f"phase 14 (d) {arch} ({size}, {n_par / 1e6:.2f} M parameters) "
            f"one step on {b} x {s}: loss "
            f"{loss:.4f}, grad norm {gnorm:.4f}, {ms:.1f} ms, {want} flash "
            f"launches{line}")
        del params, state, p1, s1, data
        torch.cuda.empty_cache()
    return launches, rows


def train_card_vs_cpu(dev):
    """(e): one step's loss and gradients in f32, card against CPU."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data.pipeline import DataConfig, synthetic_batch
    from repro_torch.models.registry import build
    from repro_torch.train.optimizer import tree_leaves
    from repro_torch.train.train_step import TrainConfig, value_and_grad

    worst = {}
    for arch, which, cut, b, s in TRAIN_CARD_CPU:
        base = (get_config if which == "CONFIG" else get_smoke_config)(arch)
        cfg = dataclasses.replace(base, dtype=torch.float32, **cut)
        tcfg = TrainConfig(loss_chunk=128)
        cpu = build(cfg).init_params(torch.Generator().manual_seed(3))
        data = synthetic_batch(DataConfig(seed=4, global_batch=b,
                                          seq_len=s), cfg, 0, "cpu")
        l_cpu, g_cpu = value_and_grad(cfg, tcfg, cpu, data)
        l_card, g_card = value_and_grad(cfg, tcfg, tree_to(cpu, dev),
                                        tree_to(data, dev))
        r_loss = abs(float(l_card) - float(l_cpu)) / abs(float(l_cpu))
        r_grad = max(rel_err(a.cpu(), b)
                     for a, b in zip(tree_leaves(g_card), tree_leaves(g_cpu))
                     if float(b.abs().max()) > 0)
        if not (r_loss < TRAIN_LOSS_BAND and r_grad < TRAIN_GRAD_BAND):
            raise AssertionError(f"{arch} train card vs CPU: loss rel "
                                 f"{r_loss}, worst grad rel {r_grad}")
        worst[arch] = (r_loss, r_grad)
        log(f"phase 14 (e) {arch} ({which}, {cfg.n_layers} layers, f32, "
            f"{b} x {s}) one step card vs CPU: loss {float(l_card):.6f} vs "
            f"{float(l_cpu):.6f} (rel {r_loss:.3g}), worst gradient leaf "
            f"{r_grad:.3g} of its max |grad|")
        del cpu, g_cpu, g_card
        torch.cuda.empty_cache()
    return worst


def train_launcher():
    """(f): the launcher at full width; returns its flash launches."""
    import contextlib
    import io

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import train

    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    buf = io.StringIO()
    fa.flash_attention.launches = 0
    try:
        with contextlib.redirect_stdout(buf):
            train.main(TRAIN_ARGV + ["--ckpt-dir", str(TRAIN_DIR / "launch")])
        if not (TRAIN_DIR / "launch" / "step_00000002" /
                "manifest.json").exists():
            raise AssertionError("launch.train wrote no step-2 checkpoint")
    finally:
        shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    n = fa.flash_attention.launches
    last = buf.getvalue().strip().splitlines()[-1]
    m = TRAIN_LINE.match(last)
    if not m or n != 3 * TRAIN_FLASH:
        raise AssertionError(f"launch.train {' '.join(TRAIN_ARGV)}: last line"
                             f" {last!r}, {n} flash launches")
    log(f"phase 14 (f) python -m repro_torch.launch.train "
        f"{' '.join(TRAIN_ARGV)}: {last!r}, {n} flash launches")
    torch.cuda.empty_cache()
    return n


def restart_drill_child(directory, dev=None) -> int:
    """(g), in its own process: 10 steps of qwen2-0.5b's SMOKE config with
    a checkpoint every 4; a run that fails at step 7 resumes from step 4
    and must end bit for bit where the run without the failure ends."""
    import os

    from repro_torch.ckpt.checkpoint import Checkpointer
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.pipeline import DataConfig, synthetic_batch
    from repro_torch.runtime.fault_tolerance import (FailureInjector,
                                                     SimulatedFailure,
                                                     resume_training,
                                                     run_training)
    from repro_torch.train.optimizer import tree_leaves

    torch.use_deterministic_algorithms(True)
    dev = dev or torch.device("cuda", 0)
    cfg = get_smoke_config(LM_ARCH)
    params0, state0, step, _ = train_setup(cfg, dev, loss_chunk=128,
                                           seq=256)
    dcfg = DataConfig(seed=7, global_batch=TRAIN_BATCH, seq_len=256)

    def batch_fn(i):
        return synthetic_batch(dcfg, cfg, i, dev)

    kw = dict(num_steps=10, ckpt_every=4)
    p_ref, s_ref, _ = run_training(
        step, batch_fn, params0, state0,
        ckpt=Checkpointer(os.path.join(directory, "ref")), **kw)
    ck = Checkpointer(os.path.join(directory, "crash"))
    try:
        run_training(step, batch_fn, params0, state0, ckpt=ck,
                     injector=FailureInjector(fail_at_step=7), **kw)
        raise AssertionError("the injected failure did not fire")
    except SimulatedFailure:
        pass
    if ck.latest_step() != 4:
        raise AssertionError(f"latest checkpoint {ck.latest_step()}, not 4")
    p_res, s_res, log_res = resume_training(
        step, batch_fn, ckpt=ck, like={"params": params0, "opt": state0},
        **kw)
    pairs = list(zip(tree_leaves({"p": p_ref, "s": s_ref}),
                     tree_leaves({"p": p_res, "s": s_res})))
    same = sum(torch.equal(a, b) for a, b in pairs)
    print(f"restart drill: {len(log_res)} steps resumed from step 4, "
          f"{same}/{len(pairs)} leaves bit for bit, last loss "
          f"{log_res[-1]['loss']:.6f}")
    return 0 if same == len(pairs) else 1


def train_restart_drill():
    """(g): the drill in a subprocess with deterministic algorithms."""
    import os

    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    directory = TRAIN_DIR / "drill"
    shutil.rmtree(directory, ignore_errors=True)
    try:
        out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                              DRILL_FLAG, str(directory)], env=env,
                             capture_output=True, text=True, timeout=600)
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    lines = out.stdout.strip().splitlines()
    if out.returncode != 0 or not lines:
        raise AssertionError(f"the training restart drill failed "
                             f"(rc {out.returncode}): {out.stdout[-2000:]}"
                             f"{out.stderr[-4000:]}")
    log(f"phase 14 (g) {lines[-1]} (deterministic algorithms, "
        f"CUBLAS_WORKSPACE_CONFIG=:4096:8)")


def train_phase(dev):
    """Phase 14. Returns (flash launches of its train steps, numbers)."""
    t0 = time.perf_counter()
    marks = [t0]

    def mark():
        marks.append(time.perf_counter())

    launches, nums = train_qwen(dev)
    mark()
    n, nums["families"] = train_families(dev)
    launches += n
    mark()
    nums["card_vs_cpu"] = train_card_vs_cpu(dev)
    mark()
    launches += train_launcher()
    mark()
    train_restart_drill()
    mark()
    nums["seconds"] = marks[-1] - t0
    nums["part_s"] = [round(b - a, 1) for a, b in zip(marks, marks[1:])]
    return launches, nums


# --------------------------------------------------------------- phase 15 --

MESH_STEPS = 2
# the dry-run's cells: (shape, multi-pod, mesh name)
DRYRUN_CELLS = (("train_4k", False, "pod16x16"),
                ("decode_32k", True, "multipod2x16x16"))
MESH_ARGV = ["--full", "--arch", LM_ARCH, "--steps", "2", "--batch", "4",
             "--seq", "1024", "--ckpt-every", "2", "--mesh", "debug"]
MESH_LINE = re.compile(r"^2 steps in [0-9.]+s; loss ([0-9.]+) -> "
                       r"([0-9.]+)$")


def mesh_train(dev):
    """(a) and (c): phase 14's qwen2-0.5b run, plain and on the 1 x 1
    DTensor mesh over NCCL at world 1 (the path of ``launch.train --full
    --mesh debug``), then one mesh step under the roofline counters.
    Returns (flash launches, numbers)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.roofline import analysis
    from repro_torch.sharding import rules
    from repro_torch.sharding.rules import is_dtensor
    from repro_torch.train.optimizer import tree_leaves

    cfg = get_config(LM_ARCH)
    out, launches = {}, 0
    # the registered operator's dispatch against the wrapper's, at the
    # qwen2 prefill shape (CUDA events around each call; these launches
    # are no path's)
    gen = torch.Generator(device=dev).manual_seed(5)
    q, k, v = (torch.randn(8, 4096, n, cfg.hd, generator=gen, device=dev)
               .to(torch.bfloat16) for n in (cfg.n_heads, cfg.kv_heads,
                                             cfg.kv_heads))
    calls = {"wrapper": lambda: fa.flash_attention(q, k, v, causal=True),
             "operator": lambda: torch.ops.repro_torch.flash_attention(
                 q, k, v, True, 0)}
    op_ms = {}
    for name in ("wrapper", "operator", "operator", "wrapper"):
        op_ms.setdefault(name, []).append(median_ms(calls[name], 20))
    out["op_ms"] = op_ms
    log(f"phase 15 (a) flash at (8, 4096, 14, 64) bf16, causal, median of "
        f"20 calls by CUDA events: the wrapper {op_ms['wrapper']} ms, "
        f"torch.ops.repro_torch.flash_attention {op_ms['operator']} ms")
    del q, k, v, calls
    params0, state0, step, data = train_setup(cfg, dev)
    runs = {}
    p, s = params0, state0
    for label in ("plain", "mesh"):
        if label == "mesh":
            mesh = mesh_lib.make_debug_mesh(1, 1, device=dev.type)
            pspecs = rules.param_specs(cfg, params0, mesh)
            p = rules.distribute(params0, pspecs, mesh)
            s = rules.distribute(state0, rules.opt_state_specs(
                "adamw", pspecs, params0, mesh), mesh)
            mdata = rules.distribute(
                data, {k: rules.Spec(rules.batch_axes(mesh)) for k in data},
                mesh)
            if not all(is_dtensor(x) for x in tree_leaves({"p": p, "s": s})):
                raise AssertionError("phase 15 (a): a leaf is no DTensor")
        losses, times = [], []
        for i in range(MESH_STEPS):
            p, s, loss, _, ms = pinned_step(
                step, p, s, data if label == "plain" else mdata, TRAIN_FLASH,
                f"phase 15 (a) {label} step {i + 1}")
            launches += TRAIN_FLASH
            losses.append(loss)
            times.append(ms)
        runs[label] = (p, s, losses, times)
        if label == "plain":
            p, s = params0, state0
    (pp, sp, lp, tp), (pm, sm, lm_, tm) = runs["plain"], runs["mesh"]
    leaves = list(zip(tree_leaves(pp), tree_leaves(pm)))
    same = sum(torch.equal(a, b.full_tensor()) for a, b in leaves)
    states = list(zip(tree_leaves(sp), tree_leaves(sm)))
    same_s = sum(torch.equal(a, b.full_tensor()) for a, b in states)
    if lp != lm_ or same != len(leaves):
        raise AssertionError(f"phase 15 (a): the mesh step is not the plain "
                             f"step: losses {lm_} vs {lp}, {same}/"
                             f"{len(leaves)} parameter leaves equal")
    out.update(plain_ms=tp, mesh_ms=tm, losses=lp,
               dispatch_ms=tm[-1] - tp[-1])
    log(f"phase 15 (a) {LM_ARCH} on the 1 x 1 DTensor mesh (NCCL, world "
        f"1; {' x '.join(map(str, data['tokens'].shape))} tokens, AdamW, "
        f"remat) against the "
        f"plain step, {MESH_STEPS} steps from the same weights and batch: "
        f"losses {lm_} (plain {lp}), {same}/{len(leaves)} parameter and "
        f"{same_s}/{len(states)} optimizer-state leaves bit for bit; host "
        f"ms a step, plain {[round(x, 3) for x in tp]}, mesh "
        f"{[round(x, 3) for x in tm]}; DTensor dispatch adds "
        f"{out['dispatch_ms']:.3f} ms to step {MESH_STEPS}; "
        f"{TRAIN_FLASH} flash launches a step through "
        f"torch.ops.repro_torch.flash_attention")
    del pp, sp, runs, leaves, states

    # (c) the roofline counters over one real mesh step
    b, seq = data["tokens"].shape
    tokens = b * seq
    info = dryrun.SHAPES["train_4k"]
    mflops = dryrun.model_flops(cfg, "train_4k") * tokens / (
        info["batch"] * info["seq"])
    fa.flash_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with analysis.CostMode() as cost:
        pm, sm, _ = step(pm, sm, mdata)
        torch.cuda.synchronize()
    counted_ms = (time.perf_counter() - t0) * 1e3
    if fa.flash_attention.launches != TRAIN_FLASH:
        raise AssertionError(f"phase 15 (c): {fa.flash_attention.launches} "
                             f"flash launches")
    launches += TRAIN_FLASH
    roof = analysis.from_counts(cost, 1, mflops)
    flash_flops = cost.by_op.get("repro_torch.flash_attention", 0)
    want_flash = TRAIN_FLASH * fa.flops((b, seq, cfg.n_heads, cfg.hd),
                                        (b, seq, cfg.kv_heads, cfg.hd),
                                        True, 0)
    if not roof.flops >= mflops or flash_flops != want_flash:
        raise AssertionError(f"phase 15 (c): counted {roof.flops:.4g} FLOPs "
                             f"against 6 N T {mflops:.4g}; flash "
                             f"{flash_flops} against {want_flash}")
    bound = max(roof.t_compute, roof.t_memory) * 1e3
    out.update(flops=roof.flops, mflops=mflops, t_compute=roof.t_compute,
               t_memory=roof.t_memory, counted_ms=counted_ms)
    top = sorted(cost.by_op.items(), key=lambda kv: -kv[1])[:4]
    log(f"phase 15 (c) roofline.analysis over one mesh step: "
        f"{roof.flops / 1e12:.3f} TFLOP counted (6 N T = {mflops / 1e12:.3f}"
        f"; {', '.join(f'{k} {v / 1e12:.3f}' for k, v in top)}), flash "
        f"{flash_flops / 1e12:.4f} TFLOP = {TRAIN_FLASH} x its formula; "
        f"{roof.hbm_bytes / 1e12:.3f} TB moved; t_compute "
        f"{roof.t_compute * 1e3:.3f} ms, t_memory {roof.t_memory * 1e3:.3f} "
        f"ms at 989 TFLOP/s and 3.35 TB/s; measured {tp[-1]:.3f} ms a "
        f"plain step, {tm[-1]:.3f} a mesh step, against max(t_compute, "
        f"t_memory) {bound:.3f} ms ({tp[-1] / bound:.2f}x); the counted "
        f"step took {counted_ms:.1f} ms")
    del pm, sm, mdata, params0, state0, data, p, s
    mesh_lib.stop_group()
    torch.cuda.empty_cache()
    return launches, out


def mesh_launcher():
    """(a'): ``launch.train --mesh debug`` at full width: it starts its own
    NCCL group, checkpoints DTensors, and stops the group."""
    import contextlib
    import io

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import train

    directory = ROOT / "build" / "phase15"
    shutil.rmtree(directory, ignore_errors=True)
    buf = io.StringIO()
    fa.flash_attention.launches = 0
    try:
        with contextlib.redirect_stdout(buf):
            train.main(MESH_ARGV + ["--ckpt-dir", str(directory)])
        if not (directory / "step_00000002" / "manifest.json").exists():
            raise AssertionError("launch.train --mesh debug wrote no step-2 "
                                 "checkpoint")
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    n = fa.flash_attention.launches
    last = buf.getvalue().strip().splitlines()[-1]
    if not MESH_LINE.match(last) or n != 2 * TRAIN_FLASH:
        raise AssertionError(f"launch.train {' '.join(MESH_ARGV)}: last line"
                             f" {last!r}, {n} flash launches")
    import torch.distributed as dist
    if dist.is_initialized():
        raise AssertionError("launch.train left its process group")
    log(f"phase 15 (a') python -m repro_torch.launch.train "
        f"{' '.join(MESH_ARGV)}: {last!r}, {n} flash launches")
    torch.cuda.empty_cache()
    return n


def mesh_dryrun(dev, counters):
    """(b): the dry-run's two LM cells under the fake group at world 512,
    and its --pic row for real on the card; returns the rows."""
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.roofline import report

    rows = []
    mesh_lib.start_group("fake", dryrun.FAKE_WORLD)
    try:
        meshes = {}
        for shape, multi, name in DRYRUN_CELLS:
            meshes[name] = mesh_lib.make_production_mesh(
                multi_pod=multi, device=dryrun.trace_device())
            row = dryrun.run_cell(LM_ARCH, shape, meshes[name], name)
            if row["status"] != "ok":
                raise AssertionError(f"phase 15 (b) {LM_ARCH} x {shape} on "
                                     f"{name}: {row.get('error')}\n"
                                     f"{row.get('trace')}")
            ro = row["roofline"]
            if not ro["useful_flops_ratio"] <= 1:
                raise AssertionError(f"phase 15 (b) {shape}: useful flops "
                                     f"ratio {ro['useful_flops_ratio']}")
            rows.append(row)
            log(f"phase 15 (b) dry-run {LM_ARCH} x {shape} on {name}: "
                f"{row['status']}, traced in {row['lower_s']} s; t_compute "
                f"{ro['t_compute_s']:.4g} s, t_memory {ro['t_memory_s']:.4g} "
                f"s, t_collective {ro['t_collective_s']:.4g} s "
                f"({ro['bottleneck']}); {ro['hlo_gflops_per_chip']:.1f} "
                f"GFLOP, {ro['hbm_gbytes_per_chip']:.2f} GB, collectives "
                f"{ro['coll_breakdown']} a chip; useful flops ratio "
                f"{ro['useful_flops_ratio']:.4f}; "
                f"{row['bytes_per_chip_est'] / 2**30:.2f} GiB a chip, "
                f"fits_80g {row['fits_80g']}")
        reset_launches(counters)
        pic = dryrun.run_pic_dryrun(meshes["pod16x16"], "pod16x16", dev)
        n = launches(counters)
        if n["fused_push_deposit"] <= 0 and n["mover_push"] <= 0:
            raise AssertionError(f"phase 15 (b) --pic: no push kernel ran "
                                 f"({n})")
        ro = pic["roofline"]
        log(f"phase 15 (b) dry-run --pic on pod16x16 (D "
            f"{pic['domains']}, one real engine step at §3.3 global size on "
            f"the card, {pic['step_s']} s): t_memory {ro['t_memory_s']:.4g} "
            f"s, t_collective {ro['t_collective_s']:.4g} s a domain "
            f"({ro['bottleneck']}); {ro['hbm_gbytes_per_chip']:.3f} GB and "
            f"{ro['coll_mbytes_per_chip']:.3f} MB moved a domain; peak "
            f"{pic['memory']['peak_bytes'] / 2**30:.2f} GiB for the D "
            f"domains; kernel launches {n}")
        rows.append(pic)
    finally:
        mesh_lib.stop_group()
    for line in report.render_rows(rows).splitlines():
        log(f"  {line}")
    return rows, n


def mesh_phase(dev):
    """Phase 15. Returns (launches by kernel, numbers)."""
    counters = pic_counters()
    t0 = time.perf_counter()
    marks = [t0]
    flash, nums = mesh_train(dev)
    marks.append(time.perf_counter())
    flash += mesh_launcher()
    marks.append(time.perf_counter())
    nums["rows"], pic = mesh_dryrun(dev, counters)
    marks.append(time.perf_counter())
    counts = {k: pic[k] for k in PIC_KERNELS}
    counts["flash_attention"] = flash
    nums["seconds"] = marks[-1] - t0
    nums["part_s"] = [round(b - a, 1) for a, b in zip(marks, marks[1:])]
    log(f"phase 15: {nums['seconds']:.1f} s ((a, c), (a'), (b): "
        f"{nums['part_s']} s), launches {counts}")
    return counts, nums


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
    if sys.argv[1:2] == [DRILL_FLAG]:
        return restart_drill_child(sys.argv[2])
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
    if sys.argv[1:2] == [ENGINE_GRAPH_FLAG]:
        engine_graph_phase()
        log(smi)
        return 0
    for src in ("mover", "collide", "births"):
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
    eng["graph_s"] = engine_graph_phase()
    obs_counts, obs = obs_phase(dev)
    serve_counts, serve = serve_phase(dev, ms["fused"])
    for k in PIC_KERNELS:
        counts[k] += engine_counts[k] + obs_counts[k] + serve_counts[k]
    kernels["flash_attention"] = flash_phase(dev)
    counts["flash_attention"], fam = family_phase(dev)
    train_launches, trn = train_phase(dev)
    counts["flash_attention"] += train_launches
    mesh_counts, msh = mesh_phase(dev)
    for k in counts:
        if k in mesh_counts:
            counts[k] += mesh_counts[k]

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
    ov, ckn = obs["overhead"], obs["ckpt"]
    log(f"observability and resilience (D 4 x 4): host ms/step, quartiles "
        f"25/50/75 %, §3.3 field off, plain {ov['quartiles']['P']}, under "
        f"the profiler {ov['quartiles']['T']} (device busy "
        f"{ov['busy_ms']:.3f} ms a step; trace {ov['mib']:.1f} MiB, "
        f"exported in {ov['export_s']:.2f} s), with the metrics stream "
        f"{ov['quartiles']['M']}; the stream's own "
        f"{obs['metrics']['record_ms']:.3f}; checkpoint "
        f"{ckn['bytes'] / 2**30:.3f} GiB, fetch ms "
        f"{[round(v, 1) for v in ckn['fetch_ms']]}, write ms "
        f"{[round(v, 1) for v in ckn['write_ms']]}, typed restore "
        f"{ckn['restore_s']:.2f} s, elastic restores "
        f"{ {d: round(v, 2) for d, v in obs['elastic_s'].items()} } s; "
        f"retunes {obs['retunes']}; phase {obs['seconds']:.1f} s")
    log(f"runtime params and serving (§3.3, W {SERVE_WIDTH}): host ms an "
        f"ensemble step {serve['ensemble_ms']:.3f} against "
        f"{SERVE_WIDTH} x the solo step {SERVE_WIDTH * serve['solo_ms']:.3f}"
        f", peak memory {serve['peak_gib']:.2f} GiB; phase "
        f"{serve['seconds']:.1f} s")
    for arch in FAMILIES:
        r = fam[arch]
        log(f"LM {arch}: prefill {FAMILIES[arch][0][0]} x "
            f"{FAMILIES[arch][0][1]} {r['prefill_ms']:.3f} ms "
            f"({r['prefill_tok_s']:.0f} tok/s), peak {r['peak_gib']:.2f} GiB"
            f", decode {r['decode_ms']:.3f} ms/step at batch {SERVE_BATCH} "
            f"({r['decode_tok_s']:.1f} tok/s, {r['decode_kernels']} kernels "
            f"a step), decode vs prefill rel "
            f"{r['decode_vs_prefill_rel']:.4g}"
            + (f", {100 * r['dropped']:.3f} % routes dropped"
               if "dropped" in r else ""))
    log(f"LM phases: {fam['seconds']:.1f} s")
    log(f"LM train {LM_ARCH} ({TRAIN_BATCH} x {TRAIN_SEQ}, bf16, AdamW, "
        f"remat): {trn['ms']:.3f} ms/step, {trn['tok_s']:.0f} tok/s, peak "
        f"{trn['peak_gib']:.2f} GiB, {100 * trn['peak_share']:.2f} % of the "
        f"bf16 peak, {TRAIN_FLASH} flash launches a step; microbatches 2 vs "
        f"1 {trn['mb_diff']:.3g}; flash launches a step by family "
        f"{trn['families']}; card vs CPU (loss rel, worst grad rel) "
        + ", ".join(f"{a} ({r[0]:.2g}, {r[1]:.2g})"
                    for a, r in trn["card_vs_cpu"].items())
        + f"; phase 14 {trn['seconds']:.1f} s ((a-c), (d), (e), (f), (g): "
        f"{trn['part_s']} s)")
    log(f"LM train on the 1 x 1 DTensor mesh: plain ms "
        f"{[round(x, 3) for x in msh['plain_ms']]}, mesh ms "
        f"{[round(x, 3) for x in msh['mesh_ms']]} (DTensor dispatch adds "
        f"{msh['dispatch_ms']:.3f} ms at step {MESH_STEPS}); counted "
        f"{msh['flops'] / 1e12:.3f} TFLOP against 6 N T "
        f"{msh['mflops'] / 1e12:.3f}; t_compute {msh['t_compute'] * 1e3:.3f}"
        f" ms, t_memory {msh['t_memory'] * 1e3:.3f} ms; dry-run rows "
        + ", ".join(f"{r['arch']} {r['shape']} {r['mesh']} {r['status']}"
                    for r in msh["rows"])
        + f"; phase 15 {msh['seconds']:.1f} s")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(smi)
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
