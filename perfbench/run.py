"""Run one cell of the benchmark once.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell (``BENCHMARK.json``'s ``workloads``) names its configuration
(``perfbench/configs/<config>.json``), whose ``driver`` names the entry of
the program that the window drives (``perfbench/drivers/<driver>.py``).
The cell's own file (``perfbench/workloads/<cell>.json``) gives its
traffic, its episodes, its check and the limits of the check.

A run: set-up (the program's import and kernel build, the state made on
the card from the seed, warm-up steps), then whole episodes of steps until
``--seconds`` have passed, then with ``--trace 1`` a short profiled
stretch from the middle of an episode, read by the per-layer metrics
(``perfbench/metrics/<metric>.py``), then the check against the plain
reference (``perfbench/reference``). The last line of standard output is
the result, as JSON; the last lines of standard error are the numbers the
check compared, each beside its limit.

It needs a CUDA card: without one, or with fewer cards than the cell asks
for, it exits with code 2 and prints no result. It exits with code 3 and
prints no result if the JAX package or JAX itself was loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent / "src"))
sys.path.insert(0, str(HERE.parent))

# top-level module names that the port's run must never load
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names=None) -> list[str]:
    """The top-level names among ``names`` (default: the loaded modules)
    that the run may not load, each compared whole."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".", 1)[0] for m in names} & set(FORBIDDEN))


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def cell_entry(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no cell {name!r} in BENCHMARK.json")


def run_cell(args: argparse.Namespace, dev, root: Path | None = None
             ) -> dict:
    """Everything of a run after the look for a card, on ``dev``, up to
    its result; ``root`` is the ``perfbench/`` directory whose files name
    the cell. The numbers compared go to standard error, last."""
    import torch

    from perfbench.bench import (check, device, files, program, trace,
                                 window)

    marks = [("torch and CUDA up", time.perf_counter() - T0)]
    root = files.ROOT if root is None else root
    bench = files.benchmark(root)
    cell = cell_entry(bench, args.workload)
    traffic = files.workload(args.workload, root)
    cfg = files.config(cell["config"], root)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device.reset_peak(dev)
    built = program.build() if dev.type == "cuda" else (0.0, 0)
    marks.append(("kernels built", time.perf_counter() - T0))

    drv = files.driver(cfg["driver"], root).Driver(cfg, traffic, dev,
                                                   args.seed)
    drv.setup()
    marks.append(("state made", time.perf_counter() - T0))
    runner = window.Runner(drv, traffic["episode_steps"])
    for _ in range(int(traffic["warmup_steps"])):
        runner.advance()
    runner.restart()
    device.sync(dev)
    setup_s = time.perf_counter() - T0

    res = window.measure(runner, args.seconds, dev)
    window_nums, sums, bad_steps = drv.window_checks(runner.episodes)
    tr = work = None
    if args.trace:
        # the traced steps start mid-episode, whatever the window reached
        runner.restart()
        for _ in range(runner.episode_steps // 2):
            runner.advance()
        tr = trace.capture(runner, int(traffic["trace_steps"]), dev)
        work = drv.work([d for ep in runner.episodes for d in ep]
                        [-tr["steps"]:])
    peak = device.peak(dev)
    drv.release()
    runner = None
    nums = drv.check()
    nums.update(window_nums)

    print(f"counters over the window: {json.dumps(sums, sort_keys=True)}",
          file=sys.stderr)
    q = window.p90(res["step_times_ms"]), min(res["step_times_ms"]), \
        max(res["step_times_ms"])
    print(f"window: {res['steps']} steps in {res['window_s']!r} s (step "
          f"ms p90 {q[0]!r}, min {q[1]!r}, max {q[2]!r}); peak "
          f"{peak / 2**30!r} GiB; kernel build {built[0]!r} s "
          f"({built[1]} sources compiled); set-up {setup_s!r} s: "
          + ", ".join(f"{k} at {v:.3f} s" for k, v in marks),
          file=sys.stderr)
    correct = check.judge(nums, traffic["limits"])

    if tr is None:
        values = {"step_ms": res["step_ms"],
                  "step_p90_ms": res["step_p90_ms"], "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]],
                               "unit": m["unit"]}
                   for m in files.cell_metrics(bench, args.workload,
                                               "end_to_end")}
    else:
        from perfbench.bench import peaks

        ctx = {"trace": tr, "step_ms": res["step_ms"], "work": work,
               "peaks": peaks, "config": cfg, "traffic": traffic}
        metrics = {}
        for m in files.cell_metrics(bench, args.workload, "per_layer"):
            value = files.metric(m["name"], root).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev_info = device.describe(dev, int(cell["chips"]), peak)
    result = {"correct": bool(correct), "attempted": res["steps"],
              "failed": bad_steps, "metrics": metrics, "device": dev_info}
    if tr is not None:
        dev_info["busy_s"] = tr["busy_us"] * 1e-6
        dev_info["window_s"] = tr["window_us"] * 1e-6
        result["breakdown"] = trace.breakdown(tr)
    result["checks"] = {k: {"value": v, "limit": traffic["limits"].get(k)}
                        for k, v in sorted(nums.items())}
    return result


def main(argv=None) -> int:
    args = parse(argv)
    from perfbench.bench import device, files

    chips = int(cell_entry(files.benchmark(), args.workload)["chips"])
    result = run_cell(args, device.require(chips))
    found = forbidden_modules()
    if found:
        print(f"the run loaded {found}: the port's benchmark may not load "
              f"JAX or the JAX package", file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
