"""The readings a cell's limits are set from, in one process on the card.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        [--control] [--out FILE]

For each seed: set-up as a run makes it, then the check's numbers of the
program against the reference (the lower readings) and, with
``--control``, of the reference computed in bfloat16 in the program's
place (the upper readings). One JSON line a seed, on standard output and
appended to ``--out``. The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent / "src"))
sys.path.insert(0, str(HERE.parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch

    from perfbench.bench import device, files
    from perfbench.run import cell_entry

    bench = files.benchmark()
    cell = cell_entry(bench, args.workload)
    traffic = files.workload(args.workload)
    cfg = files.config(cell["config"])
    dev = device.require(int(cell["chips"]))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        drv = files.driver(cfg["driver"]).Driver(cfg, traffic, dev, seed)
        drv.setup()
        drv.release()
        row = {"workload": args.workload, "seed": seed,
               "program": drv.check()}
        if args.control:
            row["control"] = drv.check(control=True)
        row["seconds"] = time.perf_counter() - t0
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        drv = None
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
