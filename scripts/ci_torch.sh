#!/usr/bin/env bash
# CI entry point of the PyTorch port (src/repro_torch), on the CPU: every
# kernel takes its plain PyTorch version there, and nothing needs a card.
# The card's own check is `python3 chip_smoke.py` (docs/port.md).
#
# Lane 1: the no-JAX import test: the port imports neither jax nor the
#         reference package (tests/test_torch_imports.py).
# Lane 2: the port's tests (tests/test_torch_*.py), each holding a module of
#         the port against the reference on the same seeded inputs.
# Lane 3: the launchers at small sizes: pic_run (single domain, and the
#         engine at D 2 x async 2), serve_lm, train with and without
#         --mesh debug (the 1 x 1 DTensor mesh on a gloo group of one).
# Lane 4: the dry-run of one reduced cell (qwen2-0.5b's SMOKE config at
#         64 tokens on the fake 16 x 16 mesh) and its report table.
# Lane 5: the five examples with --device cpu.
# Lane 6: docs: no broken relative link in docs/port.md.
set -euo pipefail
cd "$(dirname "$0")/.."

export PYTHONPATH="src${PYTHONPATH:+:$PYTHONPATH}"
export JAX_PLATFORMS="${JAX_PLATFORMS:-cpu}"
OUT="$(mktemp -d)"
trap 'rm -rf "$OUT"' EXIT

# ---- lanes 1 and 2: tests ----
python -m pytest -x -q tests/test_torch_imports.py
python -m pytest -x -q tests/test_torch_*.py

# ---- lane 3: launchers ----
python -m repro_torch.launch.pic_run --device cpu --steps 2 --nc 256 \
    --particles 2048 --strategy fused
python -m repro_torch.launch.pic_run --device cpu --domains 2 --async-n 2 \
    --field-solve --steps 2 --nc 256 --particles 4096 --strategy fused
python -m repro_torch.launch.serve_lm --device cpu --batch 2 \
    --prompt-len 16 --tokens 8
python -m repro_torch.launch.train --device cpu --steps 2 --batch 2 \
    --seq 32 --ckpt-every 2 --ckpt-dir "$OUT/train"
python -m repro_torch.launch.train --device cpu --steps 2 --batch 2 \
    --seq 32 --ckpt-every 2 --ckpt-dir "$OUT/train_mesh" --mesh debug

# ---- lane 4: the dry-run of one reduced cell ----
python - "$OUT/dryrun.json" <<'PY'
import sys

from repro_torch.configs import get_smoke_config
from repro_torch.launch import dryrun
from repro_torch.roofline import report

dryrun.SHAPES = {"train_4k": dict(kind="train", seq=64, batch=32)}
dryrun.get_config = get_smoke_config
dryrun.main(["--arch", "qwen2-0.5b", "--shape", "train_4k", "--mesh", "pod",
             "--out", sys.argv[1]])
print(report.render(sys.argv[1]))
PY

# ---- lane 5: examples ----
python examples/torch_quickstart.py --device cpu
python examples/torch_pic_ionization.py --device cpu --steps 60 --nc 1024 \
    --n 16384
python examples/torch_pic_async_multidevice.py --device cpu --ionization \
    --steps 4
python examples/torch_serve_lm.py --device cpu --tokens 8
python examples/torch_train_lm.py --device cpu --steps 4 --layers 1 \
    --seq 64 --batch 2 --ckpt-every 2 --ckpt-dir "$OUT/train_lm" \
    --mesh debug

# ---- lane 6: docs ----
python scripts/check_links.py docs/port.md
echo "ci_torch: all lanes passed"
