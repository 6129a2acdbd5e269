"""Fixtures of the benchmark's CPU tests: a copy of the benchmark's files
cut to a tiny size, in a test's own temporary directory."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
BOUNDS = {"nc": 64, "n_init": 2048, "capacity": 4096,
          "max_migration": 64, "max_births": 256}


def tiny_copy(dst: Path) -> Path:
    """``dst/BENCHMARK.json`` and ``dst/perfbench/`` with the drivers and
    metrics as they are, and every configuration cut to 64 cells and 2,048
    of 4,096 slots a species, episodes of 4 steps, traces of 2."""
    pb = dst / "perfbench"
    pb.mkdir(parents=True)
    for d in ("drivers", "metrics"):
        shutil.copytree(HERE / d, pb / d)
    (pb / "configs").mkdir()
    (pb / "workloads").mkdir()
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        cfg["nc"] = BOUNDS["nc"]
        for s in cfg["species"]:
            s["n_init"], s["capacity"] = BOUNDS["n_init"], BOUNDS["capacity"]
        for k in ("max_migration", "max_births"):
            if k in cfg:
                cfg[k] = BOUNDS[k]
        (pb / "configs" / f"{c['name']}.json").write_text(json.dumps(cfg))
    for w in bench["workloads"]:
        wl = json.loads((HERE / "workloads" / f"{w['name']}.json")
                        .read_text())
        wl["episode_steps"], wl["trace_steps"] = 4, 2
        (pb / "workloads" / f"{w['name']}.json").write_text(json.dumps(wl))
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    return pb


@pytest.fixture
def tiny(tmp_path) -> Path:
    torch.set_num_threads(1)
    return tiny_copy(tmp_path)


CELLS = [w["name"] for w in
         json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]
