"""The benchmark's files: every name in ``BENCHMARK.json`` finds its file,
the contract's limits on names and keys hold, and a cell, a configuration
and a per-layer metric are added by adding files alone."""

from __future__ import annotations

import argparse
import json
import re

import pytest
import torch

from perfbench import run
from perfbench.bench import files
from perfbench.conftest import REPO

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_every_name_finds_its_file():
    for c in BENCH["configs"]:
        cfg = files.config(c["name"])
        assert (REPO / c["file"]).is_file()
        assert hasattr(files.driver(cfg["driver"]), "Driver")
    for w in BENCH["workloads"]:
        wl = files.workload(w["name"])
        assert wl["config"] == w["config"] and wl["chips"] == w["chips"]
        assert wl["why"] == w["why"]
    for m in BENCH["per_layer"]:
        assert callable(files.metric(m["name"]).read)


def test_names_units_and_keys_keep_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", [])) <= {w["name"]
                                                for w in BENCH["workloads"]}
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
        assert NAME.match(w["traffic"])
    for c in BENCH["configs"]:
        assert c["file"].startswith("perfbench/") and c["reduced"] == []
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_unknown_and_malformed_names_are_refused():
    with pytest.raises(FileNotFoundError):
        files.workload("no-such-cell")
    with pytest.raises(ValueError):
        files.config("../BENCHMARK")
    with pytest.raises(SystemExit):
        run.cell_entry(BENCH, "no-such-cell")


def test_a_new_cell_config_and_metric_are_found_by_name(tiny):
    """Added files only: a configuration, its cell and a per-layer metric
    appear in a run, and no file that was there changes."""
    before = {p: p.read_bytes() for p in tiny.rglob("*") if p.is_file()}
    cfg = json.loads((tiny / "configs" / "bit1-s33.json").read_text())
    cfg["dt"] = 0.1
    (tiny / "configs" / "bit1-s33-dt01.json").write_text(json.dumps(cfg))
    wl = json.loads((tiny / "workloads" / "bit1-s33.ionize.json")
                    .read_text())
    wl["config"] = "bit1-s33-dt01"
    (tiny / "workloads" / "bit1-s33-dt01.ionize.json").write_text(
        json.dumps(wl))
    (tiny / "metrics" / "trace.steps.py").write_text(
        "def read(ctx):\n    return float(ctx['trace']['steps'])\n")
    bench_path = tiny.parent / "BENCHMARK.json"
    bench = json.loads(bench_path.read_text())
    bench["workloads"].append({"name": "bit1-s33-dt01.ionize",
                               "config": "bit1-s33-dt01",
                               "traffic": "ionize", "chips": 1,
                               "why": wl["why"]})
    bench["per_layer"].append({"name": "trace.steps", "unit": "steps",
                               "better": "higher", "source": "device_trace",
                               "layer": "step (host issue)",
                               "moves": "step_ms"})
    bench_path.write_text(json.dumps(bench))
    assert all(p.read_bytes() == b for p, b in before.items())

    args = argparse.Namespace(workload="bit1-s33-dt01.ionize", seed=5,
                              seconds=0.2, trace=1)
    torch.set_num_threads(1)
    res = run.run_cell(args, torch.device("cpu"), root=tiny)
    assert res["correct"] is True
    assert res["metrics"]["trace.steps"]["value"] == wl["trace_steps"]
