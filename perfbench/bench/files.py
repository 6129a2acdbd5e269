"""Finding a cell's files by name.

Every configuration, traffic mix, driver and per-layer metric sits in a
file of its own under ``perfbench/``, found by the name that
``BENCHMARK.json`` gives it:

- ``configs/<config>.json``: the sizes of one configuration;
- ``workloads/<cell>.json``: one cell's traffic, episode, check and limits;
- ``drivers/<driver>.py``: one entry point of the program, named by the
  configuration's ``driver`` key;
- ``metrics/<metric>.py``: one per-layer metric, a ``read(ctx)``.

A later cell adds files and edits none. ``root`` defaults to this
``perfbench/`` directory; tests point it at a copy.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def check_name(name: str, what: str) -> str:
    if not isinstance(name, str) or not NAME.match(name):
        raise ValueError(f"bad {what} name {name!r}")
    return name


def _json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"{path} not found")
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    """``BENCHMARK.json`` beside the ``perfbench/`` directory."""
    return _json(root.parent / "BENCHMARK.json")


def config(name: str, root: Path = ROOT) -> dict:
    return _json(root / "configs" / f"{check_name(name, 'config')}.json")


def workload(name: str, root: Path = ROOT) -> dict:
    return _json(root / "workloads" / f"{check_name(name, 'workload')}.json")


def _module(path: Path, modname: str):
    if not path.is_file():
        raise FileNotFoundError(f"{path} not found")
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str, root: Path = ROOT):
    """The module ``drivers/<name>.py``; it defines ``Driver``."""
    return _module(root / "drivers" / f"{check_name(name, 'driver')}.py",
                   f"perfbench_driver_{name.replace('.', '_')}")


def metric(name: str, root: Path = ROOT):
    """The module ``metrics/<name>.py``; it defines ``read(ctx)``."""
    return _module(root / "metrics" / f"{check_name(name, 'metric')}.py",
                   "perfbench_metric_" + re.sub(r"[.\-]", "_", name))


def cell_metrics(bench: dict, cell: str, kind: str) -> list[dict]:
    """The metrics of ``kind`` ('end_to_end' or 'per_layer') that ``cell``
    reports: those whose ``workloads`` key lists the cell, and those
    without the key: every end-to-end one, and every per-layer one whose
    ``moves`` the cell reports."""
    def listed(m):
        return cell in m["workloads"] if "workloads" in m else None

    out = [m for m in bench[kind] if listed(m) is not False]
    if kind == "per_layer":
        e2e = {m["name"] for m in cell_metrics(bench, cell, "end_to_end")}
        out = [m for m in out if "workloads" in m or m["moves"] in e2e]
    return out
