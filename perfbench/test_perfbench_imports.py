"""What the benchmark may import: nothing of JAX or of the JAX package
``repro`` anywhere under ``perfbench/`` (top-level names compared whole,
since the port's ``repro_torch`` begins with ``repro``), nothing of
``chip_smoke`` or ``benchmarks``, and in the reference nothing of the
program; and a run without a card fails with no result."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

from perfbench.conftest import HERE, REPO
from perfbench.run import FORBIDDEN, forbidden_modules

BANNED = set(FORBIDDEN) | {"chip_smoke", "benchmarks"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".", 1)[0]


def test_no_jax_or_jax_package_under_perfbench():
    for path in HERE.rglob("*.py"):
        bad = set(_imports(path)) & BANNED
        assert not bad, (path, bad)


def test_reference_imports_nothing_of_the_program():
    for path in (HERE / "reference").rglob("*.py"):
        assert "repro_torch" not in set(_imports(path)), path


def test_top_level_names_are_compared_whole():
    assert forbidden_modules(["repro_torch", "repro_torch.core.pic",
                              "jaxtyping", "reprolib"]) == []
    assert forbidden_modules(["repro.core.pic", "jax.numpy", "jaxlib",
                              "flax.linen", "repro_torch"]) == [
        "flax", "jax", "jaxlib", "repro"]


def test_without_a_card_the_run_fails_with_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run(
        [sys.executable, str(HERE / "run.py"), "--workload",
         "bit1-s33.ionize", "--seed", "2147483999", "--seconds", "1",
         "--trace", "0"], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
