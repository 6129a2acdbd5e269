"""Configurations: the paper's PIC scenarios (``pic_bit1``) and the LM
substrate's archs, one module each (the port of ``repro.configs``).

``get_config(arch)`` / ``get_smoke_config(arch)`` look up by arch id (e.g.
"qwen2-0.5b"). ``ARCHS`` is the reference's tuple; the archs whose family
the port does not run yet raise ``NotImplementedError``.
"""

from __future__ import annotations

import importlib

ARCHS = (
    "llama4-maverick-400b-a17b",
    "dbrx-132b",
    "qwen2-0.5b",
    "gemma-7b",
    "qwen2-7b",
    "qwen2.5-3b",
    "recurrentgemma-2b",
    "whisper-base",
    "internvl2-26b",
    "mamba2-2.7b",
)
# the dense archs, the only ones ported so far
PORTED = ("qwen2-0.5b", "gemma-7b", "qwen2-7b", "qwen2.5-3b")


def _module(arch: str):
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    if arch not in PORTED:
        raise NotImplementedError(
            f"arch {arch!r} is not ported yet (ROADMAP queue 1, item 6, "
            f"the LM substrate); ported: {PORTED}")
    name = arch.replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(arch: str):
    return _module(arch).CONFIG


def get_smoke_config(arch: str):
    return _module(arch).SMOKE
