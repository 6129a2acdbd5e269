"""Build and bind the port's CUDA kernels (``src/repro_torch/csrc/*.cu``).

Each source compiles with ``nvcc`` into its own shared library with a plain
C interface, loaded with ``ctypes``; no PyTorch header is compiled, so a
build takes seconds. The build runs at the first CUDA launch, never at
import, into ``build/repro_torch/<hash>/`` of the checkout, where the hash
covers every file of ``csrc/`` and the flags: an edited source builds anew,
an unchanged one is reused. All sources compile at once, one ``nvcc``
process each. ``BUILD_ROOT`` may be pointed elsewhere
(``serve.enable_compilation_cache``) so that a new worker reuses the
libraries another process built; ``builds`` counts the sources this
process compiled.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("fused_cycle", "mover", "deposit", "collide", "births",
           "flash_attention")
# -fmad=false: no multiply-add contraction, so each PIC kernel rounds
# exactly as its plain PyTorch version does (see csrc/pic_common.cuh); flash
# attention writes its multiply-adds as fmaf() instead
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}
build_seconds: float | None = None
builds = 0             # nvcc compilations run by this process


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "source at their first launch and need the CUDA "
                       "toolkit")


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build() -> Path:
    """Compile every source that has no library yet, all in parallel.
    Returns the directory of the libraries; raises with nvcc's output on a
    failed build. ``build_seconds`` records the wall time of the build."""
    global build_seconds, builds
    out = build_dir()
    todo = [n for n in SOURCES if not (out / f"lib{n}.so").exists()]
    t0 = time.perf_counter()
    if todo:
        out.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        builds += len(todo)
        procs = {}
        for name in todo:
            tmp = out / f"lib{name}.so.{os.getpid()}.tmp"
            log = open(out / f"{name}.log", "w")
            procs[name] = (subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
                stdout=log, stderr=subprocess.STDOUT), tmp, log)
        failed = []
        for name, (proc, tmp, log) in procs.items():
            rc = proc.wait()
            log.close()
            if rc != 0:
                failed.append(name)
            else:
                os.replace(tmp, out / f"lib{name}.so")
        if failed:
            logs = "\n".join(f"--- {n}.cu ---\n"
                             + (out / f"{n}.log").read_text() for n in failed)
            raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
    build_seconds = time.perf_counter() - t0
    return out


def function(source: str, name: str, argtypes) -> ctypes._CFuncPtr:
    """The C function ``name`` of ``csrc/<source>.cu``, building on first
    use. Every C launcher returns cudaGetLastError() as an int."""
    if source not in _libs:
        _libs[source] = ctypes.CDLL(str(build() / f"lib{source}.so"))
    fn = getattr(_libs[source], name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check_launch(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require(t: torch.Tensor, name: str, dtype: torch.dtype,
            shape: tuple[int, ...], device: torch.device) -> None:
    """Raise on anything a kernel does not take: another device, dtype,
    shape, or a non-contiguous layout."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def require_cuda(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what} launches a CUDA kernel; got a tensor on "
                         f"{t.device} (the plain version serves the CPU)")
