"""Mesh construction: torch ``DeviceMesh``es with the reference's axis names
(the port of ``repro.launch.mesh``).

Axes, as in the reference:

* ``data``: batch / spatial-domain parallelism (PIC domains live here);
* ``model``: tensor/expert parallelism for the LM substrate;
* ``pod``: a second data-parallel tier.

A mesh needs a default process group. When none exists, ``start_group``
starts one from the environment, the path a cluster job under ``torchrun``
takes: world size and rank from ``WORLD_SIZE`` / ``RANK`` (a single
process is world 1, whose group needs no address), the address from
``MASTER_ADDR`` / ``MASTER_PORT`` otherwise; NCCL for a mesh on the card,
gloo on the CPU. The dry-run asks for torch's ``fake`` backend at world
256 or 512 instead (``start_group("fake", 512)``): ranks that exist only
as names, the counterpart of the reference's 512 host devices, on which
nothing runs and nothing is sent.
"""

from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist

POD = (16, 16)
MULTIPOD = (2, 16, 16)


def start_group(backend: str | None = None, world_size: int | None = None,
                device: str = "cuda") -> None:
    """Start the default process group unless one exists. ``backend``
    "fake" makes a group of ``world_size`` named ranks (this process is
    rank 0); otherwise NCCL for ``device`` "cuda", gloo for "cpu", with
    the world size and rank of the environment."""
    if dist.is_initialized():
        return
    if backend == "fake":
        from torch.testing._internal.distributed.fake_pg import FakeStore

        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world_size)
        return
    backend = backend or ("nccl" if device == "cuda" else "gloo")
    world = int(os.environ.get("WORLD_SIZE", world_size or 1))
    rank = int(os.environ.get("RANK", 0))
    if device == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank))
                              % max(torch.cuda.device_count(), 1))
    if world == 1:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    else:
        dist.init_process_group(backend, init_method="env://", rank=rank,
                                world_size=world)


def stop_group() -> None:
    """Destroy the default process group (and the meshes' groups), if any."""
    if dist.is_initialized():
        dist.destroy_process_group()


def _device_type(device) -> str:
    dev = torch.device(device).type
    if dev == "cuda" and not torch.cuda.is_available() and not (
            dist.is_initialized() and dist.get_backend() == "fake"):
        raise RuntimeError("a mesh on 'cuda' was asked for but no CUDA "
                           "device is available; pass device='cpu'")
    return dev


def _make_mesh(shape, axes, device) -> "dist.DeviceMesh":
    from torch.distributed.device_mesh import DeviceMesh

    dev = _device_type(device)
    start_group(device=dev)
    need = math.prod(shape)
    world = dist.get_world_size()
    if world < need:
        raise RuntimeError(
            f"a {' x '.join(map(str, shape))} mesh ({', '.join(axes)}) needs "
            f"{need} ranks; the process group has {world}. Launch {need} "
            f"processes (torchrun --nproc-per-node ... with WORLD_SIZE="
            f"{need}), or use the 1 x 1 debug mesh")
    # a larger group lends its first ``need`` ranks (the reference's
    # 512-device dry-run takes the first 256 for the single-pod mesh)
    ranks = torch.arange(need, dtype=torch.int64).reshape(shape)
    return DeviceMesh(dev, ranks, mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device="cuda") -> "dist.DeviceMesh":
    """The 16 x 16 (data, model) mesh, or 2 x 16 x 16 (pod, data, model).
    Raises when the process group has fewer ranks; never builds a smaller
    mesh."""
    if multi_pod:
        return _make_mesh(MULTIPOD, ("pod", "data", "model"), device)
    return _make_mesh(POD, ("data", "model"), device)


def make_debug_mesh(data: int = 1, model: int = 1, pod: int = 0,
                    device="cuda") -> "dist.DeviceMesh":
    """Small mesh for tests on whatever ranks exist (1 x 1: one process)."""
    if pod:
        return _make_mesh((pod, data, model), ("pod", "data", "model"),
                          device)
    return _make_mesh((data, model), ("data", "model"), device)


def domain_axes(mesh) -> tuple[str, ...]:
    """Axes carrying the PIC spatial decomposition: ('pod','data') if the
    pod axis exists, else ('data',)."""
    names = tuple(mesh.mesh_dim_names or ())
    return tuple(a for a in ("pod", "data") if a in names)


def domain_count(mesh) -> int:
    """The number of PIC domains of ``mesh``: the product of its domain
    axes."""
    names = tuple(mesh.mesh_dim_names)
    return math.prod(mesh.size(names.index(a)) for a in domain_axes(mesh))
