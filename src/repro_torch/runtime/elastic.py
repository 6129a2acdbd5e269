"""Elastic scaling: reshard a training state between meshes (the port of
``repro.runtime.elastic``).

Grow or shrink the data axis (or move between single- and multi-pod
meshes) through a checkpoint round-trip: the state is saved mesh-agnostic
(each DTensor as its full tensor, host numpy: the reference's layout) and
restored with the placements of the target mesh. Because the data pipeline
is keyed by (step, shard) and the global batch is fixed, changing the
data-parallel degree changes only per-host shard sizes; step semantics
(and therefore the loss trajectory) are unchanged.

The target is a spec tree and a torch ``DeviceMesh``, as the reference's
is a spec tree and a mesh. A ``torch.device`` in place of the spec tree
(and no mesh) is the shorthand for the 1 x 1 mesh of one device: every
leaf a plain tensor on it.
"""

from __future__ import annotations

import tempfile
from typing import Any

import torch

from repro_torch.ckpt.checkpoint import Checkpointer
from repro_torch.device import resolve_device
from repro_torch.sharding import rules
from repro_torch.train.optimizer import tree_map


def _is_device(x) -> bool:
    return isinstance(x, (str, torch.device))


def reshard_state(state: Any, spec_tree: Any, target_mesh=None) -> Any:
    """In-memory reshard: every leaf of a nested dict placed on
    ``target_mesh`` by its spec (DTensor moves the bytes); with a device
    for ``spec_tree`` and no mesh, every leaf moved onto that device."""
    if _is_device(spec_tree) and target_mesh is None:
        dev = resolve_device(spec_tree)
        return tree_map(lambda x: x.to(dev), state)
    return rules.distribute(state, spec_tree, target_mesh, divisible=False)


def reshard_via_checkpoint(state: Any, spec_tree: Any, target_mesh=None,
                           directory: str | None = None) -> Any:
    """Checkpoint round-trip reshard (the restartable, cross-job form): save
    ``state`` to ``directory`` (a temporary one by default) and restore it
    in its dtypes with the target's placements. The device shorthand is
    ``reshard_via_checkpoint(state, device[, directory])``."""
    if _is_device(spec_tree):
        if target_mesh is not None and directory is None:
            target_mesh, directory = None, target_mesh
        dev = resolve_device(spec_tree)
        shardings = tree_map(lambda _: dev, state)
    else:
        shardings = tree_map(lambda s: rules.NamedSharding(target_mesh, s),
                             spec_tree)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = Checkpointer(directory or tmp)
        ckpt.save(0, state, blocking=True)
        _, restored = ckpt.restore(0, like=state, shardings=shardings)
        return restored
