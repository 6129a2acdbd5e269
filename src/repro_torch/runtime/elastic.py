"""Elastic scaling: move a training state to another placement (the port
of ``repro.runtime.elastic``).

The reference reshards between JAX meshes, the target given as a
``NamedSharding`` spec tree on a mesh. The port has no mesh yet (it comes
with ``sharding/rules.py`` and ``launch/mesh.py``); its one-card
counterpart of the reference's 1 x 1 debug mesh is a ``torch.device``, and
the target here is that device. The checkpoint form is the restartable,
cross-job one: the state is saved device-agnostic (host numpy, the
reference's layout) and restored onto the target. Because the data
pipeline is keyed by (step, shard) and the global batch is fixed, a move
changes no step's semantics.
"""

from __future__ import annotations

import tempfile
from typing import Any

from repro_torch.ckpt.checkpoint import Checkpointer
from repro_torch.device import resolve_device
from repro_torch.train.optimizer import tree_map


def reshard_state(state: Any, device) -> Any:
    """In-memory move: every leaf of a nested dict onto ``device``."""
    dev = resolve_device(device)
    return tree_map(lambda x: x.to(dev), state)


def reshard_via_checkpoint(state: Any, device,
                           directory: str | None = None) -> Any:
    """Checkpoint round-trip move (the restartable, cross-job form): save
    ``state`` (a nested dict of tensors) to ``directory`` (a temporary
    one by default) and restore it onto ``device`` in its dtypes."""
    dev = resolve_device(device)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = Checkpointer(directory or tmp)
        ckpt.save(0, state, blocking=True)
        _, restored = ckpt.restore(
            0, like=state, shardings=tree_map(lambda _: dev, state))
        return restored
