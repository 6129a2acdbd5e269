"""Trees of tensors, walked leaf by leaf.

A tree is nested dicts (keys sorted), lists, tuples, named tuples and
dataclasses; ``None`` is an empty subtree. A leaf is a tensor, a numpy
array or a Python number. A leaf's path is its components from the root:
dict keys, sequence indices, field names, as ``jax.tree_util`` names them
in the reference. ``ckpt.checkpoint`` lays its files out by these paths;
the engine's CUDA graphs (``distributed.engine``) keep a state's tensors
in their order.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator

import numpy as np
import torch


def is_leaf(x: Any) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray, np.generic, int, float,
                          bool))


def children(tree: Any) -> list[tuple[str, Any]]:
    """(path component, child) of one container node, in flattening
    order."""
    if dataclasses.is_dataclass(tree):
        return [(f.name, getattr(tree, f.name))
                for f in dataclasses.fields(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [(n, getattr(tree, n)) for n in tree._fields]
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    raise TypeError(f"cannot flatten a {type(tree).__name__}")


def leaves(tree: Any, path: tuple = ()) -> Iterator[tuple[tuple, Any]]:
    """(path, leaf) of every leaf, depth first."""
    if tree is None:
        return
    if is_leaf(tree):
        yield path, tree
        return
    for name, child in children(tree):
        yield from leaves(child, path + (name,))


def rebuild(tree: Any, fn: Callable, path: tuple = ()) -> Any:
    """``tree`` with every leaf replaced by ``fn(path, leaf)``."""
    if tree is None:
        return None
    if is_leaf(tree):
        return fn(path, tree)
    kids = {name: rebuild(child, fn, path + (name,))
            for name, child in children(tree)}
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **kids)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(**kids)
    if isinstance(tree, dict):
        return {k: kids[str(k)] for k in tree}
    return type(tree)(kids[str(i)] for i in range(len(tree)))
