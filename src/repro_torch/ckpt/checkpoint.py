"""Checkpointing: async writes, atomic manifests (the port of
``repro.ckpt.checkpoint``, with its on-disk layout).

Layout: <dir>/step_<N>/arrays.npz + manifest.json. The manifest is written
LAST (atomic rename), so a crash mid-write never yields a "latest" pointer
to a torn checkpoint: restart scans for the newest complete step.

Async: the arrays are copied to host memory on the caller's thread (the
only wait on the device, and a copy, so the caller may change its tensors
in place right after); ``np.savez`` and the manifest run on a writer
thread while the caller goes on.

Trees: nested dicts (keys sorted), lists, tuples, named tuples and
dataclasses flatten to ``{key path: array}``, the path components joined by
"/": dict keys, sequence indices, field names, as ``jax.tree_util`` names
them in the reference, so the two packages read each other's files. ``None``
is an empty subtree. A leaf is a tensor, a numpy array or a Python number.
Dtypes npz cannot hold (bfloat16 and the like) are stored as float32 with
the true dtype in the manifest; float32 holds every bfloat16 exactly, so
the cast back is bitwise.

A DTensor leaf (a training state on a mesh) is saved as its full tensor
(``full_tensor()``, then host numpy: the reference's mesh-agnostic
layout) and restored with the target's placements: a
``sharding.rules.NamedSharding`` in ``shardings``, else its ``like``
leaf's mesh and placements.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import threading
import time
from typing import Any, Callable, Iterator

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.sharding.rules import NamedSharding, is_dtensor, place

SEP = "/"


def _is_leaf(x: Any) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray, np.generic, int, float,
                          bool))


def _children(tree: Any) -> list[tuple[str, Any]]:
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
    raise TypeError(f"cannot checkpoint a {type(tree).__name__}")


def _leaves(tree: Any, path: tuple = ()) -> Iterator[tuple[tuple, Any]]:
    """(path, leaf) of every leaf, depth first."""
    if tree is None:
        return
    if _is_leaf(tree):
        yield path, tree
        return
    for name, child in _children(tree):
        yield from _leaves(child, path + (name,))


def _rebuild(tree: Any, fn: Callable, path: tuple = ()) -> Any:
    """``tree`` with every leaf replaced by ``fn(path, leaf)``."""
    if tree is None:
        return None
    if _is_leaf(tree):
        return fn(path, tree)
    kids = {name: _rebuild(child, fn, path + (name,))
            for name, child in _children(tree)}
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **kids)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(**kids)
    if isinstance(tree, dict):
        return {k: kids[str(k)] for k in tree}
    return type(tree)(kids[str(i)] for i in range(len(tree)))


def _path_str(path: tuple) -> str:
    return SEP.join(path)


def _numpy_dtype(dtype) -> np.dtype | None:
    """The numpy dtype of a torch or numpy dtype; None where numpy has
    none (bfloat16, the float8 types)."""
    if isinstance(dtype, torch.dtype):
        try:
            return torch.empty(0, dtype=dtype).numpy().dtype
        except TypeError:
            return None
    dtype = np.dtype(dtype)
    if dtype.kind == "V" or dtype.name == "bfloat16":
        return None
    return dtype


def _storable(leaf: Any) -> tuple[np.ndarray, str | None]:
    """A host copy of ``leaf`` npz can hold, and its true dtype where that
    is not the copy's (stored as float32)."""
    if isinstance(leaf, torch.Tensor):
        if is_dtensor(leaf):
            leaf = leaf.full_tensor()
        t = leaf.detach().to("cpu", copy=True)
        if _numpy_dtype(t.dtype) is None:
            return t.float().numpy(), str(t.dtype).removeprefix("torch.")
        return t.numpy(), None
    arr = np.array(leaf)                              # a copy
    if _numpy_dtype(arr.dtype) is None:
        return arr.astype(np.float32), str(arr.dtype)
    return arr, None


def _flatten_with_dtypes(tree: Any) -> tuple[dict[str, np.ndarray],
                                             dict[str, str]]:
    flat: dict[str, np.ndarray] = {}
    dtypes: dict[str, str] = {}
    for path, leaf in _leaves(tree):
        key = _path_str(path)
        if key in flat:
            raise ValueError(f"duplicate checkpoint key {key!r}")
        arr, true_dtype = _storable(leaf)
        flat[key] = arr
        if true_dtype is not None:
            dtypes[key] = true_dtype
    return flat, dtypes


def _flatten(tree: Any) -> dict[str, np.ndarray]:
    return _flatten_with_dtypes(tree)[0]


def _cast_true(flat: dict[str, np.ndarray],
               dtypes: dict[str, str]) -> dict[str, np.ndarray]:
    """The true dtype of each leaf the manifest names, where numpy has it
    (a bfloat16 leaf stays float32 until it becomes a tensor)."""
    out = {}
    for k, v in flat.items():
        want = _true_numpy(dtypes.get(k))
        out[k] = v.astype(want) if want is not None else v
    return out


def _true_numpy(name: str | None) -> np.dtype | None:
    if name is None:
        return None
    try:
        return _numpy_dtype(np.dtype(name))
    except TypeError:
        return None


def _tensor(arr: np.ndarray, true_dtype: str | torch.dtype | None,
            device=None) -> torch.Tensor:
    """A tensor of a restored leaf, in its true dtype, on ``device``."""
    t = torch.tensor(np.asarray(arr), device=device)
    if isinstance(true_dtype, str):
        true_dtype = getattr(torch, true_dtype, None)
    if isinstance(true_dtype, torch.dtype) and t.dtype != true_dtype:
        t = t.to(true_dtype)
    return t


def _unflatten(flat: dict[str, np.ndarray]) -> Any:
    """Rebuild a *nested dict* from flat keys (structure-free restore)."""
    tree: dict = {}
    for key, val in flat.items():
        parts = key.split(SEP)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return tree


def _unflatten_like(flat: dict[str, np.ndarray], like: Any,
                    dtypes: dict[str, str] | None = None) -> Any:
    """Rebuild with ``like``'s exact structure (dataclasses, named tuples,
    ...), each leaf a tensor where ``like``'s is one and an array
    otherwise, in ``like``'s dtype. Strict: the stored and expected key
    sets must match, and so must every shape."""
    ref_keys = [_path_str(p) for p, _ in _leaves(like)]
    missing = sorted(set(ref_keys) - set(flat))
    extra = sorted(set(flat) - set(ref_keys))
    if missing or extra:
        raise ValueError(
            "checkpoint does not match the `like` tree: "
            f"missing keys {missing[:8]}{'...' if len(missing) > 8 else ''}, "
            f"extra keys {extra[:8]}{'...' if len(extra) > 8 else ''}")

    def leaf(path, ref):
        key = _path_str(path)
        arr = np.asarray(flat[key])
        ref_shape = tuple(getattr(ref, "shape", arr.shape))
        if ref_shape != arr.shape:
            raise ValueError(
                f"checkpoint leaf {key!r} has shape {arr.shape}, expected "
                f"{ref_shape} — device/capacity layout changed; use the "
                "elastic restore path (runtime/resilience.py)")
        dtype = getattr(ref, "dtype", None)
        if is_dtensor(ref):
            return _placed(_tensor(arr, dtype, ref.device), ref.device_mesh,
                           ref.placements)
        if isinstance(ref, torch.Tensor):
            return _tensor(arr, dtype, ref.device)
        want = _numpy_dtype(dtype) if dtype is not None else None
        if want is None:
            want = _true_numpy((dtypes or {}).get(key))
        return arr.astype(want) if want is not None else arr

    return _rebuild(like, leaf)


class Checkpointer:
    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self.last_write_us: float = 0.0

    # ------------------------------------------------------------- save
    def save(self, step: int, tree: Any, blocking: bool = False,
             meta: dict | None = None) -> dict:
        """Copy to host synchronously, write asynchronously.

        Returns ``{"bytes": payload size, "fetch_us": host-copy time}`` —
        the synchronous cost the step loop actually paid; the file write
        happens off-thread (its duration lands in ``last_write_us``).
        """
        t0 = time.perf_counter()
        host, dtypes = _flatten_with_dtypes(tree)
        fetch_us = (time.perf_counter() - t0) * 1e6
        nbytes = int(sum(v.nbytes for v in host.values()))
        self.wait()                      # one outstanding write at a time

        def write():
            t1 = time.perf_counter()
            path = os.path.join(self.dir, f"step_{step:08d}")
            os.makedirs(path, exist_ok=True)
            np.savez(os.path.join(path, "arrays.npz"), **host)
            manifest = {"step": step, "keys": sorted(host),
                        "dtypes": dtypes, "meta": meta or {},
                        "complete": True}
            tmp = os.path.join(path, "manifest.tmp")
            with open(tmp, "w") as f:
                json.dump(manifest, f)
            os.replace(tmp, os.path.join(path, "manifest.json"))
            self.last_write_us = (time.perf_counter() - t1) * 1e6

        if blocking:
            write()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()
        return {"bytes": nbytes, "fetch_us": fetch_us}

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    # ---------------------------------------------------------- restore
    def _manifest(self, step: int) -> dict:
        mpath = os.path.join(self.dir, f"step_{step:08d}", "manifest.json")
        with open(mpath) as f:
            return json.load(f)

    def latest_step(self) -> int | None:
        steps = []
        for name in os.listdir(self.dir):
            mpath = os.path.join(self.dir, name, "manifest.json")
            if name.startswith("step_") and os.path.exists(mpath):
                try:
                    with open(mpath) as f:
                        m = json.load(f)
                except (json.JSONDecodeError, OSError):
                    continue             # torn manifest: not a valid step
                if m.get("complete"):
                    steps.append(m["step"])
        return max(steps) if steps else None

    def restore_flat(self, step: int | None = None
                     ) -> tuple[int, dict[str, np.ndarray], dict]:
        """Load one checkpoint as ``{keypath: host array}`` (true dtypes
        restored from the manifest where numpy has them) plus the manifest
        itself."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no complete checkpoint in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:08d}", "arrays.npz")
        with np.load(path) as z:
            flat = {k: z[k] for k in z.files}
        try:
            manifest = self._manifest(step)
        except (FileNotFoundError, json.JSONDecodeError):
            manifest = {"step": step, "dtypes": {}, "meta": {}}
        return step, _cast_true(flat, manifest.get("dtypes", {})), manifest

    def restore(self, step: int | None = None, shardings: Any = None,
                like: Any = None, device=None) -> tuple[int, Any]:
        """Load a checkpoint as tensors. Each leaf lands on its target in
        ``shardings`` (the same tree structure, a ``torch.device`` or a
        ``NamedSharding`` a leaf) if given, else on the device of its ``like`` leaf where that is a
        tensor, else on ``device`` (default ``"cuda"``, which raises when
        no card is present). ``like`` (a tree of tensors or arrays, e.g.
        ``engine.state_shape``) rebuilds the exact stored structure and
        restores dtypes; stored leaves absent from ``like`` (or vice versa)
        raise."""
        step, flat, manifest = self.restore_flat(step)
        return step, tensors_from_flat(flat, manifest.get("dtypes", {}),
                                       like, shardings, device)


def tensors_from_flat(flat: dict[str, np.ndarray], dtypes: dict[str, str],
                      like: Any = None, shardings: Any = None,
                      device=None) -> Any:
    """``Checkpointer.restore`` on arrays already loaded (``restore_flat``
    and its manifest's ``dtypes``): the tree of ``like`` (strict), or
    nested dicts without one, of tensors in their true dtypes, each on its
    device in ``shardings``, else on its ``like`` leaf's device, else on
    ``device`` (default ``"cuda"``)."""
    tree = (_unflatten_like(flat, like, dtypes) if like is not None
            else _unflatten(flat))
    devices = ({_path_str(p): d for p, d in _leaves_devices(shardings)}
               if shardings is not None else {})
    default: list[torch.device] = []          # resolved at first need

    def to_tensor(path, leaf):
        dev = devices.get(_path_str(path))
        if isinstance(dev, NamedSharding):
            if not isinstance(leaf, torch.Tensor):
                leaf = _tensor(leaf, dtypes.get(_path_str(path)),
                               dev.mesh.device_type)
            return place(leaf, dev.mesh, dev.spec)
        if isinstance(leaf, torch.Tensor):    # built on its like leaf's
            if dev is None:
                return leaf
            return (leaf.full_tensor() if is_dtensor(leaf) else leaf).to(dev)
        if dev is None:
            if not default:
                default.append(resolve_device(
                    "cuda" if device is None else device))
            dev = default[0]
        return _tensor(leaf, dtypes.get(_path_str(path)), dev)

    return _rebuild(tree, to_tensor)


def _placed(t: torch.Tensor, mesh, placements) -> torch.Tensor:
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(t, mesh, placements, src_data_rank=None)


def _leaves_devices(tree: Any) -> Iterator[tuple[tuple, Any]]:
    """(path, target) of a tree whose leaves are devices or
    ``NamedSharding``s."""
    if isinstance(tree, (torch.device, NamedSharding)):
        yield (), tree
        return
    for name, child in _children(tree):
        for path, dev in _leaves_devices(child):
            yield (name,) + path, dev


def roundtrip_bytes(tree: Any) -> Any:
    """Flatten -> in-memory npz -> unflatten, preserving dtypes — the pure
    serialization round-trip, used by the property tests (no
    filesystem)."""
    flat, dtypes = _flatten_with_dtypes(tree)
    buf = io.BytesIO()
    np.savez(buf, **flat)
    buf.seek(0)
    with np.load(buf) as z:
        loaded = {k: z[k] for k in z.files}
    return _unflatten_like(_cast_true(loaded, dtypes), tree, dtypes)
