"""Partitioning rules: parameter / activation / cache specs per arch, and
their DTensor placements (the port of ``repro.sharding.rules``).

Axis discipline, as in the reference:

* ``model``: tensor parallelism (attention heads and ffn width, MoE experts,
  the vocab of the embedding and unembedding, the sequence of decode
  caches);
* ``data`` (+ ``pod``): the batch, and FSDP/ZeRO sharding of parameters and
  optimizer state for the archs too big for pure TP (llama4, dbrx,
  internvl2);
* ``pod``: the outer data tier, which joins FSDP for the 100B+ MoE archs.

A spec is a ``Spec``: a tuple with one entry per leading tensor dim, each
None, a mesh axis name, or a tuple of names, entry for entry the
reference's ``PartitionSpec``. ``placements`` turns it into the DTensor
placements of a torch ``DeviceMesh`` (one per mesh dim), and
``distribute`` places a tree of tensors by a tree of specs. A dim that does
not divide by its axes shards unevenly, as GSPMD pads;
``enforce_divisible`` drops such axes where the reference's jit inputs
need them to divide.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.models.common import ModelConfig
from repro_torch.train.optimizer import tree_map

# archs whose params/opt-state additionally shard over the data (and pod)
# axes: FSDP/ZeRO-3
FSDP_ARCHS = {"llama4-maverick-400b-a17b", "dbrx-132b", "internvl2-26b"}


class Spec(tuple):
    """A partition spec: ``Spec(None, "model")``, the reference's
    ``P(None, "model")``. A one-name tuple entry is that name, as
    ``PartitionSpec`` normalises it."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


def axis_names(mesh) -> tuple[str, ...]:
    return tuple(mesh.mesh_dim_names or ())


def axis_size(mesh, name: str) -> int:
    names = axis_names(mesh)
    if name not in names:
        raise ValueError(f"the mesh has no axis {name!r}; its axes are "
                         f"{names}")
    return mesh.size(names.index(name))


def batch_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in axis_names(mesh))


def axes_size(mesh, axes) -> int:
    n = 1
    for a in axes:
        n *= axis_size(mesh, a)
    return n


def _fsdp_axis(cfg: ModelConfig, mesh):
    if cfg.arch not in FSDP_ARCHS:
        return None
    axes = batch_axes(mesh)
    return axes if len(axes) > 1 else axes[0]


def param_specs(cfg: ModelConfig, params: Any, mesh) -> Any:
    """Spec tree matching the param tree structure, by path-name rules."""
    fsdp = _fsdp_axis(cfg, mesh)

    def rule(path: tuple[str, ...], x) -> Spec:
        name = path[-1]
        nd = x.ndim
        if name == "embed":
            return Spec("model", None)
        if name == "unembed":
            return Spec(None, "model")
        if "norm" in name:                   # incl. gate_norm, final_norm
            return Spec(*([None] * nd))
        if name in ("wq", "wk", "wv", "in_proj", "w_gate", "w_up",
                    "w_x", "w_gate_branch", "w_gate_x", "w_gate_a"):
            if nd == 4:                      # MoE expert: (L, E, d, ff)
                return Spec(None, "model", fsdp, None)
            return Spec(None, fsdp, "model")     # (L, d, X)
        if name in ("wo", "w_down", "out_proj", "w_out"):
            if nd == 4:                      # MoE expert: (L, E, ff, d)
                return Spec(None, "model", None, fsdp)
            return Spec(None, "model", fsdp)     # (L, X, d)
        if name in ("bq", "bk", "bv"):
            return Spec(None, "model")
        if name == "w_router":
            return Spec(None, None, None)    # small; replicate
        if name in ("a_log", "dt_bias", "d_skip", "lam"):
            return Spec(None, "model")
        if name == "conv_w":                 # (L, W, channels)
            return Spec(None, None, "model")
        return Spec(*([None] * nd))

    def walk(path, tree):
        if isinstance(tree, dict):
            return {k: walk(path + (k,), v) for k, v in tree.items()}
        return rule(path, tree)

    return walk((), params)


def placements(spec: Spec, mesh) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``, one per mesh dim:
    ``Shard(d)`` on each axis that tensor dim d names (a dim over two axes
    is sharded on both, in mesh order), ``Replicate()`` on the rest."""
    from torch.distributed.tensor import Replicate, Shard

    names = axis_names(mesh)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for a in entry if isinstance(entry, tuple) else (entry,):
            if a not in names:
                raise ValueError(f"spec {spec} names axis {a!r}; the mesh "
                                 f"has {names}")
            i = names.index(a)
            if not isinstance(out[i], Replicate):
                raise ValueError(f"spec {spec} uses axis {a!r} twice")
            out[i] = Shard(d)
    return tuple(out)


def param_shardings(cfg: ModelConfig, params: Any, mesh) -> Any:
    """The placements tree of ``param_specs``."""
    return tree_map(lambda s: placements(s, mesh),
                     param_specs(cfg, params, mesh))


def _spec_uses_axes(spec: Spec, axes: tuple[str, ...]) -> bool:
    for entry in spec:
        names = entry if isinstance(entry, tuple) else (entry,)
        if any(a in axes for a in names if a is not None):
            return True
    return False


def opt_state_spec_from_param_spec(spec: Spec, shape: tuple[int, ...],
                                   mesh) -> Spec:
    """ZeRO-1: optimizer moments additionally shard their largest
    unsharded dim over the data axes (an uneven dim shards unevenly)."""
    axes = batch_axes(mesh)
    if _spec_uses_axes(spec, axes):
        return spec                                        # already ZeRO'd
    entries = list(spec) + [None] * (len(shape) - len(spec))
    # find largest dim currently unsharded (skip dim 0 = layer stack)
    best, best_size = -1, 0
    for i in range(1, len(shape)):
        if entries[i] is None and shape[i] > best_size:
            best, best_size = i, shape[i]
    if best >= 0 and best_size >= 64:
        entries[best] = axes if len(axes) > 1 else axes[0]
    return Spec(*entries)


def opt_state_specs(kind: str, pspecs: Any, pshapes: Any, mesh,
                    compress: bool = False) -> dict:
    """Spec tree matching optimizer.init(...) structure (ZeRO-1 moments).
    ``pshapes`` is the param tree (anything with a ``shape``)."""
    moment = tree_map(
        lambda s, sh: opt_state_spec_from_param_spec(s, tuple(sh.shape),
                                                     mesh),
        pspecs, pshapes)
    out = {"m": moment, "step": Spec()}
    if kind == "adafactor":
        def fac(spec, sh):
            shape = tuple(sh.shape)
            entries = list(spec) + [None] * (len(shape) - len(spec))
            if len(shape) >= 2:
                return {"vr": Spec(*entries[:-1]),
                        "vc": Spec(*(entries[:-2] + entries[-1:]))}
            return {"v": Spec(*entries)}

        out["v"] = tree_map(fac, pspecs, pshapes)
    else:
        out["v"] = moment
        if compress:
            out["residual"] = tree_map(lambda s: s, pspecs)
    return out


def enforce_divisible(spec: Spec, shape: tuple[int, ...], mesh) -> Spec:
    """Drop the axes that do not divide their dim, e.g. an odd vocab
    (whisper's 51,865) falls back to a replicated embedding: the reference's
    jit inputs must divide exactly (unlike internal constraints, which
    GSPMD pads)."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for i, entry in enumerate(entries[: len(shape)]):
        if entry is None:
            out.append(None)
            continue
        names = entry if isinstance(entry, tuple) else (entry,)
        out.append(entry if shape[i] % axes_size(mesh, names) == 0
                   else None)
    return Spec(*out)


class NamedSharding(NamedTuple):
    """Where a leaf goes: a mesh and a spec (the reference's
    ``NamedSharding``)."""
    mesh: Any
    spec: Spec


def place(x: torch.Tensor, mesh, spec: Spec) -> torch.Tensor:
    """``x`` as a DTensor on ``mesh`` placed by ``spec``. A plain tensor is
    the full one, the same on every rank (made from the same seed, or read
    from the same checkpoint), so each rank keeps its own shard and nothing
    is sent; a DTensor on another mesh is gathered first, one on ``mesh``
    redistributed."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    pl = placements(spec, mesh)
    if isinstance(x, DTensor):
        if x.device_mesh == mesh:
            return x.redistribute(mesh, pl)
        x = x.full_tensor()
    if x.device.type != mesh.device_type:
        x = x.to(mesh.device_type)
    return distribute_tensor(x, mesh, pl, src_data_rank=None)


def distribute(tree: Any, spec_tree: Any, mesh, *,
               divisible: bool = True) -> Any:
    """Each tensor of ``tree`` placed on ``mesh`` by its spec (``place``),
    through ``enforce_divisible`` unless ``divisible`` is False."""
    def one(x, spec):
        if divisible:
            spec = enforce_divisible(spec, tuple(x.shape), mesh)
        return place(x, mesh, spec)

    return tree_map(one, tree, spec_tree)


def batch_spec(mesh) -> Spec:
    return Spec(batch_axes(mesh), None)


def activation_spec(mesh) -> Spec:
    return Spec(batch_axes(mesh), None, None)


def logits_spec(mesh) -> Spec:
    return Spec(batch_axes(mesh), None, "model")


def kv_cache_spec(mesh, batch: int) -> Spec:
    """(L, b, s_max, kv, hd): batch over data axes when divisible, the
    cache sequence over model (sequence-sharded decode)."""
    axes = batch_axes(mesh)
    n = axes_size(mesh, axes)
    if batch % n == 0 and batch >= n:
        return Spec(None, axes, "model", None, None)
    # tiny batch (long_500k b=1): shard sequence over everything
    return Spec(None, None, (*axes, "model"), None, None)


def ssm_cache_specs(mesh, batch: int) -> dict:
    axes = batch_axes(mesh)
    n = axes_size(mesh, axes)
    if batch % n == 0 and batch >= n:
        return {"ssm": Spec(None, axes, "model", None, None),
                "conv": Spec(None, axes, None, "model")}
    return {"ssm": Spec(None, None, "model", None, None),
            "conv": Spec(None, None, None, "model")}


def cache_specs(cfg: ModelConfig, cache: Any, mesh, batch: int) -> Any:
    """Spec tree matching init_cache(...) structure."""
    if cfg.kind in ("dense", "moe", "vlm"):
        kv = kv_cache_spec(mesh, batch)
        return {"k": kv, "v": kv}
    if cfg.kind == "ssm":
        return ssm_cache_specs(mesh, batch)
    if cfg.kind == "encdec":
        kv = kv_cache_spec(mesh, batch)
        return {"k": kv, "v": kv, "xk": kv, "xv": kv}
    if cfg.kind == "hybrid":
        kv = kv_cache_spec(mesh, batch)
        axes = batch_axes(mesh)
        n = axes_size(mesh, axes)
        if batch % n == 0 and batch >= n:
            rg = {"h": Spec(None, axes, "model"),
                  "conv": Spec(None, axes, None, "model")}
        else:
            rg = {"h": Spec(None, None, "model"),
                  "conv": Spec(None, None, None, "model")}

        def per_entry(subtree):
            return {"k": kv, "v": kv} if "k" in subtree else dict(rg)

        return {k: per_entry(v) for k, v in cache.items()}
    raise ValueError(cfg.kind)


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (False where torch has no distributed)."""
    if not torch.distributed.is_available():
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def replicate_dims(x, dims) -> Any:
    """A DTensor with its shards on ``dims`` (and any pending partial
    sums) gathered: replicated on those mesh dims; x itself otherwise."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard

    dims = {d % x.ndim for d in dims}
    pl = tuple(Replicate() if (isinstance(p, Shard) and p.dim in dims)
               or p.is_partial() else p for p in x.placements)
    return x if pl == tuple(x.placements) else x.redistribute(
        x.device_mesh, pl)


def batch_only(x) -> Any:
    """A DTensor replicated on every dim but its leading (batch) one; x
    itself otherwise."""
    if not is_dtensor(x):
        return x
    return replicate_dims(x, range(1, x.ndim))


def pin_activation(x) -> Any:
    """A (b, s, d) DTensor activation placed by ``activation_spec`` (batch
    over the data axes where it divides, replicated over ``model``), its
    gradient placed alike in the backward, as a GSPMD sharding constraint
    binds both; x itself otherwise. The model pins its residual stream at
    each block's entry so that DTensor's op-by-op choices start from the
    reference's layout in every block, both ways."""
    if not is_dtensor(x):
        return x
    mesh = x.device_mesh
    pl = placements(enforce_divisible(activation_spec(mesh), tuple(x.shape),
                                      mesh), mesh)
    return _Pin.apply(x, pl)


class _Pin(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pl):
        ctx.pl = pl
        return x if tuple(x.placements) == pl else x.redistribute(
            x.device_mesh, pl)

    @staticmethod
    def backward(ctx, grad):
        if tuple(grad.placements) != ctx.pl:
            grad = grad.redistribute(grad.device_mesh, ctx.pl)
        return grad, None


def gather_rows(table, idx):
    """``table[idx]``: rows of a (V, d) table at integer indices. On a mesh
    the lookup runs on each rank's local tensors: the table is gathered
    whole (replicated), the indices keep their batch shards, and the
    table's gradient is each rank's partial sum over its own indices.
    DTensor's own rule for the lookup masks vocab shards and, in torch
    2.11, fails in its backward (``index_put`` with an unnormalised
    shard dim)."""
    if not is_dtensor(table):
        return table[idx]
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = table.device_mesh
    if not is_dtensor(idx):
        idx = DTensor.from_local(idx, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    pl = tuple(Shard(0) if isinstance(p, Shard) and p.dim == 0
               else Replicate() for p in idx.placements)
    idx = idx.redistribute(mesh, pl)
    full = table.redistribute(mesh, [Replicate()] * mesh.ndim)
    grad_pl = [Partial() if isinstance(p, Shard) else Replicate()
               for p in pl]
    rows = full.to_local(grad_placements=grad_pl)[idx.to_local()]
    return from_local(rows, mesh, pl,
                      tuple(idx.shape) + tuple(table.shape[1:]))


def from_local(local: torch.Tensor, mesh, pl, shape) -> torch.Tensor:
    """This rank's contiguous ``local`` shard as a DTensor of global
    ``shape`` with placements ``pl`` (no check, no communication)."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local.contiguous(), mesh, pl, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta")
                              .stride())
