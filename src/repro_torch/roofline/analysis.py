"""Roofline terms of a program, counted as it runs (the port of
``repro.roofline.analysis``).

Per (arch x shape x mesh):
  compute    = FLOPs / PEAK_FLOPS
  memory     = bytes / HBM_BW
  collective = collective_bytes / LINK_BW

The reference parses them from the compiled per-device HLO
(``hlo_parser``, which weights a scan's body by its trip count). The port
has no HLO: ``analyze`` runs the program under ``CostMode``, which counts
each aten op as eager PyTorch runs it, one kernel an op, so a layer's ops
count as often as they run and no trip count is needed. On a DTensor the
mode lets DTensor dispatch first and counts the ops it issues on the local
shards, so every figure is this rank's: per chip, as the reference's are.

* FLOPs: ``torch.utils.flop_counter``'s formula for each op (the formulas
  ``FlopCounterMode`` uses; the flash operator registers its own);
* bytes: each op's tensor inputs and outputs (the eager counterpart of the
  reference's "operand + output bytes per post-fusion op"); views move
  nothing and count nothing;
* collective bytes: the output bytes of the ``_c10d_functional``
  collectives DTensor issues, by kind, under the reference's five names.

Under ``FakeTensorMode`` nothing is allocated and nothing runs, and the
counts are the same. DTensor works out each op's global output shape by
running it once on fake tensors of the global shape (its sharding
propagation); those runs are not the program's, and neither ``CostMode``
nor ``PeakMemory`` counts them.

Hardware constants: NVIDIA H100 SXM5 80 GB (NVIDIA H100 Tensor Core GPU
datasheet): 989 TFLOP/s bf16 dense tensor core, 3.35 TB/s HBM3, and
900 GB/s NVLink (4th generation, total bidirectional per GPU).
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
from torch._guards import active_fake_mode
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

PEAK_FLOPS = 989e12          # bf16 dense / card (H100 SXM5 datasheet)
HBM_BW = 3.35e12             # bytes/s / card (H100 SXM5 datasheet)
LINK_BW = 900e9              # bytes/s / card, NVLink 4 (H100 datasheet)

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")
# the _c10d_functional ops DTensor issues, by the reference's names
_C10D_KIND = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


# ops that allocate, or alias without the view mark, and move nothing
_ALLOCATIONS = {"empty", "empty_strided", "empty_like", "new_empty",
                "new_empty_strided", "_unsafe_view"}


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return 0


def _dtensor_type():
    if not torch.distributed.is_available():
        return None
    from torch.distributed.tensor import DTensor

    return DTensor


class _Propagation:
    """Counts the runs of DTensor's tensor-meta propagation under way:
    ``ShardingPropagator._propagate_tensor_meta_non_cached``, wrapped on
    the class while a counting mode is entered (every propagation,
    cached or not, calls it through ``self``)."""

    def __init__(self):
        self.depth = 0

    def wrap(self, fn):
        def wrapped(*args, **kwargs):
            self.depth += 1
            try:
                return fn(*args, **kwargs)
            finally:
                self.depth -= 1

        return wrapped


_watch: list = []      # the installed _Propagation, while a mode is entered
_META = "_propagate_tensor_meta_non_cached"


@contextlib.contextmanager
def _watching():
    prop_cls = None
    if torch.distributed.is_available():
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
        if hasattr(ShardingPropagator, _META):
            prop_cls = ShardingPropagator
    if prop_cls is None or _watch:
        _watch.append(_watch[-1] if _watch else None)
        try:
            yield
        finally:
            _watch.pop()
        return
    old = getattr(prop_cls, _META)
    watch = _Propagation()
    setattr(prop_cls, _META, watch.wrap(old))
    _watch.append(watch)
    try:
        yield
    finally:
        _watch.pop()
        setattr(prop_cls, _META, old)


def _propagating() -> bool:
    return bool(_watch and _watch[-1] is not None and _watch[-1].depth)


def _foreign(tensors, fake_mode) -> bool:
    """A fake tensor of another mode than the program's: DTensor's
    propagation on global shapes."""
    return any(isinstance(t, FakeTensor) and t.fake_mode is not fake_mode
               for t in tensors)


class CostMode(TorchDispatchMode):
    """Counts the FLOPs, bytes and collective bytes of the aten ops run
    under it (see the module docstring). ``by_op`` holds each op's FLOPs."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.hbm_bytes = 0
        self.coll = {k: 0 for k in _COLLECTIVES}
        self.by_op: dict[str, int] = {}
        self._dtensor = _dtensor_type()
        self._fake_mode = None
        self._stack = contextlib.ExitStack()

    def __enter__(self):
        self._fake_mode = active_fake_mode()
        self._stack.enter_context(_watching())
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        self._stack.close()
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._dtensor is not None and any(
                issubclass(t, self._dtensor) for t in types):
            # let DTensor run first: it comes back with its local ops
            return NotImplemented
        out = func(*args, **kwargs)
        ins, outs = tree_leaves((args, kwargs)), tree_leaves(out)
        if _propagating() or _foreign(ins + outs, self._fake_mode):
            return out
        ns = func.namespace
        name = func._schema.name.split("::")[-1]
        if ns == "_c10d_functional":
            kind = _C10D_KIND.get(name)
            if kind:
                self.coll[kind] += sum(_nbytes(t) for t in outs)
            return out
        packet = func.overloadpacket
        if packet in flop_registry:
            f = int(flop_registry[packet](*args, **kwargs, out_val=out))
            self.flops += f
            key = f"{ns}.{name}"
            self.by_op[key] = self.by_op.get(key, 0) + f
        out_bytes = sum(_nbytes(t) for t in outs)
        # an op that returns no tensor (prim.device, sym sizes) reads
        # metadata only
        if out_bytes and not func.is_view and name not in _ALLOCATIONS:
            self.hbm_bytes += sum(_nbytes(t) for t in ins) + out_bytes
        return out


def peak_memory():
    """A ``torch.distributed._tools.MemTracker`` that skips DTensor's
    propagation runs; ``peak_bytes(tracker)`` reads its peak."""
    from torch.distributed._tools.mem_tracker import MemTracker

    class PeakMemory(MemTracker):
        def __enter__(self):
            self._watching = _watching()
            self._watching.__enter__()
            return super().__enter__()

        def __exit__(self, *exc):
            super().__exit__(*exc)
            self._watching.__exit__(*exc)

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if _propagating():
                return func(*args, **(kwargs or {}))
            return super().__torch_dispatch__(func, types, args, kwargs)

    return PeakMemory()


def peak_bytes(tracker) -> int:
    """The peak of the bytes ``tracker`` saw live on one device."""
    snap = tracker.get_tracker_snapshot("peak")
    return int(max((v["Total"] for v in snap.values()), default=0))


@dataclasses.dataclass
class Roofline:
    flops: float
    hbm_bytes: float
    coll_bytes: float
    coll_breakdown: dict
    chips: int
    model_flops: float = 0.0

    @property
    def t_compute(self) -> float:
        # counted on this rank's shards: already per chip
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        # model_flops is whole-program; counted flops are per chip
        total = self.flops * self.chips
        return self.model_flops / total if total else 0.0

    def row(self) -> dict:
        return {
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "hlo_gflops_per_chip": self.flops / 1e9,
            "hbm_gbytes_per_chip": self.hbm_bytes / 1e9,
            "coll_mbytes_per_chip": self.coll_bytes / 1e6,
            "coll_breakdown": {k: v for k, v in
                               self.coll_breakdown.items() if v},
            "useful_flops_ratio": self.useful_flops_ratio,
        }


def from_counts(mode: CostMode, chips: int,
                model_flops: float = 0.0) -> Roofline:
    """The roofline of what ``mode`` counted."""
    return Roofline(flops=float(mode.flops), hbm_bytes=float(mode.hbm_bytes),
                    coll_bytes=float(sum(mode.coll.values())),
                    coll_breakdown={k: int(v) for k, v in mode.coll.items()},
                    chips=chips, model_flops=model_flops)


def analyze(fn, chips: int, model_flops: float = 0.0, *args,
            **kwargs) -> tuple[Roofline, object]:
    """Run ``fn(*args, **kwargs)`` under ``CostMode``; returns (its
    roofline on ``chips`` chips, fn's result). The reference's
    ``analyze(compiled, chips, model_flops)`` reads a compiled program;
    here the program is the call itself."""
    with CostMode() as mode:
        out = fn(*args, **kwargs)
    return from_counts(mode, chips, model_flops), out
