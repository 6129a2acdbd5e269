"""The engine step reads nothing from the device on the host, so a card can
capture it as a CUDA graph: a step of each engine cell's configuration
(the §3.3 plasma over 4 domains × async(4), field off and field on), at a
tiny size on the CPU, under a dispatch mode that fails on every aten call
that hands a device value to the host, or lifts a host value into a
tensor. And ``particles.put_rows_``, which takes its fill row by
``index_select``, makes the writes its earlier form (a 0-d tensor index,
read on the host) made."""

import dataclasses

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import pic_bit1
from repro_torch.core import particles
from repro_torch.distributed import engine

HOST_READS = {"aten::_local_scalar_dense", "aten::item", "aten::nonzero"}
# a host value lifted into a tensor: on a card, a copy from the host
HOST_WRITES = {"aten::lift_fresh"}


class _NoHostRead(TorchDispatchMode):
    def __init__(self, refused=HOST_READS):
        super().__init__()
        self.refused = refused

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func._schema.name in self.refused:
            raise AssertionError(f"host traffic in the step: {func}")
        return func(*args, **(kwargs or {}))


def _engine(field: bool):
    """The engine cells' configuration at 256 cells and 5,120 particles a
    species (8,192 slots), ionization raised so that every step ionizes."""
    cfg = dataclasses.replace(pic_bit1.make_field_config(256, 5120),
                              ionization_rate=0.05)
    if not field:
        cfg = dataclasses.replace(cfg, field_solve=False, eps0=1.0)
    ecfg = engine.EngineConfig(pic=cfg, domains=4, async_n=4,
                               max_migration=64, max_births=256)
    state = (pic_bit1.field_engine_state(ecfg, 3, device="cpu") if field
             else engine.init_engine_state(ecfg, 3, device="cpu"))
    return ecfg, state


@pytest.mark.parametrize("field", [False, True], ids=["field_off",
                                                     "field_on"])
def test_engine_step_reads_nothing_on_the_host(field):
    """Three steps (the second and third land the pending rows and births
    of the one before) under the mode; the births and arrivals are real."""
    ecfg, state = _engine(field)
    step = engine.make_engine_step(ecfg)
    born = 0
    with _NoHostRead():
        for _ in range(3):
            state, diag = step(state)
            born = born + diag["n_ionized"]
    assert int(born) > 0
    assert int(sum(p.alive.sum() for p in state.pending)) > 0


@pytest.mark.parametrize("field", [False, True], ids=["field_off",
                                                     "field_on"])
def test_engine_step_copies_nothing_from_the_host(field):
    """After the first step (which puts the config's constants on the
    device once), no step lifts a host value into a tensor: on a card
    that is a copy from the host, which a graph's capture refuses."""
    ecfg, state = _engine(field)
    step = engine.make_engine_step(ecfg)
    state, _ = step(state)
    with _NoHostRead(HOST_READS | HOST_WRITES):
        for _ in range(2):
            state, _ = step(state)


def _put_rows_before(dst, idx, val, ok):
    """``put_rows_`` as it was: the fill row taken by a 0-d tensor index."""
    idx, ok = idx.reshape(-1), ok.reshape(-1)
    val = val.reshape((-1,) + tuple(dst.shape[1:])).to(dst.dtype)
    anyv = ok.any()
    first = torch.argmax(ok.to(torch.int32))
    fill_i = torch.where(anyv, idx[first], 0)
    fill_v = torch.where(anyv, val[first], dst[0])
    okb = ok.reshape((-1,) + (1,) * (dst.dim() - 1))
    dst.index_put_((torch.where(ok, idx, fill_i),),
                   torch.where(okb, val, fill_v))


@pytest.mark.parametrize("width", [None, 3], ids=["1d", "n3"])
@pytest.mark.parametrize("case", ["mixed", "all_ok", "first_not_ok",
                                  "none_ok"])
def test_put_rows_makes_the_writes_it_made(case, width):
    """Rows that are ``ok`` land at their index; a row that is not
    rewrites the first ``ok`` row (or, with none, dst[0] onto itself):
    the same target as the 0-d-index form, on 1-D and (N, 3) targets."""
    gen = torch.Generator().manual_seed(len(case) + (width or 0))
    n, m = 64, 16
    shape = (n,) if width is None else (n, width)
    dst = torch.randn(shape, generator=gen)
    idx = torch.randperm(n, generator=gen)[:m]
    val = torch.randn((m,) + shape[1:], generator=gen)
    ok = {"mixed": torch.rand(m, generator=gen) < 0.5,
          "all_ok": torch.ones(m, dtype=torch.bool),
          "first_not_ok": torch.arange(m) > 4,
          "none_ok": torch.zeros(m, dtype=torch.bool)}[case]
    want = dst.clone()
    _put_rows_before(want, idx, val, ok)
    got = dst.clone()
    with _NoHostRead():
        particles.put_rows_(got, idx, val, ok)
    assert torch.equal(got, want)
    if case == "none_ok":
        assert torch.equal(got, dst)
    else:
        assert torch.equal(got[idx[ok]], val[ok])
