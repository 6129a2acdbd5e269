"""The port's MoE (``repro_torch.models.moe``) against the reference's
``repro.models.moe``: the router's choice of experts and the capacity
keep-mask exactly equal (ties on the top-k boundary included), the output
and the aux loss within the f32 band, and the reference's MoE tests
mirrored on the port.

The reference's keep-mask is read from the call it makes to
``jax.nn.one_hot(where(keep, pos, capacity), capacity)`` (a dropped route
takes the slot ``capacity``), the chosen experts from its ``route_topk``;
the reference runs op by op here (no jit), so both are concrete arrays.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.models.moe as ref_moe
from _torch_lm import BAND, f32, pair, ref_mode, rel, tokens
from _torch_parity import n, t
from repro.models.common import ModelConfig as RefConfig
from repro_torch.models import moe
from repro_torch.models.common import ModelConfig

SETTINGS = dict(max_examples=15, deadline=None)


def _ref_routes(monkeypatch, *args, **kw):
    """The reference's moe_ffn(*args, **kw) with its routes recorded:
    (out, aux, idx (g, s, k), slot (g, s, k)), slot = pos where kept and
    capacity where dropped (the argument of its last one_hot call)."""
    rec = {"one_hot": []}
    route, one_hot = ref_moe.route_topk, jax.nn.one_hot

    def route_rec(logits, k):
        w, idx = route(logits, k)
        rec["idx"] = np.asarray(idx)
        return w, idx

    def one_hot_rec(x, num_classes, **okw):
        rec["one_hot"].append(np.asarray(x))
        return one_hot(x, num_classes, **okw)

    monkeypatch.setattr(ref_moe, "route_topk", route_rec)
    monkeypatch.setattr(jax.nn, "one_hot", one_hot_rec)
    out, aux = ref_moe.moe_ffn(*(jnp.asarray(a) for a in args), **kw)
    monkeypatch.undo()
    return np.asarray(out), float(aux), rec["idx"], rec["one_hot"][-1]


def _port_routes(monkeypatch, *args, **kw):
    """The port's moe_ffn with its routes recorded, as ``_ref_routes``."""
    rec = {}
    route, plan = moe.route_topk, moe.dispatch_plan

    def route_rec(logits, k):
        w, idx = route(logits, k)
        rec["idx"] = n(idx)
        return w, idx

    def plan_rec(idx, e, cap):
        pos, keep = plan(idx, e, cap)
        rec["slot"] = n(torch.where(keep, pos, cap))
        return pos, keep

    monkeypatch.setattr(moe, "route_topk", route_rec)
    monkeypatch.setattr(moe, "dispatch_plan", plan_rec)
    out, aux = moe.moe_ffn(*(t(a) for a in args), **kw)
    monkeypatch.undo()
    return n(out), float(aux), rec["idx"], rec["slot"]


def _weights(rng, d, f, e, router=None):
    wr = router if router is not None else \
        (rng.normal(size=(d, e)) * 0.3).astype(np.float32)
    wg, wu = ((rng.normal(size=(e, d, f)) / np.sqrt(d)).astype(np.float32)
              for _ in range(2))
    wd = (rng.normal(size=(e, f, d)) / np.sqrt(f)).astype(np.float32)
    return wr, wg, wu, wd


# ----------------------------------------------------------------- routing
def test_route_topk_breaks_ties_lower_index_first():
    """``[1, 3, 3, 2, 3, 0.5]`` three times: lax.top_k takes experts 1 and
    2 of each row; torch.topk need not."""
    logits = np.tile(np.array([1, 3, 3, 2, 3, 0.5], np.float32), 3)[None]
    w, idx = moe.route_topk(t(logits), 2)
    rw, ridx = ref_moe.route_topk(jnp.asarray(logits), 2)
    np.testing.assert_array_equal(n(idx), np.asarray(ridx))
    assert n(idx).tolist() == [[1, 2]]
    np.testing.assert_array_equal(n(w), np.asarray(rw))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("e", [4, 16, 128])
def test_route_topk_matches_reference(e, k, dtype):
    """Random rows and rows of coarse integer logits (ties everywhere):
    the chosen experts equal, the weights within one rounding."""
    rng = np.random.default_rng(e * 10 + k)
    logits = np.concatenate([rng.normal(size=(256, e)),
                             rng.integers(-2, 3, size=(256, e))]
                            ).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else \
        (jnp.bfloat16, torch.bfloat16)
    rw, ridx = ref_moe.route_topk(jnp.asarray(logits).astype(jdt), k)
    w, idx = moe.route_topk(t(logits).to(tdt), k)
    np.testing.assert_array_equal(n(idx), np.asarray(ridx))
    assert w.dtype == tdt
    np.testing.assert_allclose(f32(w), f32(rw), rtol=1e-6 if dtype == "f32"
                               else 2 ** -8, atol=0)


# -------------------------------------------------------------------- layer
@pytest.mark.parametrize("cf,group", [(1.25, 0), (0.25, 0), (1.25, 8),
                                      (100.0, 0)])
@pytest.mark.parametrize("k", [1, 2, 4])
def test_moe_ffn_matches_reference(monkeypatch, k, cf, group):
    """x and the router of small integers, so every logit is exact in f32
    and ties are common, and the router has duplicate columns, so ties fall
    on the top-k boundary: the experts and keep-masks exactly equal, the
    output and aux within the f32 band. cf 0.25 forces drops; group 8
    regroups the 32-token rows into 8-token groups."""
    g, s, d, f, e = 2, 32, 16, 24, 8
    rng = np.random.default_rng(k * 100 + int(cf * 4) + group)
    x = rng.integers(-3, 4, size=(g, s, d)).astype(np.float32)
    router = rng.integers(-2, 3, size=(d, e)).astype(np.float32)
    router[:, 5] = router[:, 2]           # equal logits for experts 2 and 5
    router[:, 7] = router[:, 0]
    args = (x, *_weights(rng, d, f, e, router))
    kw = dict(top_k=k, capacity_factor=cf, act="swiglu")
    grouped = dict(arch="x", kind="moe", n_layers=1, d_model=d, n_heads=1,
                   d_ff=f, vocab=1, moe_group=group)
    ref_cfg, cfg = ((RefConfig(**grouped), ModelConfig(**grouped)) if group
                    else (None, None))
    rout, raux, ridx, rslot = _ref_routes(monkeypatch, *args, cfg=ref_cfg,
                                          **kw)
    pout, paux, pidx, pslot = _port_routes(monkeypatch, *args, cfg=cfg,
                                           **kw)
    np.testing.assert_array_equal(pidx, ridx)
    np.testing.assert_array_equal(pslot, rslot)
    cap = moe.capacity(group or s, k, e, cf)
    dropped = int((pslot == cap).sum())
    if cf == 0.25:
        assert dropped > 0
    if cf == 100.0:
        assert dropped == 0
    assert rel(pout, rout) < BAND["f32"]
    assert abs(paux - raux) <= 1e-6 * raux


@pytest.mark.parametrize("s,k,e,cf,want", [
    (4096, 4, 16, 1.25, 1280),     # dbrx's prefill rows
    (4096, 1, 128, 1.25, 40),      # llama4's
    (1, 4, 16, 1.25, 1),           # a decode step: at least one slot
    (8, 4, 2, 1.25, 8),            # never more than the group's tokens
    (10, 1, 3, 0.3, 1),            # 0.3 * 10 / 3 = 1.0000000000000002
    (32, 2, 8, 0.25, 2),
])
def test_capacity_is_the_references(s, k, e, cf, want):
    """C = min(s, max(1, int(cf * s * k / E))), in Python float as the
    reference computes it."""
    assert moe.capacity(s, k, e, cf) == want


@pytest.mark.parametrize("arch", ["dbrx-132b", "llama4-maverick-400b-a17b"])
def test_forward_aux_sums_the_layers_like_the_reference(arch):
    rm, rp, pm, pp = pair(arch, "f32")
    tok = tokens(pm.cfg, 2, 24)
    _, raux = rm.forward(rp, jnp.asarray(tok))
    _, paux = pm.forward(pp, t(tok))
    assert paux.dtype == torch.float32 and float(paux) > 0
    assert abs(float(paux) - float(raux)) <= 1e-5 * float(raux)


def test_reference_routes_differ_between_its_jit_and_op_by_op_runs():
    """Why the bf16 tests run the reference op by op: on llama4's smoke
    config (top-1 of 8), four 32-token prompts, the reference's jitted
    forward rounds bf16 otherwise than its op-by-op run and routes some
    tokens to other experts, leaving the bf16 band on at least one
    prompt; the port stays within the band of the op-by-op run on all."""
    rm, rp, pm, pp = pair("llama4-maverick-400b-a17b", "bf16")
    fused_gap = []
    for seed in (1, 2, 3, 4):
        tok = tokens(pm.cfg, 2, 32, seed=seed)
        fused, _ = jax.jit(rm.forward)(rp, jnp.asarray(tok))
        with ref_mode("bf16"):
            eager, _ = rm.forward(rp, jnp.asarray(tok))
        ph, _ = pm.forward(pp, t(tok))
        assert rel(f32(ph), f32(eager)) < BAND["bf16"], seed
        fused_gap.append(rel(f32(fused), f32(eager)))
    assert max(fused_gap) > BAND["bf16"], fused_gap


# ------------------------------------------------------------------ mirrors
def test_moe_capacity_drops_are_counted_not_crashed():
    """The port of ``tests/test_models.py::test_moe_capacity_drops_are_
    counted_not_crashed``: llama4's smoke config at capacity_factor 0.25,
    finite, and equal to the reference's forward in f32."""
    rm, rp, pm, pp = pair("llama4-maverick-400b-a17b", "f32",
                          capacity_factor=0.25)
    tok = tokens(pm.cfg, 2, 64)
    h, aux = pm.forward(pp, t(tok))
    assert bool(torch.isfinite(h).all()) and float(aux) > 0
    rh, _ = jax.jit(rm.forward)(rp, jnp.asarray(tok), None)
    assert rel(f32(h), f32(rh)) < BAND["f32"]


@settings(**SETTINGS)
@given(seed=st.integers(0, 2 ** 16), e=st.integers(2, 16),
       k=st.integers(1, 4))
def test_router_weights_are_normalized(seed, e, k):
    """``tests/test_moe_properties.py``'s first property, on the port."""
    k = min(k, e)
    logits = np.random.default_rng(seed).normal(size=(32, e)).astype(
        np.float32)
    w, idx = moe.route_topk(t(logits), k)
    np.testing.assert_allclose(n(w.sum(-1)), 1.0, rtol=1e-3)
    assert (n(idx) < e).all()
    order = np.argsort(-logits, axis=-1, kind="stable")[:, :k]
    assert set(map(tuple, np.sort(order, -1))) == set(
        map(tuple, np.sort(n(idx), -1)))


def _property_inputs(seed, g, s, d, f, e):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(g, s, d)).astype(np.float32)
    return x, *(a * 0.1 for a in (
        rng.normal(size=(d, e)).astype(np.float32),
        rng.normal(size=(e, d, f)).astype(np.float32),
        rng.normal(size=(e, d, f)).astype(np.float32),
        rng.normal(size=(e, f, d)).astype(np.float32)))


@settings(**SETTINGS)
@given(seed=st.integers(0, 2 ** 16))
def test_moe_with_huge_capacity_routes_every_token(seed):
    """``tests/test_moe_properties.py``'s second property, on the port: at
    cf 100 the output is the per-token mixture of its top-k experts."""
    g, s, d, f, e, k = 2, 8, 16, 32, 4, 2
    x, wr, wg, wu, wd = (t(a) for a in _property_inputs(seed, g, s, d, f, e))
    out, aux = moe.moe_ffn(x, wr, wg, wu, wd, top_k=k, capacity_factor=100.0,
                           act="swiglu")
    w, idx = moe.route_topk(torch.matmul(x, wr), k)
    ref = torch.zeros_like(x)
    for ei in range(e):
        gate = torch.nn.functional.silu(torch.matmul(x, wg[ei]))
        y = torch.matmul(gate * torch.matmul(x, wu[ei]), wd[ei])
        coef = (w * (idx == ei)).sum(-1)
        ref = ref + coef[..., None] * y
    np.testing.assert_allclose(n(out), n(ref), rtol=2e-2, atol=2e-3)
    assert float(aux) > 0


@settings(**SETTINGS)
@given(seed=st.integers(0, 2 ** 16), cf=st.floats(0.1, 2.0))
def test_moe_capacity_drop_is_bounded_identity_leak(seed, cf):
    """``tests/test_moe_properties.py``'s third property, on the port: the
    output with drops never exceeds the no-drop output's norm."""
    g, s, d, f, e = 1, 16, 8, 16, 4
    args = [t(a) for a in _property_inputs(seed, g, s, d, f, e)]
    out_drop, _ = moe.moe_ffn(*args, top_k=1, capacity_factor=cf,
                              act="swiglu")
    out_full, _ = moe.moe_ffn(*args, top_k=1, capacity_factor=100.0,
                              act="swiglu")
    assert float(torch.linalg.norm(out_drop)) <= float(
        torch.linalg.norm(out_full)) * 1.01 + 1e-6
