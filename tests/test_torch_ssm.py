"""The port's recurrent layers against the reference's: the Mamba-2 SSD
(``models.mamba2``: the chunked scan with and without a carried state, the
decode step, the causal conv) and the RG-LRU (``models.rglru``: the scan
with and without h0, the step, the conv), and mamba2's SSM block, prefill
and decode; the reference's scan tests mirrored on the port.

Bands: the SSD and the RG-LRU scan run in f32 on both sides. The port's
RG-LRU scan is a Hillis-Steele doubling where the reference calls
``lax.associative_scan``: another tree of the same combine, so the two
round differently; at 4,096 steps they stay within 1e-6 of max |y|, and
the scans are held to SCAN_BAND = 1e-5.
The convs compute the same products and sums in the same order, and are
held equal bit for bit in f32 and bf16. The SSM block in bf16 is held to
the bf16 band against the reference run op by op (``_torch_lm``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm import BAND, DTYPES, f32, pair, ref_mode, rel
from _torch_parity import n, t
from repro.models import lm as ref_lm
from repro.models import mamba2 as ref_mamba2
from repro.models import rglru as ref_rglru
from repro_torch.models import lm, mamba2, rglru

SCAN_BAND = 1e-5


def _ssd_inputs(seed, b=2, s=32, h=3, p=8, nst=16, dt_scale=1.0,
                a_scale=0.3):
    rng = np.random.default_rng(seed)
    xh = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(b, s, h)))).astype(
        np.float32) * dt_scale
    a_log = (rng.normal(size=(h,)) * a_scale).astype(np.float32)
    bm = rng.normal(size=(b, s, nst)).astype(np.float32)
    cm = rng.normal(size=(b, s, nst)).astype(np.float32)
    return xh, dt, a_log, bm, cm


# ---------------------------------------------------------------------- SSD
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("chunk", [8, 16])
def test_ssd_chunked_matches_reference(chunk, with_h0):
    args = _ssd_inputs(0)
    h0 = np.random.default_rng(1).normal(size=(2, 3, 16, 8)).astype(
        np.float32) if with_h0 else None
    ry, rh = ref_mamba2.ssd_chunked(*(jnp.asarray(a) for a in args), chunk,
                                    None if h0 is None else jnp.asarray(h0))
    py, ph = mamba2.ssd_chunked(*(t(a) for a in args), chunk,
                                None if h0 is None else t(h0))
    assert py.dtype == ph.dtype == torch.float32
    assert rel(n(py), np.asarray(ry)) < SCAN_BAND
    assert rel(n(ph), np.asarray(rh)) < SCAN_BAND


def test_ssd_chunked_large_decays_form_no_inf():
    """Steps so large that exp(cum_i - cum_j) above a chunk's diagonal
    overflows f32: the port masks before the exp, the reference selects
    after it; both outputs finite and equal within the band."""
    args = _ssd_inputs(2, dt_scale=40.0, a_scale=1.0)
    li = np.cumsum(args[1][0, :16, 0] * -np.exp(args[2][0]))
    assert np.exp(np.float64(li[0] - li[-1])) > np.finfo(np.float32).max
    ry, rh = ref_mamba2.ssd_chunked(*(jnp.asarray(a) for a in args), 16)
    py, ph = mamba2.ssd_chunked(*(t(a) for a in args), 16)
    assert bool(torch.isfinite(py).all()) and bool(torch.isfinite(ph).all())
    assert rel(n(py), np.asarray(ry)) < SCAN_BAND
    assert rel(n(ph), np.asarray(rh)) < SCAN_BAND


def test_ssd_chunked_refuses_a_ragged_length():
    with pytest.raises(ValueError, match="no multiple of the SSD chunk 8"):
        mamba2.ssd_chunked(*(t(a) for a in _ssd_inputs(0, s=20)), 8)


def test_ssd_decode_step_matches_reference():
    xh, dt, a_log, bm, cm = _ssd_inputs(3, s=1)
    st = np.random.default_rng(4).normal(size=(2, 3, 16, 8)).astype(
        np.float32)
    ry, rs = ref_mamba2.ssd_decode_step(*(jnp.asarray(a) for a in (
        xh, dt, a_log, bm, cm, st)))
    py, ps = mamba2.ssd_decode_step(*(t(a) for a in (xh, dt, a_log, bm, cm,
                                                     st)))
    assert py.shape == (2, 1, 3, 8)
    assert rel(n(py), np.asarray(ry)) < 1e-6
    assert rel(n(ps), np.asarray(rs)) < 1e-6


def test_ssd_chunked_matches_naive_recurrence():
    """The port of ``tests/test_models.py::test_ssd_chunked_matches_naive_
    recurrence``: the chunked scan against a per-step loop."""
    b, s, h, p, nst = 2, 32, 3, 8, 16
    xh, dt, a_log, bm, cm = (t(a) for a in _ssd_inputs(4))
    y, hf = mamba2.ssd_chunked(xh, dt, a_log, bm, cm, 8)
    a = -torch.exp(a_log)
    state = torch.zeros((b, h, nst, p))
    ys = []
    for i in range(s):
        dec = torch.exp(dt[:, i] * a)
        xbar = xh[:, i] * dt[:, i][..., None]
        state = state * dec[..., None, None] + torch.einsum(
            "bn,bhp->bhnp", bm[:, i], xbar)
        ys.append(torch.einsum("bn,bhnp->bhp", cm[:, i], state))
    np.testing.assert_allclose(n(y), n(torch.stack(ys, 1)), rtol=1e-3,
                               atol=1e-3)
    np.testing.assert_allclose(n(hf), n(state), rtol=1e-3, atol=1e-3)


# -------------------------------------------------------------------- convs
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_depthwise_conv_matches_reference_bitwise(dt):
    jdt, tdt = DTYPES[dt]
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 9, 24)).astype(np.float32)
    w = rng.normal(size=(mamba2.CONV_W, 24)).astype(np.float32)
    want = ref_mamba2._depthwise_conv(jnp.asarray(x).astype(jdt),
                                      jnp.asarray(w).astype(jdt))
    got = mamba2._depthwise_conv(t(x).to(tdt), t(w).to(tdt))
    np.testing.assert_array_equal(f32(got), f32(want))


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_causal_conv_matches_reference_bitwise(dt, with_state):
    jdt, tdt = DTYPES[dt]
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 7, 24)).astype(np.float32)
    w = rng.normal(size=(rglru.CONV_W, 24)).astype(np.float32)
    st = rng.normal(size=(2, rglru.CONV_W - 1, 24)).astype(np.float32) \
        if with_state else None
    ry, rs = ref_rglru.causal_conv(
        jnp.asarray(x).astype(jdt), jnp.asarray(w).astype(jdt),
        None if st is None else jnp.asarray(st).astype(jdt))
    py, ps = rglru.causal_conv(t(x).to(tdt), t(w).to(tdt),
                               None if st is None else t(st).to(tdt))
    np.testing.assert_array_equal(f32(py), f32(ry))
    np.testing.assert_array_equal(f32(ps), f32(rs))
    assert py.dtype == ps.dtype == tdt


# ------------------------------------------------------------------- RG-LRU
def _lru_inputs(seed, b=2, s=24, d=16):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=sh).astype(np.float32)
            for sh in ((b, s, d), (b, s, d), (b, s, d), (d,), (b, d))]


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("s", [24, 4096])
def test_rg_lru_matches_reference(s, with_h0):
    x, gx, ga, lam, h0 = _lru_inputs(7, s=s)
    h0 = h0 if with_h0 else None
    ry, rh = ref_rglru.rg_lru(*(jnp.asarray(a) for a in (x, gx, ga, lam)),
                              None if h0 is None else jnp.asarray(h0))
    py, ph = rglru.rg_lru(*(t(a) for a in (x, gx, ga, lam)),
                          None if h0 is None else t(h0))
    assert py.dtype == torch.float32 and ph.dtype == torch.float32
    assert rel(n(py), np.asarray(ry)) < 1e-6
    assert rel(n(ph), np.asarray(rh)) < 1e-6


def test_rg_lru_carries_h0_into_every_step():
    """A slow decay (lam far below 0) so h0 reaches the last step: the
    scan from h0 equals the scan of the prefix followed by the rest."""
    x, gx, ga, lam, _ = (t(a) for a in _lru_inputs(8, s=32))
    lam = lam - 6.0
    y, h = rglru.rg_lru(x, gx, ga, lam)
    y1, h1 = rglru.rg_lru(x[:, :11], gx[:, :11], ga[:, :11], lam)
    y2, h2 = rglru.rg_lru(x[:, 11:], gx[:, 11:], ga[:, 11:], lam, h1)
    assert rel(n(torch.cat([y1, y2], 1)), n(y)) < SCAN_BAND
    assert rel(n(h2), n(h)) < SCAN_BAND
    assert float(h1.abs().max()) > 0.1


def test_rg_lru_step_matches_reference():
    x, gx, ga, lam, h = _lru_inputs(9, s=1)
    ry, rh = ref_rglru.rg_lru_step(*(jnp.asarray(a) for a in (x, gx, ga,
                                                              lam, h)))
    py, ph = rglru.rg_lru_step(*(t(a) for a in (x, gx, ga, lam, h)))
    assert py.shape == (2, 1, 16)
    assert rel(n(py), np.asarray(ry)) < 1e-6
    assert rel(n(ph), np.asarray(rh)) < 1e-6


def test_scan_pairs_matches_a_loop_in_float64():
    rng = np.random.default_rng(10)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, size=(3, 37, 5)))
    b = torch.from_numpy(rng.normal(size=(3, 37, 5)))
    pa, pb = rglru.scan_pairs(a, b)
    h, prod = torch.zeros(3, 5, dtype=torch.float64), torch.ones(
        3, 5, dtype=torch.float64)
    for i in range(37):
        h, prod = a[:, i] * h + b[:, i], prod * a[:, i]
        torch.testing.assert_close(pb[:, i], h, rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(pa[:, i], prod, rtol=1e-12, atol=1e-12)


def test_rglru_scan_matches_stepwise():
    """The port of ``tests/test_models.py::test_rglru_scan_matches_
    stepwise``."""
    x, gx, ga, lam, _ = (t(a) for a in _lru_inputs(5))
    y, h_last = rglru.rg_lru(x, gx, ga, lam)
    h = torch.zeros((2, 16))
    ys = []
    for i in range(24):
        yt, h = rglru.rg_lru_step(x[:, i:i + 1], gx[:, i:i + 1],
                                  ga[:, i:i + 1], lam, h)
        ys.append(yt[:, 0])
    np.testing.assert_allclose(n(y), n(torch.stack(ys, 1)), rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose(n(h_last), n(h), rtol=2e-3, atol=2e-3)


# ----------------------------------------------------------- mamba2's block
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_ssm_block_prefill_and_decode_match_reference(dt):
    """mamba2's SSM block (norm, in_proj, conv, SSD, gate, out_proj) on one
    layer of the smoke config: a 32-token prefill, then 4 decode steps
    from zero state, against the reference's."""
    rm, rp, pm, pp = pair("mamba2-2.7b", dt)
    jdt, tdt = DTYPES[dt]
    x = np.random.default_rng(11).normal(size=(2, 32, 64)).astype(np.float32)
    rlp = jax.tree.map(lambda a: a[0], rp["blocks"])
    plp = lm._layer(pp["blocks"], 0)
    with ref_mode(dt):
        want = ref_lm._ssm_apply(rm.cfg, rlp, jnp.asarray(x).astype(jdt))
        rc = rm.init_cache(2, 4)
        rst, rcv = rc["ssm"][0], rc["conv"][0]
        rsteps = []
        for i in range(4):
            y, rst, rcv = ref_lm._ssm_decode(
                rm.cfg, rlp, jnp.asarray(x[:, i:i + 1]).astype(jdt), rst,
                rcv)
            rsteps.append(y)
    got = lm._ssm_apply(pm.cfg, plp, t(x).to(tdt))
    assert got.dtype == tdt
    assert rel(f32(got) - x, f32(want) - x) < BAND[dt]
    pc = pm.init_cache(2, 4, "cpu")
    pst, pcv = pc["ssm"][0], pc["conv"][0]
    for i in range(4):
        y, pst, pcv = lm._ssm_decode(pm.cfg, plp, t(x[:, i:i + 1]).to(tdt),
                                     pst, pcv)
        assert rel(f32(y) - x[:, i:i + 1],
                   f32(rsteps[i]) - x[:, i:i + 1]) < BAND[dt], i
    assert rel(f32(pst), f32(rst)) < BAND[dt]
    assert rel(f32(pcv), f32(rcv)) < BAND[dt]


def _decode_gap(model, params, tok, to_in, pos):
    """max |decode logits - prefill logits| / max |prefill logits|."""
    h, _ = model.forward(params, to_in(tok))
    ref = f32(model.logits(params, h))
    b, s = tok.shape
    cache = model.init_cache(b, s) if pos is None else model.init_cache(
        b, s, "cpu")
    step = jax.jit(model.decode_step) if pos is None else model.decode_step
    outs = []
    for i in range(s):
        lg, cache = step(params, to_in(tok[:, i:i + 1]), cache,
                         jnp.asarray(i, jnp.int32) if pos is None else i)
        outs.append(f32(lg[:, 0]))
    return rel(np.stack(outs, 1), ref)


def test_bf16_decode_drift_with_depth_is_the_references():
    """mamba2 at width 256 and 16 layers, random weights: in bf16 the
    reference's own decode leaves its prefill's 0.02 band (rounding grows
    with depth), and the port's drifts no more than twice as far; in f32
    both stay within 1e-4, so the two paths compute the same function.
    This is why ``chip_smoke.py`` gates mamba2's 64-layer decode against
    its prefill in f32 and reports the bf16 gap."""
    gaps = {}
    for dt in ("bf16", "f32"):
        rm, rp, pm, pp = pair("mamba2-2.7b", dt, n_layers=16, d_model=256,
                              ssm_state=128, ssm_head_dim=64, ssm_chunk=32)
        tok = np.random.default_rng(1).integers(0, 512, (2, 32),
                                                dtype=np.int32)
        gaps[dt] = (_decode_gap(rm, rp, tok, jnp.asarray, None),
                    _decode_gap(pm, pp, tok, t, 0))
    ref_bf16, port_bf16 = gaps["bf16"]
    assert ref_bf16 > 0.02, gaps
    assert port_bf16 < 2 * ref_bf16, gaps
    assert max(gaps["f32"]) < 1e-4, gaps
