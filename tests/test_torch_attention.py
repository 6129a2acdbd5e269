"""The port's training attention (``repro_torch.models.attention``):
``chunked_attention`` against the reference's, forward and gradient, and
the differentiable ``attention`` (the flash kernel's forward, here its
plain version on CPU tensors, with ``chunked_attention``'s gradient).

Bands: f32, 2e-6 of max |ref| for the forward and each gradient against
the reference (the same blocks and online softmax; sums in another
order); 0.02 in bf16 against the reference run op by op
(``tests/_torch_lm.py``); 1e-5 against a naive masked softmax attention
in float64 (f32 rounding over a handful of keys). The differentiable
attention's gradients equal ``chunked_attention``'s bit for bit: they are
its gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm import rel
from _torch_parity import n, t
from repro.models import attention as ref_attn
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import attention as attn

F32_BAND = 2e-6


def _qkv(b, sq, skv, h, kvh, hd, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, sq, h, hd)).astype(np.float32),
            rng.normal(size=(b, skv, kvh, hd)).astype(np.float32),
            rng.normal(size=(b, skv, kvh, hd)).astype(np.float32),
            rng.normal(size=(b, sq, h, hd)).astype(np.float32))


# (sq, skv, h, kvh, hd, causal, window, q_offset, q_chunk, kv_chunk)
CASES = [
    (37, 37, 4, 2, 16, True, 0, 0, 8, 16),         # ragged, GQA 2
    (37, 37, 6, 1, 16, True, 5, 0, 8, 16),         # window, MQA
    (24, 24, 4, 4, 32, False, 0, 0, 16, 8),        # non-causal, MHA
    (9, 40, 8, 2, 16, False, 0, 0, 4, 16),         # cross: sq < skv
    (10, 41, 4, 2, 16, True, 0, 31, 4, 16),        # q_offset (tail query)
    (33, 33, 7, 1, 16, True, 9, 0, 512, 1024),     # default chunks, group 7
]


def _ids(c):
    return (f"sq{c[0]}-skv{c[1]}-h{c[2]}/{c[3]}-d{c[4]}-"
            f"{'c' if c[5] else 'nc'}-w{c[6]}-off{c[7]}-ch{c[8]}/{c[9]}")


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_chunked_attention_matches_reference(case):
    """Forward, and the gradient of <out, cotangent> w.r.t. q, k, v."""
    sq, skv, h, kvh, hd, causal, window, off, qc, kc = case
    q, k, v, ct = _qkv(2, sq, skv, h, kvh, hd)
    kw = dict(causal=causal, window=window, q_offset=off, q_chunk=qc,
              kv_chunk=kc)

    def ref_loss(q, k, v):
        return jnp.sum(ref_attn.chunked_attention(q, k, v, **kw) * ct)

    want = ref_attn.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), **kw)
    rg = jax.grad(ref_loss, argnums=(0, 1, 2))(jnp.asarray(q),
                                                jnp.asarray(k),
                                                jnp.asarray(v))
    tq, tk, tv = (t(a).requires_grad_(True) for a in (q, k, v))
    got = attn.chunked_attention(tq, tk, tv, **kw)
    assert rel(n(got), want) <= F32_BAND
    pg = torch.autograd.grad(got, (tq, tk, tv), t(ct))
    for name, g, r in zip("qkv", pg, rg):
        assert rel(n(g), r) <= F32_BAND, name


@pytest.mark.parametrize("p_bf16", [False, True])
def test_chunked_attention_bf16_matches_reference(p_bf16):
    sq, h, kvh, hd = 37, 4, 2, 32
    q, k, v, ct = _qkv(1, sq, sq, h, kvh, hd, seed=1)
    kw = dict(causal=True, window=0, q_chunk=16, kv_chunk=8, p_bf16=p_bf16)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    with jax.disable_jit():
        want = ref_attn.chunked_attention(jq, jk, jv, **kw)
        rg = jax.grad(lambda a, b, c: jnp.sum(
            ref_attn.chunked_attention(a, b, c, **kw).astype(jnp.float32)
            * ct), argnums=(0, 1, 2))(jq, jk, jv)
    tq, tk, tv = (t(a).bfloat16().requires_grad_(True) for a in (q, k, v))
    got = attn.chunked_attention(tq, tk, tv, **kw)
    assert got.dtype == torch.bfloat16
    assert rel(n(got.float()), np.asarray(want, np.float32)) <= 0.02
    pg = torch.autograd.grad(got.float(), (tq, tk, tv), t(ct))
    for name, g, r in zip("qkv", pg, rg):
        assert g.dtype == torch.bfloat16
        assert rel(n(g.float()), np.asarray(r, np.float32)) <= 0.02, name


@pytest.mark.parametrize("causal,window,h,kvh", [(True, 0, 4, 2),
                                                 (True, 6, 3, 1),
                                                 (False, 0, 2, 2)])
def test_attention_gradient_is_chunked_attentions(causal, window, h, kvh):
    """The differentiable attention's forward is the flash kernel's (its
    plain version here), and its gradients are exactly
    ``chunked_attention``'s at the reference's chunk sizes."""
    q, k, v, ct = _qkv(2, 23, 23, h, kvh, 16, seed=2)
    a = [t(x).requires_grad_(True) for x in (q, k, v)]
    b = [t(x).requires_grad_(True) for x in (q, k, v)]
    out = attn.attention(*a, causal=causal, window=window)
    assert torch.equal(out.detach(), fa.flash_attention_plain(
        *(x.detach() for x in a), causal=causal, window=window))
    ga = torch.autograd.grad(out, a, t(ct))
    gb = torch.autograd.grad(attn.chunked_attention(
        *b, causal=causal, window=window), b, t(ct))
    for x, y in zip(ga, gb):
        assert torch.equal(x, y)


def test_attention_gradient_only_for_inputs_that_need_it():
    """Cross-attention style: k, v need a gradient, q does not."""
    q, k, v, ct = _qkv(1, 5, 12, 2, 1, 16, seed=3)
    tq = t(q)
    tk, tv = t(k).requires_grad_(True), t(v).requires_grad_(True)
    out = attn.attention(tq, tk, tv, causal=False)
    gk, gv = torch.autograd.grad(out, (tk, tv), t(ct))
    wk, wv = torch.autograd.grad(attn.chunked_attention(
        tq, tk, tv, causal=False), (tk, tv), t(ct))
    assert torch.equal(gk, wk) and torch.equal(gv, wv)


def test_attention_runs_the_kernel_once_forward_and_never_backward(
        monkeypatch):
    """One kernel call (here the plain version, counted) in the forward;
    the backward recomputes ``chunked_attention`` and calls no kernel."""
    calls = []
    plain = fa.flash_attention_plain

    def counting(*a, **kw):
        calls.append(1)
        return plain(*a, **kw)

    monkeypatch.setattr(fa, "flash_attention_plain", counting)
    q, k, v, ct = _qkv(1, 16, 16, 2, 1, 16, seed=4)
    xs = [t(x).requires_grad_(True) for x in (q, k, v)]
    out = attn.attention(*xs)
    assert len(calls) == 1
    torch.autograd.grad(out, xs, t(ct))
    assert len(calls) == 1
    with torch.no_grad():
        attn.attention(*xs)
    assert len(calls) == 2


def _naive(q, k, v, causal, window):
    """Masked softmax attention by repeating K/V, in the inputs' dtype."""
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    kr = k.repeat_interleave(h // kvh, dim=2)
    vr = v.repeat_interleave(h // kvh, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, kr) * hd ** -0.5
    qpos = torch.arange(sq)[:, None]
    kpos = torch.arange(skv)[None, :]
    mask = torch.ones(sq, skv, dtype=torch.bool)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    s = s.masked_fill(~mask, float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), vr)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 3), (False, 0)])
def test_attention_gradient_against_float64(causal, window):
    q, k, v, ct = _qkv(1, 7, 7, 4, 2, 16, seed=5)
    xs = [t(x).requires_grad_(True) for x in (q, k, v)]
    ds = [t(x).double().requires_grad_(True) for x in (q, k, v)]
    out = attn.attention(*xs, causal=causal, window=window)
    want = _naive(*ds, causal, window)
    assert rel(n(out), n(want)) <= 1e-5
    got = torch.autograd.grad(out, xs, t(ct))
    ref = torch.autograd.grad(want, ds, t(ct).double())
    for name, g, r in zip("qkv", got, ref):
        assert rel(n(g), n(r)) <= 1e-5, name
