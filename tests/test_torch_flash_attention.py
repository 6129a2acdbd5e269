"""The plain version of the port's flash-attention kernel against the
reference's Pallas kernel (``flash_attention_pallas``, interpret mode off-TPU)
and against ``chunked_attention``, the function it replaces in the model.

Bands: 2e-5 in f32 and 3e-2 with bf16 I/O, as ``tests/test_flash_attention.py``
holds the Pallas kernel to its oracle; 2e-4 against ``chunked_attention``, as
``tests/test_models.py`` holds that to its oracle. bf16 inputs take the
tensor-core kernel's arithmetic (scale after the product, exp2, P V by two
bf16 halves of p), f32 inputs the CUDA-core kernel's. The CUDA kernel itself
runs only on the card; ``chip_smoke.py`` holds it against this plain version
there (``tests/test_torch_kernels.py`` checks that its wrapper refuses CPU
tensors).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import n, t
from repro.kernels.flash_attention import flash_attention_pallas
from repro.models.attention import chunked_attention
from repro_torch.kernels import flash_attention as port_flash
from repro_torch.kernels import ops


def _qkv(shape_q, shape_kv, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=s).astype(dtype)
                 for s in (shape_q, shape_kv, shape_kv))


def _bf16(a):
    return jnp.asarray(a).astype(jnp.bfloat16)


@pytest.mark.parametrize("bh,sq,skv,hd", [(2, 256, 256, 64),
                                          (3, 128, 256, 128),
                                          (1, 128, 128, 256)])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_pallas(bh, sq, skv, hd, causal):
    q, k, v = _qkv((bh, sq, hd), (bh, skv, hd), 1)
    want = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=causal,
                                  block_q=128, block_k=128)
    got = ops.flash_attention(t(q), t(k), t(v), causal=causal)
    assert got.shape == (bh, sq, hd) and got.dtype == torch.float32
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("bh,sq,skv,hd", [(2, 256, 256, 64),
                                          (1, 128, 256, 128)])
def test_plain_matches_pallas_bf16_io(bh, sq, skv, hd):
    q, k, v = _qkv((bh, sq, hd), (bh, skv, hd), 3)
    want = flash_attention_pallas(_bf16(q), _bf16(k), _bf16(v), block_q=128,
                                  block_k=128)
    got = ops.flash_attention(*(t(np.asarray(_bf16(a), np.float32))
                                .to(torch.bfloat16) for a in (q, k, v)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(n(got.float()), np.asarray(want, np.float32),
                               rtol=3e-2, atol=3e-2)


def test_plain_matches_pallas_window():
    q, k, v = _qkv((2, 256, 64), (2, 256, 64), 2)
    want = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=True, window=64,
                                  block_q=128, block_k=128)
    got = ops.flash_attention(t(q), t(k), t(v), causal=True, window=64)
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("groups,window,hd,causal", [
    (1, 0, 64, True), (2, 0, 64, True), (7, 0, 64, True),
    (1, 16, 64, True), (2, 16, 64, True), (7, 16, 64, True),
    (2, 0, 16, True), (2, 0, 32, False), (2, 16, 128, True),
    (1, 0, 256, True), (2, 0, 64, False)])
def test_plain_matches_chunked_attention(groups, window, hd, causal):
    """GQA in the model's (B, S, H, D) layout at a ragged length (200, no
    multiple of any tile) against the reference's ``chunked_attention``."""
    b, s, kvh = 2, 200, 2 if groups != 7 else 1
    h = kvh * groups
    q, k, v = _qkv((b, s, h, hd), (b, s, kvh, hd), 4)
    want = chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=causal, window=window, q_chunk=64,
                             kv_chunk=64)
    got = ops.flash_attention(t(q), t(k), t(v), causal=causal, window=window)
    assert got.shape == (b, s, h, hd)
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


def test_plain_matches_chunked_attention_short_queries():
    """Sq < Skv, causal with both positions counted from 0 (q_offset=0)."""
    q, k, v = _qkv((1, 96, 4, 64), (1, 300, 2, 64), 5)
    want = chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=True, q_chunk=64, kv_chunk=128)
    got = ops.flash_attention(t(q), t(k), t(v), causal=True)
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


def test_ops_on_cpu_takes_the_plain_version_and_launches_nothing():
    q, k, v = _qkv((1, 70, 4, 32), (1, 70, 2, 32), 6)
    before = port_flash.flash_attention.launches
    got = ops.flash_attention(t(q), t(k), t(v), causal=True, window=8)
    want = port_flash.flash_attention_plain(t(q), t(k), t(v), causal=True,
                                            window=8)
    assert torch.equal(got, want)
    assert port_flash.flash_attention.launches == before == 0


@pytest.mark.parametrize("bad,match", [
    (((1, 8, 3, 64), (1, 8, 2, 64)), "group"),
    (((1, 8, 2, 48), (1, 8, 2, 48)), "head dim"),
    (((1, 8, 2, 64), (2, 8, 2, 64)), "must be"),
])
def test_plain_refuses_what_the_kernel_does_not_take(bad, match):
    q, k, v = (t(a) for a in _qkv(*bad, 8))
    with pytest.raises(ValueError, match=match):
        ops.flash_attention(q, k, v)


# ------------------------------------------------- the bf16 kernel's arithmetic

def _bf16_qkv(shape_q, shape_kv, seed):
    """bf16 inputs for the port and the same values in f32 for the
    reference."""
    q, k, v = _qkv(shape_q, shape_kv, seed)
    tb = tuple(t(a).to(torch.bfloat16) for a in (q, k, v))
    return tb, tuple(x.float().numpy() for x in tb)


@pytest.mark.parametrize("dtype,d", [(dt, d) for dt in port_flash.DTYPES
                                     for d in port_flash.HEAD_DIMS])
def test_tile_tables_match_the_kernel(dtype, d):
    """BLOCK_K is the key tile of the kernel each dtype launches: block_k()
    of the f32 kernel, MmaTile<D>::BK of the bf16 one."""
    src = (Path(port_flash.__file__).resolve().parent.parent / "csrc"
           / "flash_attention.cu").read_text()
    if dtype == torch.float32:
        lim, lo_d, hi_d = map(int, re.search(
            r"constexpr int block_k\(\) \{ return D <= (\d+) \? (\d+) : "
            r"(\d+); \}", src).groups())
        bk = lo_d if d <= lim else hi_d
    else:
        bk = int(re.search(r"struct MmaTile<%d> \{[^}]*\bBK = (\d+)" % d,
                           src).group(1))
    assert port_flash.BLOCK_K[(dtype, d)] == bk


def test_split_p_reconstructs_p():
    """p_hi + p_lo = p within 2^-16 relative, both halves bf16 values, over
    the exponents a softmax weight takes."""
    rng = np.random.default_rng(11)
    p = t(np.exp2(-rng.uniform(0, 100, size=100_000)).astype(np.float32))
    hi, lo = port_flash.split_p(p)
    for half in (hi, lo):
        assert torch.equal(half, half.to(torch.bfloat16).float())
    rel = ((hi.double() + lo.double() - p.double()).abs() / p.double()).max()
    assert float(rel) <= 2.0 ** -16


@pytest.mark.parametrize("hd,causal,window", [
    (16, True, 0), (32, True, 0), (64, True, 0), (128, True, 0),
    (256, True, 0), (64, False, 0), (128, False, 0), (64, True, 64),
    (256, True, 96)])
def test_bf16_plain_matches_pallas(hd, causal, window):
    """The bf16 arithmetic against the Pallas kernel (interpret mode) on the
    same bf16 inputs, at the band of its bf16-I/O test."""
    bh, s = 2, 256
    (q, k, v), _ = _bf16_qkv((bh, s, hd), (bh, s, hd), 12)
    jq, jk, jv = (jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
                  for x in (q, k, v))
    want = flash_attention_pallas(jq, jk, jv, causal=causal, window=window,
                                  block_q=128, block_k=128)
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(n(got.float()), np.asarray(want, np.float32),
                               rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("groups,window,hd,causal,sq,skv", [
    (2, 0, 16, True, 200, 200), (1, 0, 32, False, 200, 200),
    (7, 0, 64, True, 200, 200), (2, 16, 64, True, 200, 200),
    (2, 0, 128, True, 200, 200), (1, 24, 256, True, 200, 200),
    (2, 0, 64, True, 96, 300), (2, 0, 256, False, 70, 150)])
def test_bf16_plain_matches_chunked_attention(groups, window, hd, causal, sq,
                                              skv):
    """The bf16 arithmetic's f32 result (before the output's rounding)
    against ``chunked_attention`` on the same values in f32, ragged lengths,
    GQA, at the 2e-4 band."""
    b, kvh = 1, 2 if groups != 7 else 1
    h = kvh * groups
    (q, k, v), (fq, fk, fv) = _bf16_qkv((b, sq, h, hd), (b, skv, kvh, hd),
                                        13)
    want = chunked_attention(jnp.asarray(fq), jnp.asarray(fk),
                             jnp.asarray(fv), causal=causal, window=window,
                             q_chunk=64, kv_chunk=64)
    got = port_flash.attention_f32(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    out = port_flash.flash_attention_plain(q, k, v, causal=causal,
                                           window=window)
    assert torch.equal(out, got.to(torch.bfloat16))


@pytest.mark.parametrize("hd,causal,window", [(16, True, 0), (64, True, 0),
                                              (64, False, 0), (128, True, 32),
                                              (256, True, 0)])
def test_split_p_matches_an_f32_pv(monkeypatch, hd, causal, window):
    """P V by the two bf16 halves of p agrees with P V in f32 within 1e-5
    of max |out|."""
    (q, k, v), _ = _bf16_qkv((1, 150, 4, hd), (1, 150, 2, hd), 14)
    split = port_flash.attention_f32(q, k, v, causal=causal, window=window)
    monkeypatch.setattr(port_flash, "split_p",
                        lambda p: (p, torch.zeros_like(p)))
    whole = port_flash.attention_f32(q, k, v, causal=causal, window=window)
    assert float((split - whole).abs().max()) <= 1e-5 * float(
        whole.abs().max())
