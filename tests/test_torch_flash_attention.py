"""The plain version of the port's flash-attention kernel against the
reference's Pallas kernel (``flash_attention_pallas``, interpret mode off-TPU)
and against ``chunked_attention``, the function it replaces in the model.

Bands: 2e-5 in f32 and 3e-2 with bf16 I/O, as ``tests/test_flash_attention.py``
holds the Pallas kernel to its oracle; 2e-4 against ``chunked_attention``, as
``tests/test_models.py`` holds that to its oracle. The CUDA kernel itself
runs only on the card; ``chip_smoke.py`` holds it against this plain version
there (``tests/test_torch_kernels.py`` checks that its wrapper refuses CPU
tensors).
"""

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
