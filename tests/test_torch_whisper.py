"""The port's encoder-decoder (``repro_torch.models.whisper``) against the
reference's ``repro.models.whisper`` at whisper-base's smoke config: the
encoder (non-causal flash), the cross-attention (flash with Sq != Skv),
``prefill_cross`` and the cross K/V it writes, and the decode step's
cross-attention against them; the encoder's bidirectional and the
decoder's causal reach.

Bands as ``tests/_torch_lm.py``: 1e-4 relative in f32, 0.02 in bf16
against the reference run op by op.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm import (BAND, DTYPES, aux_input, f32, pair, ref_mode, rel,
                       tokens)
from _torch_parity import t
from repro.models import whisper as ref_whisper
from repro_torch.configs import get_config
from repro_torch.models import lm, whisper
from repro_torch.models.registry import build

ARCH = "whisper-base"


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_encode_matches_reference(dt):
    rm, rp, pm, pp = pair(ARCH, dt)
    frames = aux_input(pm.cfg, 2)
    with ref_mode(dt):
        want = ref_whisper.encode(rm.cfg, rp, jnp.asarray(frames))
    got = whisper.encode(pm.cfg, pp, t(frames))
    assert got.shape == (2, pm.cfg.enc_seq, pm.cfg.d_model)
    assert got.dtype == DTYPES[dt][1]
    assert rel(f32(got), f32(want)) < BAND[dt]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_cross_attention_matches_reference(dt):
    """12 decoder positions against the 32 encoder states, non-causal."""
    rm, rp, pm, pp = pair(ARCH, dt)
    jdt, tdt = DTYPES[dt]
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 12, 64)).astype(np.float32)
    enc = rng.normal(size=(2, pm.cfg.enc_seq, 64)).astype(np.float32)
    rlp = jax.tree.map(lambda a: a[1], rp["dec_blocks"]["cross"])
    plp = lm._layer(pp["dec_blocks"]["cross"], 1)
    with ref_mode(dt):
        want = ref_whisper._cross_apply(rm.cfg, rlp,
                                        jnp.asarray(x).astype(jdt),
                                        jnp.asarray(enc).astype(jdt))
    got = whisper._cross_apply(pm.cfg, plp, t(x).to(tdt), t(enc).to(tdt))
    assert rel(f32(got) - x, f32(want) - x) < BAND[dt]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_prefill_cross_writes_the_references_cross_kv(dt):
    rm, rp, pm, pp = pair(ARCH, dt)
    frames = aux_input(pm.cfg, 2)
    with ref_mode(dt):
        rc = ref_whisper.prefill_cross(rm.cfg, rp, rm.init_cache(2, 8),
                                       jnp.asarray(frames))
    pc = pm.init_cache(2, 8, "cpu")
    xk = pc["xk"]
    out = whisper.prefill_cross(pm.cfg, pp, pc, t(frames))
    assert out["xk"] is xk                      # written in place
    for k in ("xk", "xv"):
        assert tuple(out[k].shape) == rc[k].shape
        assert rel(f32(out[k]), f32(rc[k])) < BAND[dt], k
    assert not out["k"].any() and not out["v"].any()


def test_decode_step_attends_the_cross_kv():
    """Decode against the cross K/V of two different frame sets: the
    logits differ, and each matches the reference's (f32)."""
    rm, rp, pm, pp = pair(ARCH, "f32")
    tok = tokens(pm.cfg, 2, 1)
    logits = []
    for seed in (2, 3):
        frames = aux_input(pm.cfg, 2, seed=seed)
        rc = ref_whisper.prefill_cross(rm.cfg, rp, rm.init_cache(2, 4),
                                       jnp.asarray(frames))
        rl, _ = rm.decode_step(rp, jnp.asarray(tok), rc,
                               jnp.asarray(0, jnp.int32))
        pc = whisper.prefill_cross(pm.cfg, pp, pm.init_cache(2, 4, "cpu"),
                                   t(frames))
        pl, _ = pm.decode_step(pp, t(tok), pc, 0)
        assert rel(f32(pl), f32(rl)) < BAND["f32"]
        logits.append(f32(pl))
    assert np.abs(logits[0] - logits[1]).max() > 1e-3


def test_encoder_is_bidirectional_and_decoder_causal():
    """A change to the last frame moves the first encoder state; a change
    to the last token leaves the earlier decoder states as they were."""
    _, _, pm, pp = pair(ARCH, "f32")
    frames = t(aux_input(pm.cfg, 1))
    moved = frames.clone()
    moved[:, -1] += 1.0
    e0 = whisper.encode(pm.cfg, pp, frames)
    e1 = whisper.encode(pm.cfg, pp, moved)
    assert float((e0[:, 0] - e1[:, 0]).abs().max()) > 1e-4
    tok = t(tokens(pm.cfg, 1, 10))
    tok2 = tok.clone()
    tok2[:, -1] = (tok2[:, -1] + 1) % pm.cfg.vocab
    h0, _ = pm.forward(pp, tok, frames)
    h1, _ = pm.forward(pp, tok2, frames)
    assert torch.equal(h0[:, :-1], h1[:, :-1])
    assert not torch.equal(h0[:, -1], h1[:, -1])


def test_full_size_cache_shapes():
    """whisper-base's cache: 6 layers of (b, s_max, 8, 64) self K/V and
    (b, 1,500, 8, 64) cross K/V."""
    cfg = get_config(ARCH)
    cache = build(cfg).init_cache(2, 448, "cpu")
    assert tuple(cache["k"].shape) == (6, 2, 448, 8, 64)
    assert tuple(cache["xk"].shape) == (6, 2, 1500, 8, 64)
    assert all(v.dtype == torch.bfloat16 for v in cache.values())
