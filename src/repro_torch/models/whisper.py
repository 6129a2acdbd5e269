"""Whisper-style encoder-decoder backbone, conv frontend stubbed (the port of
``repro.models.whisper``).

As in the reference, the audio frontend is a stub: the caller supplies
frame embeddings (b, enc_seq, d). The backbone is real: a bidirectional
encoder and a causal decoder with cross-attention, RMSNorm and sinusoidal
positions on both sides (the reference's stand-ins for LayerNorm and
learned positions).

Every attention of the forward is ``models.attention.attention``, one
launch of the flash kernel (with ``chunked_attention``'s gradient in the
backward): the encoder's self-attention non-causal, the decoder's causal,
the cross-attention non-causal with Sq != Skv. As in the reference, the
forward has no ``remat``. Decode attends against the KV
cache and against the encoder's K/V, which ``prefill_cross`` computes once
and writes into the cache, in plain PyTorch.
"""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.models.attention import attention, decode_attention
from repro_torch.models.common import (ModelConfig, dense_init, on_mesh,
                                       reshape, rms_norm,
                                       sinusoidal_positions)
from repro_torch.sharding.rules import gather_rows, pin_activation


def _init_cross(gen, cfg: ModelConfig, n: int) -> dict:
    d, h, kv, hd, dt = cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.hd, \
        cfg.dtype
    return {
        "norm": torch.zeros((n, d), dtype=dt, device=gen.device),
        "wq": dense_init(gen, (n, d, h * hd), dt, d),
        "wk": dense_init(gen, (n, d, kv * hd), dt, d),
        "wv": dense_init(gen, (n, d, kv * hd), dt, d),
        "wo": dense_init(gen, (n, h * hd, d), dt, h * hd),
    }


def init_params(cfg: ModelConfig, gen: torch.Generator) -> dict:
    """Random parameters on the generator's device, in the reference's
    tree."""
    d, dt, dev = cfg.d_model, cfg.dtype, gen.device
    return {
        "embed": dense_init(gen, (cfg.vocab, d), dt, d),
        "unembed": dense_init(gen, (d, cfg.vocab), dt, d),
        "final_norm": torch.zeros((d,), dtype=dt, device=dev),
        "enc_final_norm": torch.zeros((d,), dtype=dt, device=dev),
        "enc_blocks": {
            "attn": lm._init_attn(gen, cfg, cfg.enc_layers),
            "ffn": lm._init_dense_ffn(gen, cfg, cfg.enc_layers),
        },
        "dec_blocks": {
            "attn": lm._init_attn(gen, cfg, cfg.n_layers),
            "cross": _init_cross(gen, cfg, cfg.n_layers),
            "ffn": lm._init_dense_ffn(gen, cfg, cfg.n_layers),
        },
    }


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device).expand(b, s)


def encode(cfg: ModelConfig, params: dict,
           frames: torch.Tensor) -> torch.Tensor:
    """frames: (b, enc_seq, d) stub embeddings -> encoder states."""
    b, s, d = frames.shape
    x = frames.to(cfg.dtype) + sinusoidal_positions(
        s, d, frames.device).to(cfg.dtype)
    positions = _positions(b, s, x.device)
    for i in range(cfg.enc_layers):
        lp = lm._layer(params["enc_blocks"], i)
        x = lm._attn_apply(cfg, lp["attn"], x, positions, causal=False)
        x, _ = lm._ffn_apply(cfg, lp["ffn"], x)
    return rms_norm(pin_activation(x), params["enc_final_norm"],
                    cfg.norm_eps)


def _cross_kv(cfg: ModelConfig, p: dict, enc: torch.Tensor):
    b = enc.shape[0]
    shape = (b, -1, cfg.kv_heads, cfg.hd)
    return (reshape(torch.matmul(enc, p["wk"]), *shape),
            reshape(torch.matmul(enc, p["wv"]), *shape))


def _cross_apply(cfg: ModelConfig, p: dict, x: torch.Tensor,
                 enc: torch.Tensor) -> torch.Tensor:
    x = pin_activation(x)
    b, s, _ = x.shape
    xn = rms_norm(x, p["norm"], cfg.norm_eps)
    q = reshape(torch.matmul(xn, p["wq"]), b, s, cfg.n_heads, cfg.hd)
    k, v = _cross_kv(cfg, p, enc)
    out = attention(q, k, v, causal=False)
    return x + torch.matmul(reshape(out, b, s, cfg.n_heads * cfg.hd),
                            p["wo"])


@on_mesh
def forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
            frames: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Full teacher-forced pass. Returns (decoder hidden, aux = 0)."""
    enc = pin_activation(encode(cfg, params, frames))
    b, s = tokens.shape
    x = gather_rows(params["embed"], tokens).to(cfg.dtype)
    x = x + sinusoidal_positions(s, cfg.d_model, x.device).to(cfg.dtype)
    positions = _positions(b, s, x.device)
    for i in range(cfg.n_layers):
        lp = lm._layer(params["dec_blocks"], i)
        x = lm._attn_apply(cfg, lp["attn"], x, positions, causal=True)
        x = _cross_apply(cfg, lp["cross"], x, enc)
        x, _ = lm._ffn_apply(cfg, lp["ffn"], x)
    x = rms_norm(pin_activation(x), params["final_norm"], cfg.norm_eps)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


# ------------------------------------------------------------------ decode
def init_cache(cfg: ModelConfig, batch: int, s_max: int,
               device="cuda") -> dict:
    """Self-attention KV caches and the cross K/V (``xk``, ``xv``), which
    ``prefill_cross`` fills, all zeros."""
    dev = resolve_device(device)
    n, kv, hd = cfg.n_layers, cfg.kv_heads, cfg.hd

    def zeros(s):
        return torch.zeros((n, batch, s, kv, hd), dtype=cfg.dtype,
                           device=dev)

    return {"k": zeros(s_max), "v": zeros(s_max),
            "xk": zeros(cfg.enc_seq), "xv": zeros(cfg.enc_seq)}


@on_mesh
def prefill_cross(cfg: ModelConfig, params: dict, cache: dict,
                  frames: torch.Tensor) -> dict:
    """Run the encoder once and write every layer's cross K/V into the
    cache (in place; the cache is returned)."""
    enc = pin_activation(encode(cfg, params, frames))
    for i in range(cfg.n_layers):
        k, v = _cross_kv(cfg, lm._layer(params["dec_blocks"]["cross"], i),
                         enc)
        cache["xk"][i], cache["xv"][i] = k, v
    return cache


@on_mesh
def decode_step(cfg: ModelConfig, params: dict, token: torch.Tensor,
                cache: dict, pos: int) -> tuple[torch.Tensor, dict]:
    """token: (b, 1) integer; pos: the cache write position (int)."""
    b = token.shape[0]
    h, hd = cfg.n_heads, cfg.hd
    x = gather_rows(params["embed"], token).to(cfg.dtype)
    x = x + lm._sinusoid_row(pos, cfg.d_model, x.device).to(cfg.dtype)
    full = torch.full((b,), cache["xk"].shape[2] - 1, dtype=torch.int32,
                      device=x.device)
    for i in range(cfg.n_layers):
        lp = lm._layer(params["dec_blocks"], i)
        x = lm._attn_decode(cfg, lp["attn"], x, pos, cache["k"][i],
                            cache["v"][i])
        # cross-attention against the precomputed encoder K/V
        p = lp["cross"]
        xn = rms_norm(x, p["norm"], cfg.norm_eps)
        q = reshape(torch.matmul(xn, p["wq"]), b, 1, h, hd)
        out = decode_attention(q, cache["xk"][i], cache["xv"][i], full)
        x = x + torch.matmul(reshape(out, b, 1, h * hd), p["wo"])
        x, _ = lm._ffn_apply(cfg, lp["ffn"], x)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return lm.logits_fn(cfg, params, x), cache
