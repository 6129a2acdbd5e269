"""Decoder-only LM, the dense family (the port of ``repro.models.lm`` for the
kinds ``dense`` and ``vlm``).

Parameters stay stacked along a leading layer axis with the reference's
keys; the passes are Python loops over layers. The prefill attention of
every layer is one launch of the flash-attention kernel
(``kernels.ops.flash_attention``) where the reference calls
``chunked_attention``; decode attends against the cache in plain PyTorch,
as the reference does. The kinds ``moe``, ``ssm``, ``hybrid`` and ``encdec``
raise ``NotImplementedError``.

Public API:
  init_params(cfg, gen)                          -> param dict
  params_from_numpy(tree, device)                -> param dict
  forward(cfg, params, tokens, prefix_embeds)    -> (final-normed hidden, aux)
  logits_fn(cfg, params, hidden)                 -> logits
  init_cache(cfg, batch, s_max, device)          -> decode cache
  decode_step(cfg, params, token, cache, pos)    -> (logits, cache)

The vlm frontend is a stub, as in the reference: ``prefix_embeds`` arrives
precomputed and is concatenated ahead of the token embeddings.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models.attention import decode_attention, update_cache
from repro_torch.models.common import (ModelConfig, dense_init, require_dense,
                                       rms_norm, rope, sinusoidal_positions)
from repro_torch.models.ffn import gated_ffn


# ===================================================================== init
def _init_attn(gen, cfg: ModelConfig, n: int) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.hd
    dt, dev = cfg.dtype, gen.device
    p = {
        "norm": torch.zeros((n, d), dtype=dt, device=dev),
        "wq": dense_init(gen, (n, d, h * hd), dt, d),
        "wk": dense_init(gen, (n, d, kv * hd), dt, d),
        "wv": dense_init(gen, (n, d, kv * hd), dt, d),
        "wo": dense_init(gen, (n, h * hd, d), dt, h * hd),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((n, h * hd), dtype=dt, device=dev)
        p["bk"] = torch.zeros((n, kv * hd), dtype=dt, device=dev)
        p["bv"] = torch.zeros((n, kv * hd), dtype=dt, device=dev)
    return p


def _init_dense_ffn(gen, cfg: ModelConfig, n: int) -> dict:
    d, ff, dt = cfg.d_model, cfg.d_ff, cfg.dtype
    return {
        "norm": torch.zeros((n, d), dtype=dt, device=gen.device),
        "w_gate": dense_init(gen, (n, d, ff), dt, d),
        "w_up": dense_init(gen, (n, d, ff), dt, d),
        "w_down": dense_init(gen, (n, ff, d), dt, ff),
    }


def init_params(cfg: ModelConfig, gen: torch.Generator) -> dict:
    """Random parameters on the generator's device, drawn from ``gen``."""
    require_dense(cfg)
    d = cfg.d_model
    params: dict = {
        "embed": dense_init(gen, (cfg.vocab, d), cfg.dtype, d),
        "final_norm": torch.zeros((d,), dtype=cfg.dtype, device=gen.device),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = dense_init(gen, (d, cfg.vocab), cfg.dtype, d)
    params["blocks"] = {"attn": _init_attn(gen, cfg, cfg.n_layers),
                        "ffn": _init_dense_ffn(gen, cfg, cfg.n_layers)}
    return params


def params_from_numpy(tree, device="cuda"):
    """A parameter tree of numpy arrays (e.g. the reference's parameters
    through ``np.asarray``) as torch tensors on ``device``. bfloat16 arrays
    (``ml_dtypes.bfloat16``, which ``torch.from_numpy`` refuses) cross as
    their 16-bit patterns."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, dev) for k, v in tree.items()}
    a = np.array(tree)       # a writable copy: JAX's arrays are read-only
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(dev)


def _layer(blocks: dict, i: int) -> dict:
    return {name: {k: w[i] for k, w in sub.items()}
            for name, sub in blocks.items()}


def _embed(cfg: ModelConfig, params: dict, tokens: torch.Tensor):
    x = params["embed"][tokens].to(cfg.dtype)
    if cfg.arch.startswith("gemma") or cfg.arch.startswith("recurrentgemma"):
        # the scale is rounded to the config dtype first, as jnp.asarray does
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=cfg.dtype,
                             device=x.device)
    return x


def _qkv(cfg: ModelConfig, p: dict, x: torch.Tensor):
    b, s, _ = x.shape
    xn = rms_norm(x, p["norm"], cfg.norm_eps)
    q = torch.matmul(xn, p["wq"])
    k = torch.matmul(xn, p["wk"])
    v = torch.matmul(xn, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (q.reshape(b, s, cfg.n_heads, cfg.hd),
            k.reshape(b, s, cfg.kv_heads, cfg.hd),
            v.reshape(b, s, cfg.kv_heads, cfg.hd))


# ================================================================== forward
def _attn_apply(cfg: ModelConfig, p: dict, x: torch.Tensor,
                positions: torch.Tensor, *, window: int = 0,
                causal: bool = True) -> torch.Tensor:
    if cfg.attn_p_bf16:
        raise NotImplementedError("attn_p_bf16: the flash kernel keeps p in "
                                  "f32 for the PV product")
    b, s, _ = x.shape
    q, k, v = _qkv(cfg, p, x)
    if cfg.pos == "rope":
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    out = out.reshape(b, s, cfg.n_heads * cfg.hd)
    return x + torch.matmul(out, p["wo"])


def _attn_decode(cfg: ModelConfig, p: dict, x: torch.Tensor, pos: int,
                 kc: torch.Tensor, vc: torch.Tensor, *, window: int = 0
                 ) -> torch.Tensor:
    """One token: writes its K/V at ``pos`` of the layer's caches (in
    place) and attends against them."""
    b = x.shape[0]
    q, k, v = _qkv(cfg, p, x)
    if cfg.pos == "rope":
        pp = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
        q = rope(q, pp, cfg.rope_theta)
        k = rope(k, pp, cfg.rope_theta)
    update_cache(kc, vc, k, v, pos)
    cache_len = torch.full((b,), pos, dtype=torch.int32, device=x.device)
    out = decode_attention(q, kc, vc, cache_len, window=window,
                           p_bf16=cfg.attn_p_bf16)
    out = out.reshape(b, 1, cfg.n_heads * cfg.hd)
    return x + torch.matmul(out, p["wo"])


def _ffn_apply(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    xn = rms_norm(x, p["norm"], cfg.norm_eps)
    return x + gated_ffn(xn, p["w_gate"], p["w_up"], p["w_down"],
                         cfg.ffn_act)


def forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
            prefix_embeds: torch.Tensor | None = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (hidden (b, s_total, d) after the final norm, aux loss),
    the aux loss 0 for the dense family. The reference's ``remat`` is a
    training option and is not ported."""
    require_dense(cfg)
    x = _embed(cfg, params, tokens)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(cfg.dtype), x], dim=1)
    b, s, d = x.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)
    if cfg.pos == "sinusoidal":
        x = x + sinusoidal_positions(s, d, x.device).to(cfg.dtype)
    for i in range(cfg.n_layers):
        lp = _layer(params["blocks"], i)
        x = _attn_apply(cfg, lp["attn"], x, positions,
                        window=cfg.local_window)
        x = _ffn_apply(cfg, lp["ffn"], x)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def unembed_matrix(cfg: ModelConfig, params: dict) -> torch.Tensor:
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["unembed"]


def logits_fn(cfg: ModelConfig, params: dict,
              hidden: torch.Tensor) -> torch.Tensor:
    return torch.matmul(hidden, unembed_matrix(cfg, params))


# ==================================================================== decode
def init_cache(cfg: ModelConfig, batch: int, s_max: int,
               device="cuda") -> dict:
    require_dense(cfg)
    shape = (cfg.n_layers, batch, s_max, cfg.kv_heads, cfg.hd)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=dev)}


def decode_step(cfg: ModelConfig, params: dict, token: torch.Tensor,
                cache: dict, pos: int) -> tuple[torch.Tensor, dict]:
    """token: (b, 1) integer; pos: the cache write position (int). The
    cache is updated in place and returned."""
    require_dense(cfg)
    x = _embed(cfg, params, token)
    if cfg.pos == "sinusoidal":
        x = x + sinusoidal_positions(pos + 1, x.shape[-1],
                                     x.device)[pos].to(cfg.dtype)
    for i in range(cfg.n_layers):
        lp = _layer(params["blocks"], i)
        x = _attn_decode(cfg, lp["attn"], x, pos, cache["k"][i],
                         cache["v"][i], window=cfg.local_window)
        x = _ffn_apply(cfg, lp["ffn"], x)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return logits_fn(cfg, params, x), cache

