"""Decoder-only LM: the dense, vlm, moe, ssm and hybrid families (the port
of ``repro.models.lm``; the encoder-decoder is ``models.whisper``).

Parameters stay stacked along a leading layer axis with the reference's
keys; the passes are Python loops over layers. The attention of every
attention layer is ``models.attention.attention``: one launch of the
flash-attention kernel in the forward (where the reference calls
``chunked_attention``), and ``chunked_attention``'s gradient in the
backward. Decode attends against the cache in plain PyTorch, as the
reference does. The MoE router (``models.moe``), the SSD scan
(``models.mamba2``) and the RG-LRU scan (``models.rglru``) are plain
PyTorch, as the reference computes them outside any Pallas kernel.

The hybrid (recurrentgemma) keeps the reference's tree: ``blocks.slot{i}``
holds the i-th layer of every full repetition of the pattern, stacked
over the repetitions, and ``tail.tail{i}`` each trailing layer with a
leading axis of 1; ``_hybrid_layers`` walks them in depth order.

Public API:
  init_params(cfg, gen)                          -> param dict
  params_from_numpy(tree, device)                -> param dict
  forward(cfg, params, tokens, prefix_embeds, remat)
                                                 -> (final-normed hidden, aux)
  logits_fn(cfg, params, hidden)                 -> logits
  init_cache(cfg, batch, s_max, device)          -> decode cache
  decode_step(cfg, params, token, cache, pos)    -> (logits, cache)

The vlm frontend is a stub, as in the reference: ``prefix_embeds`` arrives
precomputed and is concatenated ahead of the token embeddings.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import mamba2, rglru
from repro_torch.models.attention import (attention, decode_attention,
                                          sharded_chunked_attention,
                                          update_cache)
from repro_torch.models.common import (ModelConfig, constrain, dense_init,
                                       gelu, on_mesh, reshape, rms_norm,
                                       rope, silu, sinusoidal_positions)
from repro_torch.models.ffn import gated_ffn
from repro_torch.models.moe import moe_ffn
from repro_torch.sharding.rules import (gather_rows, pin_activation,
                                       replicate_dims)


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


def _init_moe_ffn(gen, cfg: ModelConfig, n: int) -> dict:
    d, ff, e, dt = cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.dtype
    return {
        "norm": torch.zeros((n, d), dtype=dt, device=gen.device),
        "w_router": dense_init(gen, (n, d, e), dt, d),
        "w_gate": dense_init(gen, (n, e, d, ff), dt, d),
        "w_up": dense_init(gen, (n, e, d, ff), dt, d),
        "w_down": dense_init(gen, (n, e, ff, d), dt, ff),
    }


def _init_ssm(gen, cfg: ModelConfig, n: int) -> dict:
    d, dt, dev = cfg.d_model, cfg.dtype, gen.device
    d_in = cfg.ssm_expand * d
    nst = cfg.ssm_state
    nh = d_in // cfg.ssm_head_dim
    f32 = torch.float32
    return {
        "norm": torch.zeros((n, d), dtype=dt, device=dev),
        "in_proj": dense_init(gen, (n, d, 2 * d_in + 2 * nst + nh), dt, d),
        "conv_w": dense_init(gen, (n, mamba2.CONV_W, d_in + 2 * nst), dt,
                             mamba2.CONV_W),
        "a_log": torch.zeros((n, nh), dtype=f32, device=dev),
        "d_skip": torch.ones((n, nh), dtype=f32, device=dev),
        "dt_bias": torch.zeros((n, nh), dtype=f32, device=dev),
        "gate_norm": torch.zeros((n, d_in), dtype=dt, device=dev),
        "out_proj": dense_init(gen, (n, d_in, d), dt, d_in),
    }


def _init_rg(gen, cfg: ModelConfig, n: int) -> dict:
    d, dr, dt, dev = cfg.d_model, cfg.rglru_d_rnn, cfg.dtype, gen.device
    return {
        "norm": torch.zeros((n, d), dtype=dt, device=dev),
        "w_x": dense_init(gen, (n, d, dr), dt, d),
        "w_gate_branch": dense_init(gen, (n, d, dr), dt, d),
        "conv_w": dense_init(gen, (n, rglru.CONV_W, dr), dt, rglru.CONV_W),
        "w_gate_x": dense_init(gen, (n, dr, dr), dt, dr),
        "w_gate_a": dense_init(gen, (n, dr, dr), dt, dr),
        "lam": torch.full((n, dr), 0.5, dtype=torch.float32, device=dev),
        "w_out": dense_init(gen, (n, dr, d), dt, dr),
    }


def _hybrid_layers(cfg: ModelConfig):
    """(kind, key, index) of each hybrid layer in depth order: layer
    ``index`` of ``blocks[key]`` (key ``slot{i}``) or of ``tail[key]`` (key
    ``tail{i}``, index 0); the cache holds both kinds of key at its top."""
    pat = cfg.pattern
    n_groups = cfg.n_layers // len(pat)
    for g in range(n_groups):
        for i, kind in enumerate(pat):
            yield kind, f"slot{i}", g
    for i in range(cfg.n_layers - n_groups * len(pat)):
        yield pat[i % len(pat)], f"tail{i}", 0


def init_params(cfg: ModelConfig, gen: torch.Generator) -> dict:
    """Random parameters on the generator's device, drawn from ``gen``, in
    the reference's tree (the draws are the generator's, not the
    reference's keys)."""
    d = cfg.d_model
    params: dict = {
        "embed": dense_init(gen, (cfg.vocab, d), cfg.dtype, d),
        "final_norm": torch.zeros((d,), dtype=cfg.dtype, device=gen.device),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = dense_init(gen, (d, cfg.vocab), cfg.dtype, d)
    if cfg.kind in ("dense", "moe", "vlm"):
        ffn_init = _init_moe_ffn if cfg.kind == "moe" else _init_dense_ffn
        params["blocks"] = {"attn": _init_attn(gen, cfg, cfg.n_layers),
                            "ffn": ffn_init(gen, cfg, cfg.n_layers)}
    elif cfg.kind == "ssm":
        params["blocks"] = _init_ssm(gen, cfg, cfg.n_layers)
    elif cfg.kind == "hybrid":
        n_groups = cfg.n_layers // len(cfg.pattern)
        params["blocks"], params["tail"] = {}, {}
        for kind, key, _ in _hybrid_layers(cfg):
            tree = params["blocks" if key.startswith("slot") else "tail"]
            if key not in tree:
                n = n_groups if key.startswith("slot") else 1
                tree[key] = {"mix": (_init_attn if kind == "attn"
                                     else _init_rg)(gen, cfg, n),
                             "ffn": _init_dense_ffn(gen, cfg, n)}
    else:
        raise ValueError(cfg.kind)
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


def _layer(tree, i: int):
    """Layer i of a stacked parameter (or cache) tree of any depth."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _hybrid_params(params: dict, key: str) -> dict:
    return params["blocks" if key.startswith("slot") else "tail"][key]


def _embed(cfg: ModelConfig, params: dict, tokens: torch.Tensor):
    x = gather_rows(params["embed"], tokens).to(cfg.dtype)
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
    return (reshape(q, b, s, cfg.n_heads, cfg.hd),
            reshape(k, b, s, cfg.kv_heads, cfg.hd),
            reshape(v, b, s, cfg.kv_heads, cfg.hd))


# ================================================================== forward
def _attn_apply(cfg: ModelConfig, p: dict, x: torch.Tensor,
                positions: torch.Tensor, *, window: int = 0,
                causal: bool = True) -> torch.Tensor:
    x = pin_activation(x)
    b, s, _ = x.shape
    q, k, v = _qkv(cfg, p, x)
    if cfg.pos == "rope":
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    # the reference's constraints (no-ops unless cfg.tp_axis is set and the
    # tensors are DTensors): q rows over tp (sequence-parallel attention),
    # or attention data-parallel only
    if cfg.attn_dp_only:
        spec = ("dp", None, None, None)
        q, k, v = (constrain(t, cfg, spec) for t in (q, k, v))
    else:
        q = constrain(q, cfg, ("dp", "tp", None, None))
        k = constrain(k, cfg, ("dp", None, None, None))
        v = constrain(v, cfg, ("dp", None, None, None))
    if cfg.attn_p_bf16:
        # bf16 probabilities for P V: the reference's own path (the flash
        # kernel keeps p in f32); a q chunk no larger than a tp shard's rows
        q_chunk = 512
        if cfg.tp_size:
            q_chunk = max(128, min(512, s // cfg.tp_size))
        out = sharded_chunked_attention(q, k, v, causal=causal,
                                        window=window, p_bf16=True,
                                        q_chunk=q_chunk)
    else:
        out = attention(q, k, v, causal=causal, window=window)
    out = reshape(out, b, s, cfg.n_heads * cfg.hd)
    out = constrain(out, cfg, ("dp", "tp", None))
    # DTensor's matmul cannot fold rows sharded under a batch shard into
    # its 2-D product: a row-sharded output is gathered first
    out = replicate_dims(out, (1,))
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
    out = reshape(out, b, 1, cfg.n_heads * cfg.hd)
    return x + torch.matmul(out, p["wo"])


def _ffn_apply(cfg: ModelConfig, p: dict, x: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The FFN block: the gated FFN, or the MoE when ``p`` has a router.
    Returns (x + out, the MoE aux loss or 0 in f32)."""
    x = pin_activation(x)
    xn = rms_norm(x, p["norm"], cfg.norm_eps)
    if "w_router" in p:
        out, aux = moe_ffn(xn, p["w_router"], p["w_gate"], p["w_up"],
                           p["w_down"], top_k=cfg.top_k,
                           capacity_factor=cfg.capacity_factor,
                           act=cfg.ffn_act, cfg=cfg)
    else:
        out = gated_ffn(xn, p["w_gate"], p["w_up"], p["w_down"],
                        cfg.ffn_act)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + out, aux


def _ssm_in(cfg: ModelConfig, p: dict, x: torch.Tensor, conv_state=None):
    """The SSM block up to the scan: (z, xh (b, s, h, p), B, C, dt f32,
    new conv state or None)."""
    x = pin_activation(x)
    b, s, d = x.shape
    d_in = cfg.ssm_expand * d
    nst, nh = cfg.ssm_state, d_in // cfg.ssm_head_dim
    xn = rms_norm(x, p["norm"], cfg.norm_eps)
    zxbcdt = torch.matmul(xn, p["in_proj"])
    z, xc, bmat, cmat, dt = torch.split(zxbcdt, [d_in, d_in, nst, nst, nh],
                                        dim=-1)
    conv_in = torch.cat([xc, bmat, cmat], dim=-1)
    if conv_state is None:
        conv_out = mamba2._depthwise_conv(conv_in, p["conv_w"])
    else:
        conv_out, conv_state = rglru.causal_conv(conv_in, p["conv_w"],
                                                 conv_state)
    xc, bmat, cmat = torch.split(silu(conv_out), [d_in, nst, nst], dim=-1)
    dt = F.softplus(dt.to(torch.float32) + p["dt_bias"])
    return (z, reshape(xc, b, s, nh, cfg.ssm_head_dim), bmat, cmat, dt,
            conv_state)


def _ssm_out(cfg: ModelConfig, p: dict, x, z, xh, y):
    b, s, d = x.shape
    y = y + p["d_skip"][None, None, :, None] * xh.to(torch.float32)
    y = reshape(y, b, s, cfg.ssm_expand * d).to(x.dtype)
    y = rms_norm(y * silu(z), p["gate_norm"], cfg.norm_eps)
    return x + torch.matmul(y, p["out_proj"])


def _ssm_apply(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    z, xh, bmat, cmat, dt, _ = _ssm_in(cfg, p, x)
    y, _ = mamba2.ssd_chunked(xh, dt, p["a_log"], bmat, cmat, cfg.ssm_chunk)
    return _ssm_out(cfg, p, x, z, xh, y)


def _ssm_decode(cfg: ModelConfig, p: dict, x: torch.Tensor,
                ssm_state: torch.Tensor, conv_state: torch.Tensor):
    """One token; returns (x, new ssm state, new conv state)."""
    z, xh, bmat, cmat, dt, conv_state = _ssm_in(cfg, p, x, conv_state)
    y, ssm_state = mamba2.ssd_decode_step(xh, dt, p["a_log"], bmat, cmat,
                                          ssm_state)
    return _ssm_out(cfg, p, x, z, xh, y), ssm_state, conv_state


def _rg_apply(cfg: ModelConfig, p: dict, x: torch.Tensor,
              h0: torch.Tensor | None = None,
              conv_state: torch.Tensor | None = None, decode: bool = False):
    """The Griffin recurrent block; returns (x, h_last, conv state)."""
    x = pin_activation(x)
    xn = rms_norm(x, p["norm"], cfg.norm_eps)
    branch = torch.matmul(xn, p["w_x"])
    gate_branch = gelu(torch.matmul(xn, p["w_gate_branch"]))
    conv_out, conv_state = rglru.causal_conv(branch, p["conv_w"], conv_state)
    gx = torch.matmul(conv_out, p["w_gate_x"])
    ga = torch.matmul(conv_out, p["w_gate_a"])
    scan = rglru.rg_lru_step if decode else rglru.rg_lru
    y, h = scan(conv_out, gx, ga, p["lam"], h0)
    return x + torch.matmul(y * gate_branch, p["w_out"]), h, conv_state


@on_mesh
def forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
            prefix_embeds: torch.Tensor | None = None,
            remat: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (hidden (b, s_total, d) after the final norm, the MoE aux
    loss summed over layers, 0 for the other families).

    remat=True checkpoints each layer (each full pattern group of the
    hybrid; its tail layers stay unwrapped, as in the reference): the
    backward recomputes the layer's forward, flash launches included,
    from its saved input.
    """
    x = _embed(cfg, params, tokens)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(cfg.dtype), x], dim=1)
    x = pin_activation(x)
    b, s, d = x.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)
    if cfg.pos == "sinusoidal":
        x = x + sinusoidal_positions(s, d, x.device).to(cfg.dtype)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)

    def run(body, *args):
        if remat:
            return checkpoint(body, *args, use_reentrant=False)
        return body(*args)

    if cfg.kind in ("dense", "moe", "vlm"):
        def body(h, lp):
            h = _attn_apply(cfg, lp["attn"], h, positions,
                            window=cfg.local_window)
            return _ffn_apply(cfg, lp["ffn"], h)

        for i in range(cfg.n_layers):
            x, aux = run(body, x, _layer(params["blocks"], i))
            aux_total = aux_total + aux
    elif cfg.kind == "ssm":
        for i in range(cfg.n_layers):
            x = run(_ssm_apply, cfg, _layer(params["blocks"], i), x)
    elif cfg.kind == "hybrid":
        def group(h, layers):
            for kind, lp in layers:
                if kind == "attn":
                    h = _attn_apply(cfg, lp["mix"], h, positions,
                                    window=cfg.local_window)
                else:
                    h, _, _ = _rg_apply(cfg, lp["mix"], h)
                h, _ = _ffn_apply(cfg, lp["ffn"], h)
            return h

        groups: dict[int, list] = {}
        tail = []
        for kind, key, j in _hybrid_layers(cfg):
            lp = _layer(_hybrid_params(params, key), j)
            if key.startswith("slot"):
                groups.setdefault(j, []).append((kind, lp))
            else:
                tail.append((kind, lp))
        for layers in groups.values():
            x = run(group, x, layers)
        x = group(x, tail)
    else:
        raise ValueError(cfg.kind)
    x = rms_norm(pin_activation(x), params["final_norm"], cfg.norm_eps)
    return x, aux_total


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
    """The decode cache of zeros: KV caches (layers, b, s_max, kv, hd) for
    attention layers, f32 states and conv contexts for the recurrent ones,
    in the reference's tree."""
    dev = resolve_device(device)
    kv, hd, dt = cfg.kv_heads, cfg.hd, cfg.dtype

    def zeros(*shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=dev)

    if cfg.kind in ("dense", "moe", "vlm"):
        shape = (cfg.n_layers, batch, s_max, kv, hd)
        return {"k": zeros(*shape), "v": zeros(*shape)}
    if cfg.kind == "ssm":
        d_in = cfg.ssm_expand * cfg.d_model
        return {
            "ssm": zeros(cfg.n_layers, batch, d_in // cfg.ssm_head_dim,
                         cfg.ssm_state, cfg.ssm_head_dim,
                         dtype=torch.float32),
            "conv": zeros(cfg.n_layers, batch, rglru.CONV_W - 1,
                          d_in + 2 * cfg.ssm_state),
        }
    if cfg.kind == "hybrid":
        n_groups = cfg.n_layers // len(cfg.pattern)
        dr = cfg.rglru_d_rnn
        cache: dict = {}
        for kind, key, _ in _hybrid_layers(cfg):
            n = n_groups if key.startswith("slot") else 1
            if kind == "attn":
                cache[key] = {"k": zeros(n, batch, s_max, kv, hd),
                              "v": zeros(n, batch, s_max, kv, hd)}
            else:
                cache[key] = {"h": zeros(n, batch, dr, dtype=torch.float32),
                              "conv": zeros(n, batch, rglru.CONV_W - 1, dr)}
        return cache
    raise ValueError(cfg.kind)


def _sinusoid_row(pos: int, d: int, device) -> torch.Tensor:
    """Row ``pos`` of ``sinusoidal_positions``, without the table."""
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)
    ang = torch.tensor(float(pos), dtype=torch.float32,
                       device=device) / torch.pow(10000.0, dim / d)
    row = torch.zeros((d,), dtype=torch.float32, device=device)
    row[0::2] = torch.sin(ang)
    row[1::2] = torch.cos(ang[: d // 2])
    return row


@on_mesh
def decode_step(cfg: ModelConfig, params: dict, token: torch.Tensor,
                cache: dict, pos: int) -> tuple[torch.Tensor, dict]:
    """token: (b, 1) integer; pos: the cache write position (int). The
    cache (KV rows, recurrent states) is updated in place and returned."""
    x = _embed(cfg, params, token)
    if cfg.pos == "sinusoidal":
        x = x + _sinusoid_row(pos, x.shape[-1], x.device).to(cfg.dtype)
    if cfg.kind in ("dense", "moe", "vlm"):
        for i in range(cfg.n_layers):
            lp = _layer(params["blocks"], i)
            x = _attn_decode(cfg, lp["attn"], x, pos, cache["k"][i],
                             cache["v"][i], window=cfg.local_window)
            x, _ = _ffn_apply(cfg, lp["ffn"], x)
    elif cfg.kind == "ssm":
        for i in range(cfg.n_layers):
            x, st, cv = _ssm_decode(cfg, _layer(params["blocks"], i), x,
                                    cache["ssm"][i], cache["conv"][i])
            cache["ssm"][i], cache["conv"][i] = st, cv
    elif cfg.kind == "hybrid":
        for kind, key, j in _hybrid_layers(cfg):
            lp, c = _layer(_hybrid_params(params, key), j), cache[key]
            if kind == "attn":
                x = _attn_decode(cfg, lp["mix"], x, pos, c["k"][j],
                                 c["v"][j], window=cfg.local_window)
            else:
                x, h, cv = _rg_apply(cfg, lp["mix"], x, c["h"][j],
                                     c["conv"][j], decode=True)
                c["h"][j], c["conv"][j] = h, cv
            x, _ = _ffn_apply(cfg, lp["ffn"], x)
    else:
        raise ValueError(cfg.kind)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return logits_fn(cfg, params, x), cache
