"""Attention for cached decode (the port of ``repro.models.attention``).

The prefill/training path of the reference, ``chunked_attention``, is not
ported: ``kernels.ops.flash_attention`` computes the same function and takes
its place in ``models.lm._attn_apply`` (the tests hold the two equal).

Decode attends one query position against the full cache: the score row is
only (b, h, s), so it is computed directly, grouped-GQA without repeating
the cache. The KV cache layout is (b, s_max, kv_heads, hd).
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def repeat_kv(x: torch.Tensor, groups: int) -> torch.Tensor:
    """(b, s, kv, hd) -> (b, s, kv*groups, hd) for GQA."""
    if groups == 1:
        return x
    return torch.repeat_interleave(x, groups, dim=2)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: torch.Tensor, *,
                     window: int = 0, p_bf16: bool = False) -> torch.Tensor:
    """One-step decode. q: (b, 1, h, hd); caches: (b, s_max, kvh, hd).

    cache_len (b,): the new token's position; keys up to and including it
    are attended. As in the reference: q times the scale in q's dtype,
    scores and softmax in f32, p cast to bf16 for the PV product when
    ``p_bf16``. The products take f32 copies of their operands: bf16
    products are exact in f32, so this is the reference's
    ``preferred_element_type=f32``.
    """
    b, _, h, hd = q.shape
    s_max, kvh = k_cache.shape[1], k_cache.shape[2]
    grp = h // kvh
    scale = hd ** -0.5
    f32 = torch.float32

    q4 = (q[:, 0] * scale).reshape(b, kvh, grp, hd)
    s = torch.einsum("bhgd,bshd->bhgs", q4.to(f32), k_cache.to(f32))
    kpos = torch.arange(s_max, device=q.device)
    mask = kpos[None, :] <= cache_len[:, None]           # causal: <= pos
    if window > 0:
        mask = mask & (kpos[None, :] > cache_len[:, None] - window)
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    if p_bf16:
        p = p.to(torch.bfloat16).to(f32)
    out = torch.einsum("bhgs,bshd->bhgd", p, v_cache.to(f32))
    return out.reshape(b, 1, h, hd).to(q.dtype)


def update_cache(k_cache: torch.Tensor, v_cache: torch.Tensor,
                 k_new: torch.Tensor, v_new: torch.Tensor,
                 index: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Write (b, 1, kvh, hd) new KV at position ``index`` of the caches.

    Writes IN PLACE into the preallocated caches and returns them. The
    reference returns updated copies (``dynamic_update_slice``, JAX's
    functional idiom), which in eager PyTorch would copy every layer's
    cache on every token. Unlike ``dynamic_update_slice``, an index past
    the end raises instead of being clamped.
    """
    k_cache[:, index] = k_new[:, 0]
    v_cache[:, index] = v_new[:, 0]
    return k_cache, v_cache
