"""Attention: the chunked streaming softmax of training, the differentiable
attention of the forward, and cached decode (the port of
``repro.models.attention``).

``chunked_attention`` is the reference's training and prefill path: q/kv
chunks with an online softmax (running max and denominator), GQA folded as
(kv heads, group) so K/V are never repeated, causal and windowed masks,
``q_offset`` and ``p_bf16``. It is plain PyTorch, as the reference
computes it outside any Pallas kernel, and autograd differentiates it as
``jax.grad`` does the reference's.

``attention`` is what ``models.lm`` and ``models.whisper`` call: a
``torch.autograd.Function`` whose forward is the flash-attention kernel
(``kernels.ops.flash_attention``: the hand-written kernel on a CUDA tensor,
its plain version on a CPU tensor) and whose backward recomputes
``chunked_attention`` at the reference's chunk sizes (q 512, kv 1,024) and
returns its gradient. So every forward, the remat recompute included, runs
the kernel, and the gradient is the one the reference trains with. The
flash kernel has no backward, in the reference as here.

Decode attends one query position against the full cache: the score row is
only (b, h, s), so it is computed directly, grouped-GQA without repeating
the cache. The KV cache layout is (b, s_max, kv_heads, hd).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.sharding.rules import from_local, is_dtensor

NEG_INF = -1e30


def repeat_kv(x: torch.Tensor, groups: int) -> torch.Tensor:
    """(b, s, kv, hd) -> (b, s, kv*groups, hd) for GQA."""
    if groups == 1:
        return x
    return torch.repeat_interleave(x, groups, dim=2)


def _pad_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    """x (b, s, h, d) with n zero rows appended along s, by concatenation:
    DTensor's ``constant_pad_nd`` rule (torch 2.11) gives a 2-D mesh one
    placement, which the next view refuses."""
    if n == 0:
        return x
    return torch.cat([x, torch.zeros_like(x[:, :1]).expand(-1, n, -1, -1)],
                     dim=1)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int = 0,
                      q_chunk: int = 512, kv_chunk: int = 1024,
                      q_offset: int = 0,
                      p_bf16: bool = False) -> torch.Tensor:
    """Streaming softmax attention, grouped-GQA form.

    q: (b, sq, h, hd); k, v: (b, skv, kvh, hd) with h % kvh == 0.
    window > 0 restricts attention to the last ``window`` keys (local
    attention); ``q_offset`` is the absolute position of q[0] relative to
    k[0]; ``p_bf16`` rounds the probabilities to bf16 for the PV product
    (the statistics stay f32). As in the reference: q times the scale in
    q's dtype, padded to whole chunks, every (q, kv) chunk pair computed
    (masked scores at NEG_INF), the products in f32 from the operands'
    values (a bf16 product is exact in f32: the reference's
    ``preferred_element_type=f32``).
    """
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    grp = h // kvh
    f32 = torch.float32
    dev = q.device
    nq, nk = -(-sq // q_chunk), -(-skv // kv_chunk)

    qp = _pad_rows(q, nq * q_chunk - sq)
    kp = _pad_rows(k, nk * kv_chunk - skv)
    vp = _pad_rows(v, nk * kv_chunk - skv)
    # the scale rounded to q's dtype first, as a weakly typed constant is
    scale = torch.tensor(hd ** -0.5, dtype=q.dtype, device=dev)
    qs = qp.reshape(b, nq, q_chunk, kvh, grp, hd) * scale
    ks = kp.reshape(b, nk, kv_chunk, kvh, hd)
    vs = vp.reshape(b, nk, kv_chunk, kvh, hd)
    q_pos_base = torch.arange(q_chunk, device=dev)
    k_pos_base = torch.arange(kv_chunk, device=dev)

    outs = []
    for qi in range(nq):
        qc = qs[:, qi].to(f32)
        # online softmax state: (out, running max, running denominator)
        o = torch.zeros((b, q_chunk, kvh, grp, hd), dtype=f32, device=dev)
        m = torch.full((b, q_chunk, kvh, grp), NEG_INF, dtype=f32,
                       device=dev)
        d = torch.zeros((b, q_chunk, kvh, grp), dtype=f32, device=dev)
        qpos = qi * q_chunk + q_pos_base + q_offset
        for ki in range(nk):
            s_blk = torch.einsum("bqhgd,bkhd->bqhgk", qc, ks[:, ki].to(f32))
            kpos = ki * kv_chunk + k_pos_base
            mask = (kpos < skv)[None, :]                     # pad mask
            if causal:
                mask = mask & (kpos[None, :] <= qpos[:, None])
            if window > 0:
                mask = mask & (kpos[None, :] > qpos[:, None] - window)
            s_blk = torch.where(mask[None, :, None, None, :], s_blk, NEG_INF)
            m_new = torch.maximum(m, s_blk.amax(dim=-1))
            p = torch.exp(s_blk - m_new[..., None])
            corr = torch.exp(m - m_new)
            d = d * corr + p.sum(dim=-1)
            if p_bf16:
                p = p.to(torch.bfloat16).to(f32)
            o = o * corr[..., None] + torch.einsum(
                "bqhgk,bkhd->bqhgd", p, vs[:, ki].to(f32))
            m = m_new
        outs.append(o / torch.clamp(d[..., None], min=1e-30))
    out = torch.stack(outs, dim=1).reshape(b, nq * q_chunk, h, hd)
    return out[:, :sq].to(q.dtype)


class _Attention(torch.autograd.Function):
    """Forward: the flash kernel. Backward: the gradient of
    ``chunked_attention`` on the saved q, k, v (on a mesh, on each rank's
    shards)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        return ops.flash_attention(q, k, v, causal=causal, window=window)

    @staticmethod
    def backward(ctx, grad_out):
        need = ctx.needs_input_grad[:3]
        saved = ctx.saved_tensors
        if is_dtensor(grad_out):
            return (*_local_backward(ctx, saved, grad_out, need), None, None)
        return (*_backward(ctx, saved, grad_out, need), None, None)


def _backward(ctx, saved, grad_out, need):
    """The gradient of ``chunked_attention`` at the saved q, k, v."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(n) for t, n in zip(saved, need)]
        out = chunked_attention(*ins, causal=ctx.causal, window=ctx.window)
        grads = iter(torch.autograd.grad(
            out, [t for t, n in zip(ins, need) if n], grad_out))
    return tuple(next(grads) if n else None for n in need)


def _local_backward(ctx, saved, grad_out, need):
    """The backward on a mesh, shard by shard: attention is independent
    over the batch and over whole GQA groups of heads, so q, k, v and the
    output's gradient are placed alike (the flash operator's rule: each
    mesh dim keeps a batch shard, or a head shard where H and KVH divide
    by the mesh, and replicates otherwise) and ``_backward`` runs on each
    rank's local tensors. DTensor's op-by-op rules are not entered."""
    from torch.distributed.tensor import Replicate, Shard

    q, k = saved[0], saved[1]
    mesh = q.device_mesh
    heads = q.shape[2] % mesh.size() == 0 and k.shape[2] % mesh.size() == 0
    pl = tuple(p if isinstance(p, Shard) and (p.dim == 0 or (
        p.dim == 2 and heads)) else Replicate() for p in q.placements)
    loc = [t.redistribute(mesh, pl).to_local() for t in (*saved, grad_out)]
    grads = _backward(ctx, loc[:3], loc[3], need)
    return tuple(None if g is None else from_local(g, mesh, pl, t.shape)
                 for g, t in zip(grads, saved))


def _row_offset(x, dim: int) -> int:
    """The global index of this rank's first element along ``dim`` of a
    DTensor: each mesh dim that shards ``dim`` splits the piece before it
    as ``torch.chunk`` does, in mesh order."""
    from torch.distributed.tensor import Shard

    mesh, coord = x.device_mesh, x.device_mesh.get_coordinate()
    size, off = x.shape[dim], 0
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim == dim:
            chunk = -(-size // mesh.size(i))
            start = min(coord[i] * chunk, size)
            off, size = off + start, max(0, min(chunk, size - start))
    return off


def sharded_chunked_attention(q, k, v, **kw) -> torch.Tensor:
    """``chunked_attention``; on a mesh, run on each rank's shards. q keeps
    its batch, row (sequence-parallel attention) and whole-GQA-group head
    shards, k and v the same batch and head shards and every key; each
    rank attends its rows at their global offset (``q_offset``), and the
    partial key gradients of a row-sharded q are summed by DTensor."""
    if not is_dtensor(q):
        return chunked_attention(q, k, v, **kw)
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = q.device_mesh
    heads = q.shape[2] % mesh.size() == 0 and k.shape[2] % mesh.size() == 0
    qpl = tuple(p if isinstance(p, Shard) and (p.dim in (0, 1) or (
        p.dim == 2 and heads)) else Replicate() for p in q.placements)
    kvpl = tuple(Replicate() if isinstance(p, Shard) and p.dim == 1 else p
                 for p in qpl)
    grads = [Partial() if isinstance(p, Shard) and p.dim == 1 else kp
             for p, kp in zip(qpl, kvpl)]
    q = q.redistribute(mesh, qpl)
    k, v = (t.redistribute(mesh, kvpl).to_local(grad_placements=grads)
            for t in (k, v))
    out = chunked_attention(q.to_local(), k, v,
                            q_offset=kw.pop("q_offset", 0)
                            + _row_offset(q, 1), **kw)
    return from_local(out, mesh, qpl, q.shape)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0) -> torch.Tensor:
    """The differentiable attention of the models' forward: q (b, sq, h,
    hd) against k, v (b, skv, kvh, hd) through the flash kernel, with
    ``chunked_attention``'s gradient. Returns q's shape and dtype."""
    return _Attention.apply(q, k, v, causal, window)


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
