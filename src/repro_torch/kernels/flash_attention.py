"""The flash-attention kernels (``csrc/flash_attention.cu``) and their plain
PyTorch version.

Replaces the TPU kernel ``src/repro/kernels/flash_attention.py::_flash_kernel``
(launched by ``flash_attention_pallas``): softmax(q k^T * D^-1/2, masked) v by
an online softmax with f32 (o, m, l), causal and/or windowed, masked scores
at NEG_INF = -1e30. It computes the function of the reference's
``models/attention.py::chunked_attention`` (with ``q_offset=0``) and serves
the prefill attention of ``models/lm._attn_apply``: one launch a layer.

Layout: q (B, Sq, H, D), k and v (B, Skv, KVH, D), the model's own, with
query head h reading KV head h // (H // KVH); no transpose, no repeat. D is
16, 32, 64, 128 or 256 (the configs' head dims, smoke sizes included);
inputs and output are all f32 or all bf16; Sq and Skv may be any length
(keys from Skv on are masked, rows from Sq on are not stored).

Bound on the H100 at the main-path shape (B 8, S 4096, H 14, KVH 2, D 64,
causal, bf16): 240.6 GFLOP take 0.243 ms at 989 TFLOP/s of bf16 tensor
cores (134 MB of q, k, v, o take 0.040 ms at 3.35 TB/s), so compute bounds
it. bf16 inputs run on tensor cores (``wgmma``, K/V by TMA through an
mbarrier ring, a producer warpgroup beside two consumers); f32 inputs on
CUDA cores in f32, the correctness route. See the source for both designs.

``flash_attention_plain`` repeats the kernel's arithmetic for the input's
dtype by tiles of ``BLOCK_K[(dtype, D)]`` keys (the kernel's own tile), so
its memory is one tile of scores for all queries at once:

- f32: q cast to f32 and scaled, scores q.k, p = exp(s - m_new);
- bf16: scores q.k of the bf16 inputs (exact products), the scale applied
  after the product and folded with log2(e) into p = exp2(s*c - m_new*c)
  (a row masked so far takes c = 0, so p = 1), and P V as
  ``split_p(p)``'s two bf16 halves, each product in f32.

The kernel skips tiles that no row of a query block can see; they change
nothing (their weight is an exact 0), and the plain version computes them.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128, 256)
DTYPES = (torch.float32, torch.bfloat16)
# keys a tile by (dtype, head dim): csrc/flash_attention.cu's block_k (f32)
# and MmaTile<D>::BK (bf16) hold the same numbers
BLOCK_K = {**{(torch.float32, d): 64 if d <= 64 else 32 for d in HEAD_DIMS},
           **{(torch.bfloat16, d): 128 if d == 64 else 64
              for d in HEAD_DIMS}}

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
             ctypes.c_float, _P]


def _shapes(q, k, v):
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q must be (B, Sq, H, D) and k, v (B, Skv, KVH, D);"
                         f" got {tuple(q.shape)} and {tuple(k.shape)}")
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported (one of "
                         f"{list(HEAD_DIMS)})")
    if kvh == 0 or h % kvh:
        raise ValueError(f"{h} query heads do not group over {kvh} KV heads")
    if tuple(k.shape) != (b, skv, kvh, d) or v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must be "
                         f"({b}, Skv, KVH, {d})")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share one dtype of {DTYPES}; got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    return b, sq, h, d, skv, kvh


def split_p(p: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 p as two bf16 halves (returned in f32): hi = bf16(p) and lo =
    bf16(p - hi), so hi + lo = p within about 2^-17 relative. The bf16
    kernel feeds P V with both, two products into one f32 sum."""
    hi = p.to(torch.bfloat16).float()
    return hi, (p - hi).to(torch.bfloat16).float()


def attention_f32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0) -> torch.Tensor:
    """The plain version's f32 result, before the output's rounding to q's
    dtype."""
    b, sq, h, d, skv, kvh = _shapes(q, k, v)
    grp = h // kvh
    tensor_cores = q.dtype == torch.bfloat16
    bk = BLOCK_K[(q.dtype, d)]
    f32 = torch.float32
    dev = q.device
    qf = q.to(f32)
    if not tensor_cores:
        qf = qf * d ** -0.5
    qf = qf.reshape(b, sq, kvh, grp, d)
    # c = D^-1/2 * log2(e), rounded as the bf16 kernel's launcher rounds it
    c = float(np.float32(d ** -0.5) * np.float32(math.log2(math.e)))
    o = torch.zeros(b, sq, kvh, grp, d, dtype=f32, device=dev)
    m = torch.full((b, sq, kvh, grp), NEG_INF, dtype=f32, device=dev)
    l = torch.zeros(b, sq, kvh, grp, dtype=f32, device=dev)
    qpos = torch.arange(sq, device=dev)[:, None]
    for k0 in range(0, skv, bk):
        # a ragged last tile is padded with zero keys and values, masked
        kc = torch.zeros(b, bk, kvh, d, dtype=f32, device=dev)
        vc = torch.zeros(b, bk, kvh, d, dtype=f32, device=dev)
        kc[:, :skv - k0] = k[:, k0:k0 + bk]
        vc[:, :skv - k0] = v[:, k0:k0 + bk]
        s = torch.einsum("bqhgd,bkhd->bqhgk", qf, kc)
        kpos = k0 + torch.arange(bk, device=dev)[None, :]
        mask = kpos < skv
        if causal:
            mask = mask & (kpos <= qpos)
        if window > 0:
            mask = mask & (kpos > qpos - window)
        s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        if tensor_cores:
            cs = torch.where(m_new == NEG_INF, 0.0, c)
            mc = m_new * cs
            p = torch.exp2(s * cs[..., None] - mc[..., None])
            corr = torch.exp2(m * cs - mc)
            hi, lo = split_p(p)
            o = (o * corr[..., None]
                 + torch.einsum("bqhgk,bkhd->bqhgd", hi, vc)
                 + torch.einsum("bqhgk,bkhd->bqhgd", lo, vc))
        else:
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            o = o * corr[..., None] + torch.einsum("bqhgk,bkhd->bqhgd", p, vc)
        l = l * corr + p.sum(dim=-1)
        m = m_new
    out = o / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, sq, h, d)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          window: int = 0) -> torch.Tensor:
    """Plain version: the kernel's arithmetic by key tiles. q (B, Sq, H, D),
    k, v (B, Skv, KVH, D) -> (B, Sq, H, D) in q's dtype."""
    return attention_f32(q, k, v, causal=causal, window=window).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """CUDA kernel: same arguments and result as ``flash_attention_plain``."""
    _build.require_cuda(q, "flash_attention")
    b, sq, h, d, skv, kvh = _shapes(q, k, v)
    for name, t in (("q", q), ("k", k), ("v", v)):
        _build.require(t, name, q.dtype, tuple(t.shape), q.device)
        if q.dtype == torch.bfloat16 and t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary (a "
                             f"TMA tensor map's base)")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if h > 65535 or b > 65535:
        raise ValueError(f"grid too large: {h} heads x batch {b}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    fn = _build.function("flash_attention", "flash_attention", _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq,
             skv, h, kvh, d, int(q.dtype == torch.bfloat16), int(causal),
             window, d ** -0.5, _build.stream_of(q))
    flash_attention.launches += 1
    _build.check_launch(err, "flash_attention")
    return out


flash_attention.launches = 0


def kernel_attributes(d: int, dtype: torch.dtype) -> dict[str, int]:
    """The compiled kernel for head dim ``d`` and ``dtype`` (needs the card):
    registers a thread, local memory a thread (spills and stack), static
    and dynamic shared memory a block, in bytes."""
    fn = _build.function("flash_attention", "flash_attention_attributes",
                         [_I, _I, ctypes.POINTER(_I)])
    out = (_I * 4)()
    _build.check_launch(fn(d, int(dtype == torch.bfloat16), out),
                        "flash_attention_attributes")
    return dict(zip(("registers", "local_bytes", "static_smem",
                     "dynamic_smem"), out))
