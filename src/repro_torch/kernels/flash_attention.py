"""The flash-attention kernel (``csrc/flash_attention.cu``) and its plain
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
it. The kernel is a simple first design on CUDA cores in f32 (ceiling 3.6 ms
for that work); see the source for its layout.

``flash_attention_plain`` repeats the kernel's arithmetic by tiles of
``BLOCK_K[D]`` keys (the kernel's own tile), so its memory is one tile of
scores for all queries at once. The kernel skips tiles that no row of a
query block can see; they change nothing (their weight is an exact 0), and
the plain version computes them.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
# keys a tile, by head dim; csrc/flash_attention.cu::block_k holds the same
BLOCK_K = {16: 64, 32: 64, 64: 64, 128: 32, 256: 32}
DTYPES = (torch.float32, torch.bfloat16)

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
    if d not in BLOCK_K:
        raise ValueError(f"head dim {d} not supported (one of "
                         f"{sorted(BLOCK_K)})")
    if kvh == 0 or h % kvh:
        raise ValueError(f"{h} query heads do not group over {kvh} KV heads")
    if tuple(k.shape) != (b, skv, kvh, d) or v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must be "
                         f"({b}, Skv, KVH, {d})")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share one dtype of {DTYPES}; got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    return b, sq, h, d, skv, kvh


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          window: int = 0) -> torch.Tensor:
    """Plain version: the kernel's arithmetic by key tiles. q (B, Sq, H, D),
    k, v (B, Skv, KVH, D) -> (B, Sq, H, D) in q's dtype."""
    b, sq, h, d, skv, kvh = _shapes(q, k, v)
    grp = h // kvh
    bk = BLOCK_K[d]
    f32 = torch.float32
    dev = q.device
    qf = (q.to(f32) * d ** -0.5).reshape(b, sq, kvh, grp, d)
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
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        o = o * corr[..., None] + torch.einsum("bqhgk,bkhd->bqhgd", p, vc)
        m = m_new
    out = o / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, sq, h, d).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """CUDA kernel: same arguments and result as ``flash_attention_plain``."""
    _build.require_cuda(q, "flash_attention")
    b, sq, h, d, skv, kvh = _shapes(q, k, v)
    for name, t in (("q", q), ("k", k), ("v", v)):
        _build.require(t, name, q.dtype, tuple(t.shape), q.device)
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
