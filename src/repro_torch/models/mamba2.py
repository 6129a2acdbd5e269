"""Mamba-2 SSD (state-space duality) layer, chunked (the port of
``repro.models.mamba2``; arXiv:2405.21060).

The sequence is split into chunks of length Q; within a chunk the output is
a decay-weighted, causally masked product (attention-like), across chunks a
small state per head (b, h, n, p) is carried by a loop of s / Q steps.

Layout: x (b, s, d) -> in_proj -> [z (d_in) | xc (d_in) | B (n) | C (n) |
dt (h)] with d_in = expand * d, heads h = d_in / head_dim, B/C shared
across heads. A depthwise causal conv (width 4) precedes the SSM on
(xc|B|C). Decode carries (ssm_state (b, h, n, p), conv_state (b, 3,
conv_dim)).

The reference's three-operand einsums are written as two products each,
in an order that makes no intermediate larger than the reference's
operands or result. Above the diagonal, a chunk's log-decay difference is
masked to -inf before the exp, so no inf is ever formed.
"""

from __future__ import annotations

import torch

from repro_torch.models.common import reshape

CONV_W = 4


def _depthwise_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Causal depthwise conv. x: (b, s, c), w: (CONV_W, c)."""
    pads = torch.nn.functional.pad(x, (0, 0, CONV_W - 1, 0))
    return sum(pads[:, i: i + x.shape[1], :] * w[i] for i in range(CONV_W))


def ssd_chunked(xh: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                b_mat: torch.Tensor, c_mat: torch.Tensor, chunk: int,
                h0: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.

    xh: (b, s, h, p) inputs; dt: (b, s, h) positive step sizes; a_log: (h,)
    log-decay parameter (A = -exp(a_log)); b_mat, c_mat: (b, s, n).
    Returns (y (b, s, h, p) f32, final_state (b, h, n, p) f32).
    """
    bsz, s, nh, p = xh.shape
    n = b_mat.shape[-1]
    q = chunk
    if s % q:
        raise ValueError(f"sequence length {s} is no multiple of the SSD "
                         f"chunk {q}")
    nc = s // q
    f32 = torch.float32

    a = -torch.exp(a_log.to(f32))                            # (h,)
    dta = dt.to(f32) * a                                     # (b, s, h)
    xbar = xh.to(f32) * dt.to(f32)[..., None]

    dta_c = reshape(dta, bsz, nc, q, nh)
    x_c = reshape(xbar, bsz, nc, q, nh, p)
    b_c = reshape(b_mat.to(f32), bsz, nc, q, n)
    c_c = reshape(c_mat.to(f32), bsz, nc, q, n)

    cum = torch.cumsum(dta_c, dim=2)                         # (b, nc, q, h)
    total = cum[:, :, -1:, :]                                # (b, nc, 1, h)

    # ---- intra-chunk: L[i, j] = exp(cum_i - cum_j) for i >= j else 0
    li = cum[:, :, :, None, :] - cum[:, :, None, :, :]       # (b,nc,q,q,h)
    mask = torch.ones((q, q), dtype=torch.bool, device=xh.device).tril()
    decay = torch.exp(li.masked_fill(~mask[:, :, None], float("-inf")))
    scores = torch.einsum("bcin,bcjn->bcij", c_c, b_c)       # (b,nc,q,q)
    # "bcij,bcijh,bcjhp->bcihp"
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", scores[..., None] * decay,
                           x_c)

    # ---- per-chunk outgoing state, "bcjn,bcjh,bcjhp->bchnp"
    w_out = torch.exp(total - cum)                           # (b, nc, q, h)
    s_c = torch.einsum("bcjn,bcjhp->bchnp", b_c, w_out[..., None] * x_c)

    # ---- inter-chunk recurrence over nc: the state entering each chunk
    chunk_decay = torch.exp(total[:, :, 0, :])               # (b, nc, h)
    h = (torch.zeros((bsz, nh, n, p), dtype=f32, device=xh.device)
         if h0 is None else h0)
    h_in = []
    for c in range(nc):
        h_in.append(h)
        h = h * chunk_decay[:, c, :, None, None] + s_c[:, c]
    h_in = torch.stack(h_in, dim=1)                          # (b,nc,h,n,p)

    # ---- inter-chunk contribution, "bcqn,bcqh,bchnp->bcqhp"
    w_in = torch.exp(cum)                                    # (b, nc, q, h)
    y_inter = torch.einsum("bcqn,bchnp->bcqhp", c_c, h_in) * w_in[..., None]

    y = reshape(y_intra + y_inter, bsz, s, nh, p)
    return y, h


def ssd_decode_step(xh: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                    b_mat: torch.Tensor, c_mat: torch.Tensor,
                    state: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Single-token SSD update. xh: (b, 1, h, p); dt: (b, 1, h) f32;
    state: (b, h, n, p) f32. Returns (y (b, 1, h, p), new state)."""
    f32 = torch.float32
    a = -torch.exp(a_log.to(f32))
    dec = torch.exp(dt[:, 0].to(f32) * a)                    # (b, h)
    xbar = xh[:, 0].to(f32) * dt[:, 0][..., None]
    s_new = torch.einsum("bn,bhp->bhnp", b_mat[:, 0].to(f32), xbar)
    state = state * dec[..., None, None] + s_new
    y = torch.einsum("bn,bhnp->bhp", c_mat[:, 0].to(f32), state)
    return y[:, None], state
