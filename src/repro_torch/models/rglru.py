"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427; the
port of ``repro.models.rglru``).

The Real-Gated Linear Recurrent Unit:

    r_t = sigmoid(x_t W_a)                  (recurrence gate)
    i_t = sigmoid(x_t W_x)                  (input gate)
    log a_t = -c * softplus(Lambda) * r_t   (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

A prompt runs as a log-depth scan over the (a, b) pairs in f32, where the
reference calls ``lax.associative_scan``: the same combine, in another
tree, so the two round differently (``scan_pairs``). Decode is a one-step
update carrying h.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

RG_C = 8.0
CONV_W = 4


def scan_pairs(a: torch.Tensor, b: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan along axis 1 of the pairs (a_t, b_t) under
    (a1, b1) . (a2, b2) = (a1 a2, a2 b1 + b2): returns (prod_{s<=t} a_s,
    h_t) with h_t = a_t h_{t-1} + b_t from h_{-1} = 0. Hillis-Steele
    doubling: ceil(log2 s) steps over the whole sequence."""
    s = a.shape[1]
    off = 1
    while off < s:
        a_prev, b_prev = a[:, :-off], b[:, :-off]
        b = torch.cat([b[:, :off], a[:, off:] * b_prev + b[:, off:]], dim=1)
        a = torch.cat([a[:, :off], a[:, off:] * a_prev], dim=1)
        off *= 2
    return a, b


def _gates(gate_x, gate_a, lam):
    f32 = torch.float32
    r = torch.sigmoid(gate_a.to(f32))
    i = torch.sigmoid(gate_x.to(f32))
    log_a = -RG_C * F.softplus(lam.to(f32)) * r
    # sqrt(1 - a^2) computed stably via expm1: 1 - exp(2 log a)
    return torch.exp(log_a), torch.sqrt(-torch.expm1(2.0 * log_a)), i


def rg_lru(x: torch.Tensor, gate_x: torch.Tensor, gate_a: torch.Tensor,
           lam: torch.Tensor, h0: torch.Tensor | None = None
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """x, gates: (b, s, d_rnn); lam: (d_rnn,). Returns (y in x's dtype,
    h_last in f32)."""
    a, mult, i = _gates(gate_x, gate_a, lam)
    gated = mult * i * x.to(torch.float32)
    a_scan, y = scan_pairs(a, gated)
    if h0 is not None:
        # fold the carried state into every step: h_t += (prod a_{<=t}) h0
        y = y + a_scan * h0[:, None, :]
    return y.to(x.dtype), y[:, -1, :]


def rg_lru_step(x: torch.Tensor, gate_x: torch.Tensor, gate_a: torch.Tensor,
                lam: torch.Tensor, h: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """One decode step. x, gates: (b, 1, d_rnn); h: (b, d_rnn) f32."""
    a, mult, i = _gates(gate_x[:, 0], gate_a[:, 0], lam)
    h_new = a * h + mult * i * x[:, 0].to(torch.float32)
    return h_new[:, None, :].to(x.dtype), h_new


def causal_conv(x: torch.Tensor, w: torch.Tensor,
                state: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv, width CONV_W. x: (b, s, c); w: (CONV_W, c);
    state: (b, CONV_W-1, c), the trailing context of the previous call
    (decode). Returns (y, new_state)."""
    b, s, c = x.shape
    if state is None:
        state = torch.zeros((b, CONV_W - 1, c), dtype=x.dtype,
                            device=x.device)
    ext = torch.cat([state, x], dim=1)
    y = sum(ext[:, i: i + s, :] * w[i] for i in range(CONV_W))
    return y, ext[:, -(CONV_W - 1):, :]
