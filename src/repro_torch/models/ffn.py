"""Feed-forward blocks: gated (SwiGLU/GeGLU) and plain MLP (the port of
``repro.models.ffn``). The products are plain ``torch.matmul``: the
reference computes them outside any Pallas kernel."""

from __future__ import annotations

import torch

from repro_torch.models.common import act_fn


def gated_ffn(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
              w_down: torch.Tensor, act: str) -> torch.Tensor:
    """SwiGLU (llama/qwen) or GeGLU (gemma): act(x W_g) * (x W_u) W_d."""
    f = act_fn(act)
    g = f(torch.matmul(x, w_gate))
    u = torch.matmul(x, w_up)
    return torch.matmul(g * u, w_down)


def plain_ffn(x: torch.Tensor, w_up: torch.Tensor, b_up: torch.Tensor,
              w_down: torch.Tensor, b_down: torch.Tensor,
              act: str) -> torch.Tensor:
    """Whisper-style 2-matrix MLP with biases."""
    f = act_fn(act)
    h = f(torch.matmul(x, w_up) + b_up)
    return torch.matmul(h, w_down) + b_down
