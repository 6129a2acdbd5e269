"""Serving: prefill and single-token decode steps (the port of
``repro.train.serve_step``), for the dense family; the others raise.

``make_prefill`` is the full forward over a prompt: its attention is the
flash-attention kernel, one launch a layer. ``make_serve_step`` is one new
token against the KV cache, with greedy argmax sampling.
"""

from __future__ import annotations

import torch

from repro_torch.models import lm
from repro_torch.models.common import ModelConfig


def make_serve_step(cfg: ModelConfig):
    """Returns serve(params, token, cache, pos) -> (next_token, cache)."""
    lm.require_dense(cfg)

    def serve(params, token, cache, pos):
        logits, cache = lm.decode_step(cfg, params, token, cache, pos)
        nxt = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        return nxt[:, None], cache

    return serve


def make_prefill(cfg: ModelConfig):
    """Returns prefill(params, tokens, aux) -> (hidden, aux_loss): the full
    forward at the prompt's length."""
    lm.require_dense(cfg)

    def prefill(params, tokens, aux=None):
        return lm.forward(cfg, params, tokens, aux)

    return prefill
