"""Serving: prefill and single-token decode steps (the port of
``repro.train.serve_step``), for every kind: the encoder-decoder through
``models.whisper``, the others through ``models.lm``.

``make_prefill`` is the full forward over a prompt: its attention is the
flash-attention kernel, one launch an attention (the encoder-decoder's
forward runs its encoder too, and takes the frames as its aux input).
``make_serve_step`` is one new token against the decode cache (KV rows or
recurrent state), with greedy argmax sampling.
"""

from __future__ import annotations

import torch

from repro_torch.models import lm, whisper
from repro_torch.models.common import ModelConfig, require_kind
from repro_torch.sharding import rules


def _module(cfg: ModelConfig):
    require_kind(cfg)
    return whisper if cfg.kind == "encdec" else lm


def make_serve_step(cfg: ModelConfig):
    """Returns serve(params, token, cache, pos) -> (next_token, cache)."""
    mod = _module(cfg)

    def serve(params, token, cache, pos):
        logits, cache = mod.decode_step(cfg, params, token, cache, pos)
        # a vocab-sharded DTensor is gathered first: DTensor's argmax
        # cannot reduce over a sharded dim
        last = rules.replicate_dims(logits[:, -1, :], (-1,))
        nxt = torch.argmax(last, dim=-1).to(torch.int32)
        return nxt[:, None], cache

    return serve


def make_prefill(cfg: ModelConfig):
    """Returns prefill(params, tokens, aux) -> (hidden, aux_loss): the full
    forward at the prompt's length."""
    mod = _module(cfg)

    def prefill(params, tokens, aux=None):
        return mod.forward(cfg, params, tokens, aux)

    return prefill
