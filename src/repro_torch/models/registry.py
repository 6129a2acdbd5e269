"""Model registry: the uniform (init / forward / cache / decode) API per
arch (the port of ``repro.models.registry``). Only the dense family is
ported; ``build`` raises on the others (the encoder-decoder whisper
included)."""

from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.models import lm
from repro_torch.models.common import ModelConfig


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init_params: Callable          # (gen) -> params
    forward: Callable              # (params, tokens, aux_input) -> (hidden, aux)
    logits: Callable               # (params, hidden) -> logits
    init_cache: Callable           # (batch, s_max, device) -> cache
    decode_step: Callable          # (params, token, cache, pos) -> (logits, cache)


def build(cfg: ModelConfig) -> Model:
    lm.require_dense(cfg)
    return Model(
        cfg=cfg,
        init_params=lambda gen: lm.init_params(cfg, gen),
        forward=lambda p, tokens, aux=None: lm.forward(cfg, p, tokens, aux),
        logits=lambda p, h: lm.logits_fn(cfg, p, h),
        init_cache=lambda b, s, device="cuda": lm.init_cache(cfg, b, s,
                                                             device),
        decode_step=lambda p, t, c, pos: lm.decode_step(cfg, p, t, c, pos),
    )
