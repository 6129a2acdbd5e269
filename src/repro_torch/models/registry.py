"""Model registry: the uniform (init / forward / cache / decode) API per
arch (the port of ``repro.models.registry``), for every kind: the
decoder-only families through ``models.lm``, the encoder-decoder through
``models.whisper``."""

from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.models import lm, whisper
from repro_torch.models.common import ModelConfig, require_kind


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init_params: Callable          # (gen) -> params
    forward: Callable              # (params, tokens, aux_input) -> (hidden, aux)
    logits: Callable               # (params, hidden) -> logits
    init_cache: Callable           # (batch, s_max, device) -> cache
    decode_step: Callable          # (params, token, cache, pos) -> (logits, cache)
    has_decode: bool = True


def build(cfg: ModelConfig) -> Model:
    require_kind(cfg)
    mod = whisper if cfg.kind == "encdec" else lm
    return Model(
        cfg=cfg,
        init_params=lambda gen: mod.init_params(cfg, gen),
        forward=lambda p, tokens, aux=None: mod.forward(cfg, p, tokens, aux),
        logits=lambda p, h: lm.logits_fn(cfg, p, h),
        init_cache=lambda b, s, device="cuda": mod.init_cache(cfg, b, s,
                                                              device),
        decode_step=lambda p, t, c, pos: mod.decode_step(cfg, p, t, c, pos),
    )
