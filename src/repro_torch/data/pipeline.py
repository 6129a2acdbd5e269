"""Deterministic synthetic data pipeline, sharded per host (the port of
``repro.data.pipeline``).

Every batch is a pure function of (seed, step, shard): each shard draws
from its own ``torch.Generator``, seeded from the three numbers, so a
restarted or replaced host regenerates exactly its shard for any step with
no coordination, a checkpoint needs no data cursor beyond the step, and
elastic resharding is re-indexing. The draws run on the CPU and the batch
is then moved to ``device``, so a batch is the same on every device.

torch cannot reproduce ``jax.random``'s threefry stream, so the port's
batches are not the reference's; the tests pass the reference's batches
into both packages, and hold this stream to the reference's properties
(deterministic, steps differ, shard i reproducible in isolation, the
shapes and dtypes of each kind).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.common import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 1234
    global_batch: int = 8
    seq_len: int = 128
    num_shards: int = 1          # data-parallel host shards


def shard_batch_size(cfg: DataConfig) -> int:
    if cfg.global_batch % cfg.num_shards:
        raise ValueError(f"global batch {cfg.global_batch} does not split "
                         f"over {cfg.num_shards} shards")
    return cfg.global_batch // cfg.num_shards


def _generator(seed: int, step: int, shard: int) -> torch.Generator:
    mixed = np.random.SeedSequence((seed, step, shard)).generate_state(
        1, np.uint64)[0]
    return torch.Generator().manual_seed(int(mixed))


def synthetic_shard(cfg: DataConfig, mcfg: ModelConfig, step: int,
                    shard: int, device="cuda") -> dict:
    """One host shard of the global batch for ``step`` (a pure function):
    ``tokens`` (bs, s) int32, and for the encoder-decoder and the vlm the
    stub frontend's ``frontend``, 0.1 x normal f32 (frames (bs, enc_seq,
    d); prefix embeddings (bs, frontend_tokens, d), the tokens shortened
    by as many)."""
    dev = resolve_device(device)
    gen = _generator(cfg.seed, step, shard)
    bs = shard_batch_size(cfg)
    s = cfg.seq_len
    if mcfg.kind == "vlm" and mcfg.frontend_tokens:
        s = s - mcfg.frontend_tokens
    out = {"tokens": torch.randint(0, mcfg.vocab, (bs, s), generator=gen,
                                   dtype=torch.int32)}
    if mcfg.kind == "encdec":
        out["frontend"] = 0.1 * torch.randn(
            (bs, mcfg.enc_seq, mcfg.d_model), generator=gen)
    elif mcfg.kind == "vlm" and mcfg.frontend_tokens:
        out["frontend"] = 0.1 * torch.randn(
            (bs, mcfg.frontend_tokens, mcfg.d_model), generator=gen)
    return {k: v.to(dev) for k, v in out.items()}


def synthetic_batch(cfg: DataConfig, mcfg: ModelConfig, step: int,
                    device="cuda") -> dict:
    """The full global batch (the single-process form: all shards)."""
    shards = [synthetic_shard(cfg, mcfg, step, i, device)
              for i in range(cfg.num_shards)]
    return {k: torch.cat([s[k] for s in shards], dim=0) for k in shards[0]}
