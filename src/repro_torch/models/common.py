"""Shared model machinery: config, norms, RoPE, initializers (the port of
``repro.models.common``).

The reference stacks per-layer parameters along a leading ``L`` axis and
scans over it; the port keeps the stacked dict and runs a Python loop over
layers. ``constrain`` is not ported: it is a no-op without a mesh, and a
config that names a tensor-parallel axis raises.
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Any

import torch
import torch.nn.functional as F

# the families and options the port does not run yet: ROADMAP queue 1, item 14
NOT_PORTED = "not ported yet (ROADMAP queue 1, item 14, the LM substrate)"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch: str
    kind: str                      # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    d_ff: int
    vocab: int
    n_kv_heads: int | None = None
    head_dim: int | None = None    # gemma overrides to 256
    ffn_act: str = "swiglu"        # swiglu | geglu (gated); gelu (plain)
    qkv_bias: bool = False         # qwen2 family
    pos: str = "rope"              # rope | sinusoidal
    rope_theta: float = 1e4
    tie_embeddings: bool = False
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
    # --- hybrid (recurrentgemma): block pattern repeated over depth ---
    pattern: tuple[str, ...] = ()  # e.g. ("rglru", "rglru", "attn")
    local_window: int = 0          # sliding-window size for local attention
    rglru_d_rnn: int = 0           # width of the recurrent branch
    # --- ssm (mamba2) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    ssm_expand: int = 2
    # --- encoder-decoder (whisper) ---
    enc_layers: int = 0
    enc_seq: int = 0               # encoder context length (1500 frames)
    # --- modality frontend stub ---
    frontend: str | None = None    # audio_stub | vision_stub
    frontend_tokens: int = 0       # prefix length supplied by input_specs
    # --- numerics ---
    dtype: Any = torch.bfloat16
    norm_eps: float = 1e-6
    # --- performance knobs of the reference (defaults = faithful
    #     baseline); tp_axis needs a mesh, which the port does not have ---
    tp_axis: str | None = None
    tp_size: int = 0
    dp_axes: tuple[str, ...] = ()
    moe_group: int = 0
    attn_p_bf16: bool = False  # cast softmax probs to bf16 for the PV matmul
    attn_dp_only: bool = False

    def __post_init__(self):
        if self.tp_axis is not None:
            raise NotImplementedError(f"tp_axis={self.tp_axis!r}: tensor "
                                      f"parallelism is {NOT_PORTED}")

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    def num_params(self) -> int:
        """Analytic parameter count (the dense family's)."""
        require_dense(self)
        d, ff, v, hd = self.d_model, self.d_ff, self.vocab, self.hd
        h, kv = self.n_heads, self.kv_heads
        attn = d * h * hd + 2 * d * kv * hd + h * hd * d
        if self.ffn_act in ("swiglu", "geglu"):
            ffn = 3 * d * ff
        else:
            ffn = 2 * d * ff
        total = self.n_layers * (attn + ffn + 2 * d) + v * d
        if not self.tie_embeddings:
            total += v * d
        return total

    def num_active_params(self) -> int:
        """Active params per token: all of them in the dense family."""
        return self.num_params()


DENSE_KINDS = ("dense", "vlm")


def require_dense(cfg: ModelConfig) -> None:
    if cfg.kind not in DENSE_KINDS:
        raise NotImplementedError(f"model kind {cfg.kind!r} ({cfg.arch}) is "
                                  f"{NOT_PORTED}; the port runs "
                                  f"{DENSE_KINDS}")


# ------------------------------------------------------------------ layers
def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """x * rsqrt(mean(x^2) + eps) * (1 + scale), in f32, back to x's dtype."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + scale.to(torch.float32))
    return out.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding. x: (..., s, h, hd); positions: (..., s). Angles in
    f32; x * cos promotes bf16 to f32, and the result is cast back."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = positions[..., None].to(torch.float32) * freqs
    angles = angles[..., None, :]                           # head axis
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(n: int, d: int, device=None) -> torch.Tensor:
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(10000.0, dim / d)
    pe = torch.zeros((n, d), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(ang)
    pe[:, 1::2] = torch.cos(ang[:, : d // 2])
    return pe


def dense_init(gen: torch.Generator, shape: tuple[int, ...], dtype,
               fan_in: int | None = None) -> torch.Tensor:
    """Normal(0, 1/fan_in) drawn in f32 on the generator's device."""
    fan = (fan_in if fan_in is not None
           else shape[-2] if len(shape) > 1 else shape[-1])
    std = 1.0 / math.sqrt(fan)
    return (torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=gen.device) * std).to(dtype)


# jax.nn.gelu defaults to the tanh approximation; torch's gelu to erf
_gelu = partial(F.gelu, approximate="tanh")


def act_fn(name: str):
    return {"swiglu": F.silu, "geglu": _gelu, "gelu": _gelu,
            "silu": F.silu}[name]
