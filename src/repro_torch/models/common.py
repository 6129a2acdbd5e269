"""Shared model machinery: config, norms, RoPE, initializers (the port of
``repro.models.common``).

The reference stacks per-layer parameters along a leading ``L`` axis and
scans over it; the port keeps the stacked dict and runs a Python loop over
layers. On a mesh the parameters are DTensors (``sharding.rules``):
``constrain`` redistributes an activation to the reference's sharding
constraint when ``cfg.tp_axis`` is set, and ``mesh_ops`` lets the plain
tensors a forward makes (positions, masks, constants) meet DTensors as
replicated ones.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Any

import torch

# the model kinds the port runs: every kind of the reference
KINDS = ("dense", "vlm", "moe", "ssm", "hybrid", "encdec")


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
    #     baseline); tp_axis and dp_axes name axes of the DeviceMesh ---
    tp_axis: str | None = None
    tp_size: int = 0
    dp_axes: tuple[str, ...] = ()
    moe_group: int = 0
    attn_p_bf16: bool = False  # cast softmax probs to bf16 for the PV matmul
    attn_dp_only: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def attention_free(self) -> bool:
        return self.kind == "ssm"

    @property
    def subquadratic(self) -> bool:
        """Eligible for the reference's long_500k shape."""
        return self.kind == "ssm" or (self.kind == "hybrid"
                                      and self.local_window > 0)

    def num_params(self) -> int:
        """Analytic parameter count, the reference's formula."""
        d, ff, v, hd = self.d_model, self.d_ff, self.vocab, self.hd
        h, kv = self.n_heads, self.kv_heads
        attn = d * h * hd + 2 * d * kv * hd + h * hd * d
        if self.ffn_act in ("swiglu", "geglu"):
            ffn = 3 * d * ff
        else:
            ffn = 2 * d * ff
        if self.kind == "moe":
            ffn = self.n_experts * ffn + d * self.n_experts   # + router
        per_layer = attn + ffn + 2 * d
        if self.kind == "ssm":
            d_in = self.ssm_expand * d
            nheads = d_in // self.ssm_head_dim
            per_layer = (d * (2 * d_in + 2 * self.ssm_state + nheads)
                         + d_in * d + 2 * d)
        if self.kind == "hybrid":
            # the pattern's layers counted by kind
            attn_l = attn + ffn + 2 * d
            rg = self.rglru_d_rnn
            rg_l = d * rg * 2 + rg * d + 4 * rg + ffn + 2 * d
            n_attn = sum(1 for p in self._full_pattern() if p == "attn")
            n_rg = self.n_layers - n_attn
            return (n_attn * attn_l + n_rg * rg_l + v * d
                    + (0 if self.tie_embeddings else v * d))
        total = self.n_layers * per_layer + v * d
        if self.enc_layers:
            total += self.enc_layers * (attn + ffn + 2 * d) + attn  # cross
        if not self.tie_embeddings:
            total += v * d
        return total

    def num_active_params(self) -> int:
        """Active params per token (MoE: only top_k experts count)."""
        if self.kind != "moe":
            return self.num_params()
        d, ff = self.d_model, self.d_ff
        expert = (3 * d * ff if self.ffn_act in ("swiglu", "geglu")
                  else 2 * d * ff)
        dense_part = self.num_params() - self.n_layers * self.n_experts * expert
        return dense_part + self.n_layers * self.top_k * expert

    def _full_pattern(self) -> tuple[str, ...]:
        if not self.pattern:
            return ("attn",) * self.n_layers
        reps = -(-self.n_layers // len(self.pattern))
        return (self.pattern * reps)[: self.n_layers]


def require_kind(cfg: ModelConfig) -> None:
    """Raise on a kind no family of the port (or the reference) runs."""
    if cfg.kind not in KINDS:
        raise ValueError(f"unknown model kind {cfg.kind!r} ({cfg.arch}); "
                         f"one of {KINDS}")


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


def silu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x) as ``jax.nn.silu`` computes it: x * (1 / (1 +
    exp(-x))), every op rounded to x's dtype. In bf16 this equals the
    reference bit for bit, where ``F.silu`` rounds once and does not."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The tanh approximation as ``jax.nn.gelu`` computes it (its default),
    every op and both constants in x's dtype: bit for bit the reference's in
    bf16, where ``F.gelu(approximate='tanh')`` rounds once."""
    c1 = torch.tensor(math.sqrt(2.0 / math.pi), dtype=x.dtype,
                      device=x.device)
    c2 = torch.tensor(0.044715, dtype=x.dtype, device=x.device)
    return x * (0.5 * (1.0 + torch.tanh(c1 * (x + c2 * (x * x * x)))))


def act_fn(name: str):
    return {"swiglu": silu, "geglu": gelu, "gelu": gelu, "silu": silu}[name]


# -------------------------------------------------------------------- mesh
_mesh_depth = 0


@contextlib.contextmanager
def mesh_ops():
    """Within: a plain tensor that meets a DTensor counts as replicated on
    its mesh (``implicit_replication``), so the positions, masks and
    constants a forward or an update makes need no placement. Re-entrant;
    nothing changes for plain tensors."""
    global _mesh_depth
    if _mesh_depth or not torch.distributed.is_available():
        _mesh_depth += 1
        try:
            yield
        finally:
            _mesh_depth -= 1
        return
    from torch.distributed.tensor.experimental import implicit_replication
    _mesh_depth += 1
    try:
        with implicit_replication():
            yield
    finally:
        _mesh_depth -= 1


def on_mesh(fn):
    """``fn`` run within ``mesh_ops``: an entry point whose tensors may be
    DTensors."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with mesh_ops():
            return fn(*args, **kwargs)

    return wrapped


def constrain(x: torch.Tensor, cfg, spec: tuple) -> torch.Tensor:
    """The reference's sharding constraint: with ``cfg.tp_axis`` set and x
    a DTensor, x redistributed to ``spec`` (entries None, 'tp' for
    ``cfg.tp_axis``, 'dp' for ``cfg.dp_axes``); x itself otherwise, as the
    reference's is a no-op when ``tp_axis`` is None. An axis that does not
    divide its dim is dropped (``enforce_divisible``): the einsums that
    follow fold the dim into a view, which DTensor refuses on an uneven
    shard, where GSPMD pads."""
    if cfg.tp_axis is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    from repro_torch.sharding import rules

    entries = []
    for e in spec:
        if e == "tp":
            entries.append(cfg.tp_axis)
        elif e == "dp":
            entries.append(tuple(cfg.dp_axes) if cfg.dp_axes else None)
        else:
            entries.append(e)
    mesh = x.device_mesh
    spec = rules.enforce_divisible(rules.Spec(*entries), tuple(x.shape), mesh)
    return x.redistribute(mesh, rules.placements(spec, mesh))


def reshape(x: torch.Tensor, *shape) -> torch.Tensor:
    """``x.reshape(*shape)``. A DTensor whose sharded dims the reshape
    cannot split or merge evenly (14 heads over a 16-way axis) is first
    replicated on them, keeping its batch dim 0 as it is: DTensor refuses
    such a view, where GSPMD pads. Its gradient is reshaped back the same
    way."""
    from repro_torch.sharding.rules import is_dtensor

    if not is_dtensor(x):
        return x.reshape(*shape)
    return _Reshape.apply(x, shape)


def _reshape_dtensor(x, shape):
    try:
        return x.reshape(shape)
    except RuntimeError:
        from torch.distributed.tensor import Replicate, Shard

        pl = [Replicate() if isinstance(p, Shard) and p.dim != 0 else p
              for p in x.placements]
        return x.redistribute(x.device_mesh, pl).reshape(shape)


class _Reshape(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shape):
        ctx.shape = x.shape
        return _reshape_dtensor(x, shape)

    @staticmethod
    def backward(ctx, grad):
        return _reshape_dtensor(grad, ctx.shape), None
