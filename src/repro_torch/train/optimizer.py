"""Optimizers: AdamW and Adafactor, with the large-model plumbing (the port
of ``repro.train.optimizer``).

* mixed precision: bf16 params, configurable accumulator dtype (Adafactor's
  factored second moment for the 100B+ MoE archs);
* global-norm clipping;
* optional int8 **gradient compression with error feedback**: the
  quantize/dequantize round trip is applied to the gradients as a
  compressed all-reduce would deliver them, and the residual is carried.

Functional, as the reference is: the updates run under ``torch.no_grad()``
and return new tensors, never writing into the params or the state they
are given, so a caller may reuse a params tree for two runs.

Trees are nested dicts of tensors, walked in sorted key order (the order
of ``jax.tree.leaves``), so the global norm sums the leaves as the
reference does. Properties of the reference kept exactly:

- ``_schedule`` sees the step already incremented, so the warm-up factor
  of update n (from 1) is (n + 1) / warmup_steps;
- decay and factoring go by ``p.ndim >= 2`` of the stacked leaf, so a
  stacked (n_layers, d) norm is decayed and, in Adafactor, factored;
- the bias corrections are ``b ** step`` with the step in float32;
- Adafactor's second-moment decay is 1 - (step + 1) ** -0.8;
- ``torch.round`` rounds half to even, as ``jnp.round`` does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Literal

import torch

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class OptConfig:
    kind: Literal["adamw", "adafactor"] = "adamw"
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: Any = torch.float32        # bf16 for the giants
    compress_grads: bool = False            # int8 + error feedback
    warmup_steps: int = 100


# ------------------------------------------------------------------ trees
def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching nodes of
    ``rest`` (which may hold more structure below a leaf of ``tree``)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    """The leaves in sorted key order, ``jax.tree.leaves``'s order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def _unzip(tree: Any, n: int) -> list:
    """A tree of n-tuples -> n trees."""
    return [tree_map(lambda t, i=i: t[i], tree) for i in range(n)]


def _schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    warm = torch.clamp((step + 1) / cfg.warmup_steps, max=1.0)
    return cfg.lr * warm


# ------------------------------------------------------- int8 compression
def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(F32) * scale


def compress_with_feedback(g: torch.Tensor, residual: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (decompressed grad as the reduce would deliver it, residual)."""
    gf = g.to(F32) + residual
    q, s = quantize_int8(gf)
    deq = dequantize_int8(q, s)
    return deq, gf - deq


# ----------------------------------------------------------------- AdamW
def _zeros(p: torch.Tensor, dtype) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=dtype, device=p.device)


def _step0(params: Any) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)


def init_adamw(params: Any, cfg: OptConfig) -> dict:
    state = {"m": tree_map(lambda p: _zeros(p, cfg.state_dtype), params),
             "v": tree_map(lambda p: _zeros(p, cfg.state_dtype), params),
             "step": _step0(params)}
    if cfg.compress_grads:
        state["residual"] = tree_map(lambda p: _zeros(p, F32), params)
    return state


def _global_norm(tree: Any) -> torch.Tensor:
    total = None
    for x in tree_leaves(tree):
        sq = torch.sum(torch.square(x.to(F32)))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def _clip_scale(cfg: OptConfig, grads: Any) -> torch.Tensor:
    return torch.clamp(cfg.clip_norm / (_global_norm(grads) + 1e-9),
                       max=1.0)


@torch.no_grad()
def adamw_update(params: Any, grads: Any, state: dict, cfg: OptConfig
                 ) -> tuple[Any, dict]:
    step = state["step"] + 1
    if cfg.compress_grads:
        grads, residual = _unzip(
            tree_map(compress_with_feedback, grads, state["residual"]), 2)
    scale = _clip_scale(cfg, grads)
    lr = _schedule(cfg, step)
    b1c = 1.0 - cfg.b1 ** step.to(F32)
    b2c = 1.0 - cfg.b2 ** step.to(F32)

    def upd(p, g, m, v):
        g = g.to(F32) * scale
        m_new = cfg.b1 * m.to(F32) + (1 - cfg.b1) * g
        v_new = cfg.b2 * v.to(F32) + (1 - cfg.b2) * g * g
        delta = (m_new / b1c) / (torch.sqrt(v_new / b2c) + cfg.eps)
        if p.ndim >= 2:                      # decoupled decay, not on norms
            delta = delta + cfg.weight_decay * p.to(F32)
        p_new = p.to(F32) - lr * delta
        return p_new.to(p.dtype), m_new.to(m.dtype), v_new.to(v.dtype)

    params_new, m_new, v_new = _unzip(
        tree_map(upd, params, grads, state["m"], state["v"]), 3)
    new_state = {"m": m_new, "v": v_new, "step": step}
    if cfg.compress_grads:
        new_state["residual"] = residual
    return params_new, new_state


# -------------------------------------------------------------- Adafactor
def init_adafactor(params: Any, cfg: OptConfig) -> dict:
    def factored(p):
        if p.ndim >= 2:
            return {"vr": torch.zeros(p.shape[:-1], dtype=cfg.state_dtype,
                                      device=p.device),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                      dtype=cfg.state_dtype, device=p.device)}
        return {"v": _zeros(p, cfg.state_dtype)}

    return {"m": tree_map(lambda p: _zeros(p, cfg.state_dtype), params),
            "v": tree_map(factored, params),
            "step": _step0(params)}


@torch.no_grad()
def adafactor_update(params: Any, grads: Any, state: dict, cfg: OptConfig
                     ) -> tuple[Any, dict]:
    step = state["step"] + 1
    scale = _clip_scale(cfg, grads)
    lr = _schedule(cfg, step)
    decay = 1.0 - (step.to(F32) + 1.0) ** -0.8

    def upd(p, g, m, v):
        g = g.to(F32) * scale
        g2 = g * g + 1e-30
        if p.ndim >= 2:
            vr = decay * v["vr"].to(F32) + (1 - decay) * g2.mean(-1)
            vc = decay * v["vc"].to(F32) + (1 - decay) * g2.mean(-2)
            denom = (vr[..., None] * vc[..., None, :]
                     / torch.clamp(vr.mean(-1)[..., None, None], min=1e-30))
            precond = g * torch.rsqrt(denom + 1e-30)
            v_new = {"vr": vr.to(v["vr"].dtype), "vc": vc.to(v["vc"].dtype)}
        else:
            vv = decay * v["v"].to(F32) + (1 - decay) * g2
            precond = g * torch.rsqrt(vv + 1e-30)
            v_new = {"v": vv.to(v["v"].dtype)}
        # update clipping (Adafactor RMS rule)
        rms = torch.sqrt(torch.mean(precond * precond) + 1e-30)
        precond = precond / torch.clamp(rms, min=1.0)
        m_new = cfg.b1 * m.to(F32) + (1 - cfg.b1) * precond
        delta = m_new
        if p.ndim >= 2:
            delta = delta + cfg.weight_decay * p.to(F32)
        p_new = p.to(F32) - lr * delta
        return p_new.to(p.dtype), m_new.to(m.dtype), v_new

    params_new, m_new, v_new = _unzip(
        tree_map(upd, params, grads, state["m"], state["v"]), 3)
    return params_new, {"m": m_new, "v": v_new, "step": step}


# ------------------------------------------------------------------ facade
def init(params: Any, cfg: OptConfig) -> dict:
    return (init_adafactor if cfg.kind == "adafactor" else init_adamw)(
        params, cfg)


def update(params: Any, grads: Any, state: dict, cfg: OptConfig
           ) -> tuple[Any, dict]:
    fn = adafactor_update if cfg.kind == "adafactor" else adamw_update
    return fn(params, grads, state, cfg)
