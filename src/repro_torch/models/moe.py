"""Mixture-of-Experts: token-choice top-k routing with capacity dropping
(the port of ``repro.models.moe``).

Tokens are grouped as (g, s), g = batch rows (or ``moe_group``-token
sub-groups); each group gives every expert C = min(s, int(cf * s * k / E))
slots, filled in token-major, k-minor order, and a (token, k) route past
its expert's capacity is dropped (it adds nothing; the residual carries the
token). Dispatch and combine are dense one-hot products over (g, s, E, C),
as in the reference: no data-dependent shapes. The reference computes all
of it outside any Pallas kernel, and so does the port, in plain PyTorch.

Two things keep the choice of experts the reference's exactly:

- ``route_topk`` takes the top k by a stable descending sort, so equal
  logits come out lower index first, which is ``jax.lax.top_k``'s order
  (``torch.topk`` gives no order among ties);
- ``dispatch_plan`` keeps the capacity in Python float arithmetic and the
  running position as a cumsum over the token-major, k-minor flattening.

The reference's three-operand combine einsum is a product of the weighted
one-hot and the slot one-hot, so nothing larger than (g, s, E, C) is made.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import act_fn, constrain, reshape
from repro_torch.sharding.rules import batch_only, replicate_dims


def route_topk(logits: torch.Tensor, k: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """logits (..., E) -> (weights (..., k), idx (..., k)): the k largest
    logits, ties lower index first, and a softmax over them in f32 cast back
    to the logits' dtype."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :k], idx[..., :k]
    w = torch.softmax(vals.to(torch.float32), dim=-1)
    return w.to(logits.dtype), idx


def capacity(s: int, top_k: int, e: int, capacity_factor: float) -> int:
    """Slots an expert has in a group of s tokens."""
    return min(max(1, int(capacity_factor * s * top_k / e)), s)


def dispatch_plan(idx: torch.Tensor, e: int, cap: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """idx (g, s, k) -> (pos, keep), both (g, s, k): each route's slot in
    its expert within the group, counted over the token-major, k-minor
    flattening, and whether that slot is below the capacity."""
    g, s, k = idx.shape
    oh_flat = F.one_hot(idx, e).to(torch.int32).reshape(g, s * k, e)
    pos = torch.cumsum(oh_flat, dim=1, dtype=torch.int32) - 1
    pos = (pos * oh_flat).sum(-1, dtype=torch.int32).reshape(g, s, k)
    return pos, pos < cap


def moe_ffn(x: torch.Tensor, w_router: torch.Tensor, w_gate: torch.Tensor,
            w_up: torch.Tensor, w_down: torch.Tensor, *, top_k: int,
            capacity_factor: float, act: str, cfg=None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Token-choice MoE layer. x (g, s, d); w_router (d, E); expert
    weights (E, d, f) / (E, f, d). Returns (output (g, s, d), the Switch
    load-balance aux loss, an f32 scalar).

    ``cfg.moe_group`` regroups long sequences into sub-groups of that many
    tokens before dispatch, as the reference does.
    """
    g0, s0, d = x.shape
    if cfg is not None and cfg.moe_group and s0 > cfg.moe_group \
            and s0 % cfg.moe_group == 0:
        x = reshape(x, g0 * (s0 // cfg.moe_group), cfg.moe_group, d)
    g, s, _ = x.shape
    e = w_router.shape[-1]
    f32 = torch.float32

    logits = torch.matmul(x, w_router)                     # (g, s, E)
    weights, idx = route_topk(logits, top_k)                # (g, s, k)

    # Switch-style load-balance aux: E * sum_e f_e * p_e
    probs = torch.softmax(logits.to(f32), dim=-1)
    oh = F.one_hot(idx, e)                                  # (g, s, k, E)
    onehot_any = oh.to(f32).sum(-2)                         # (g, s, E)
    aux = e * torch.sum(onehot_any.mean((0, 1)) * probs.mean((0, 1)))

    cap = capacity(s, top_k, e, capacity_factor)
    pos, keep = dispatch_plan(idx, e, cap)
    # a dropped route's slot is C, one past the last: its one-hot row is 0
    slot = torch.where(keep, pos, cap)[..., None]
    pos_oh = (slot == torch.arange(cap, device=x.device)).to(x.dtype)
    disp = oh.to(x.dtype) * keep[..., None].to(x.dtype)
    # (g, s, E, C) = sum_k onehot_E * onehot_C (* the route's weight)
    dispatch = torch.einsum("gske,gskc->gsec", disp, pos_oh)
    combine = torch.einsum("gske,gskc->gsec",
                           disp * weights.to(x.dtype)[..., None], pos_oh)

    # on a mesh, the products start from group-sharded operands: DTensor
    # cannot fold an unevenly sharded (E, C) into the einsums' views
    dispatch, combine, x = (batch_only(t) for t in (dispatch, combine, x))
    tp = cfg is not None and cfg.tp_axis
    if tp:
        dispatch = constrain(dispatch, cfg, ("dp", None, "tp", None))
        combine = constrain(combine, cfg, ("dp", None, "tp", None))

    # (E, g, C, d): the EP all-to-all happens here when E is model-sharded
    expert_in = torch.einsum("gsec,gsd->egcd", dispatch, x)
    if tp:
        # decode keeps d over the FSDP axis (partial sums, not gathered
        # expert weights), as the reference does
        expert_in = constrain(expert_in, cfg, ("tp", None, None, "dp")
                              if s0 == 1 else ("tp", "dp", None, None))
    expert_in = replicate_dims(expert_in, (1, 2, 3))
    f = act_fn(act)
    ein = reshape(expert_in, e, g * cap, d)
    gate = f(torch.bmm(ein, w_gate))
    up = torch.bmm(ein, w_up)
    expert_out = reshape(torch.bmm(gate * up, w_down), e, g, cap, d)
    if tp:
        expert_out = constrain(expert_out, cfg, ("tp", "dp", None, None))

    out = torch.einsum("gsec,egcd->gsd", combine,
                       replicate_dims(expert_out, (1, 2, 3)))
    if x.shape[0] != g0:
        out = reshape(out, g0, s0, d)
    return out, aux.to(f32)
