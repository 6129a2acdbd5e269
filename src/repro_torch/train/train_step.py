"""Training step: chunked cross-entropy loss, gradient accumulation, remat
(the port of ``repro.train.train_step``).

The vocab projection is the memory cliff at long contexts with large
vocabularies (a whole (b, s, V) f32 logits tensor is tens of GB), so the
loss is computed per sequence chunk, and each chunk is checkpointed: only
one (b, chunk, V) block is live, in the forward and again in the
backward, which recomputes it.

Microbatches: the batch splits into ``microbatches`` along its rows; the
gradients of the microbatches are summed in float32, divided by their
count and cast to bfloat16, as the reference does (whatever the params'
dtype). Each microbatch's gradients come from ``torch.autograd.grad``, not
``.grad`` fields, which would accumulate in the params' dtype.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import lm, whisper
from repro_torch.models.common import ModelConfig, mesh_ops
from repro_torch.sharding.rules import is_dtensor
from repro_torch.train import optimizer as opt

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: opt.OptConfig = opt.OptConfig()
    loss_chunk: int = 512
    microbatches: int = 1
    remat: bool = True
    moe_aux_weight: float = 0.01
    z_loss: float = 1e-4


def _ce_chunk(h_c: torch.Tensor, t_c: torch.Tensor, w: torch.Tensor,
              z_loss: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(sum of nll + z-loss, count of valid targets) of one chunk."""
    logits = torch.matmul(h_c, w).to(F32)
    lse = torch.logsumexp(logits, dim=-1)
    valid = t_c >= 0
    # a -1 target picks 0, as the reference's iota compare does
    if is_dtensor(logits):
        # the reference's iota compare: elementwise, so a vocab-sharded
        # chunk sums partial picks (DTensor's gather cannot unmask one);
        # every other term is an exact 0, so the pick is the same number
        iota = torch.arange(logits.shape[-1], device=logits.device)
        picked = torch.where(iota == t_c[..., None], logits, 0.0).sum(-1)
    else:
        picked = torch.gather(logits, -1,
                              t_c.clamp(min=0).long()[..., None])[..., 0]
    picked = torch.where(valid, picked, 0.0)
    valid = valid.to(F32)
    nll = (lse - picked) * valid
    zl = z_loss * (lse * lse) * valid
    return torch.sum(nll + zl), torch.sum(valid)


def chunked_ce_loss(cfg: ModelConfig, params: dict, hidden: torch.Tensor,
                    targets: torch.Tensor, chunk: int,
                    z_loss: float = 0.0) -> torch.Tensor:
    """Mean next-token CE over (b, s) hidden/targets, by chunks of s; a
    target of -1 is masked out. Padding the last chunk adds only masked
    rows, so it is not materialised."""
    s = hidden.shape[1]
    w = lm.unembed_matrix(cfg, params)
    total = torch.zeros((), dtype=F32, device=hidden.device)
    count = torch.zeros((), dtype=F32, device=hidden.device)
    for c0 in range(0, s, chunk):
        part, n = checkpoint(_ce_chunk, hidden[:, c0:c0 + chunk],
                             targets[:, c0:c0 + chunk], w, z_loss,
                             use_reentrant=False)
        total, count = total + part, count + n
    return total / torch.clamp(count, min=1.0)


def loss_fn(cfg: ModelConfig, tcfg: TrainConfig, params: dict,
            batch: dict) -> torch.Tensor:
    tokens = batch["tokens"]
    aux_in = batch.get("frontend")
    if cfg.kind == "encdec":
        hidden, moe_aux = whisper.forward(cfg, params, tokens, aux_in)
    else:
        hidden, moe_aux = lm.forward(cfg, params, tokens, aux_in,
                                     remat=tcfg.remat)
        if cfg.kind == "vlm" and aux_in is not None:
            hidden = hidden[:, cfg.frontend_tokens:]
    # next-token targets; the final position has none
    targets = torch.cat([tokens[:, 1:], torch.full_like(tokens[:, :1], -1)],
                        dim=1)
    ce = chunked_ce_loss(cfg, params, hidden, targets, tcfg.loss_chunk,
                         tcfg.z_loss)
    return ce + tcfg.moe_aux_weight * moe_aux


def value_and_grad(cfg: ModelConfig, tcfg: TrainConfig, params: dict,
                   batch: dict) -> tuple[torch.Tensor, dict]:
    """(loss, gradient tree in the params' dtypes); a param the loss does
    not use gets a zero gradient, as ``jax.grad`` gives."""
    leaves = opt.tree_leaves(params)
    wrt = [p.detach().requires_grad_(True) for p in leaves]
    it = iter(wrt)
    with torch.enable_grad(), mesh_ops():
        loss = loss_fn(cfg, tcfg, opt.tree_map(lambda _: next(it), params),
                       batch)
        grads = torch.autograd.grad(loss, wrt, allow_unused=True)
    it = iter(torch.zeros_like(p) if g is None else g
              for p, g in zip(leaves, grads))
    return loss.detach(), opt.tree_map(lambda _: next(it), params)


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig):
    """Returns step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm"}). New trees are returned; the given ones are not
    changed. The leaves may be DTensors on a mesh (``launch.train
    --mesh``): the step is the same code, DTensor runs each op on the
    local shards."""

    def step(params, opt_state, batch):
        with mesh_ops():
            return _step(params, opt_state, batch)

    def _step(params, opt_state, batch):
        mb = tcfg.microbatches
        if mb > 1:
            for i in range(mb):
                micro = {k: v.reshape((mb, v.shape[0] // mb) + v.shape[1:])[i]
                         for k, v in batch.items()}
                l, g = value_and_grad(cfg, tcfg, params, micro)
                g = opt.tree_map(lambda x: x.to(F32), g)
                loss = l if i == 0 else loss + l
                gsum = g if i == 0 else opt.tree_map(torch.add, gsum, g)
            loss = loss / mb
            grads = opt.tree_map(lambda x: (x / mb).to(torch.bfloat16), gsum)
        else:
            loss, grads = value_and_grad(cfg, tcfg, params, batch)
        params, opt_state = opt.update(params, grads, opt_state, tcfg.opt)
        metrics = {"loss": loss, "grad_norm": opt._global_norm(grads)}
        return params, opt_state, metrics

    return step
