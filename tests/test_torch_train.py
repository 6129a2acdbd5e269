"""The port's training step (``repro_torch.train.train_step``) against the
reference's: the chunked cross-entropy, ``loss_fn`` and its gradient for
every arch's SMOKE config in f32, remat, and the reference's substrate
properties (``tests/test_substrate.py``) mirrored on the port's own data.

Bands: ``_torch_lm.BAND["f32"]`` (1e-4 of max |ref|) for the loss and
every gradient leaf in f32, where only the order of sums differs (the
forward's attention is the flash kernel's plain version here, the
reference's ``chunked_attention``); 1e-6 relative for the chunked CE
alone. bf16 is held in ``tests/test_torch_train_bf16.py``, one update of
every arch in ``tests/test_torch_train_step.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm import BAND, batches, f32, leaves, pair, rel, tokens
from _torch_parity import n, t
from repro.models import lm as ref_lm
from repro.train import train_step as ref_ts
from repro_torch.configs import ARCHS, get_smoke_config
from repro_torch.data.pipeline import DataConfig, synthetic_batch
from repro_torch.models import lm
from repro_torch.train import optimizer as opt
from repro_torch.train import train_step as ts

CE_BAND = 1e-6


def grads_agree(pg, rg, band, label):
    rgl, pgl = leaves(rg), leaves(pg)
    assert sorted(pgl) == sorted(rgl), label
    for k in rgl:
        assert str(pgl[k].dtype).removeprefix("torch.") == str(
            rgl[k].dtype), (label, k)
        assert tuple(pgl[k].shape) == rgl[k].shape, (label, k)
        err = rel(f32(pgl[k]), f32(rgl[k]))
        assert err <= band, (label, k, err)


# ------------------------------------------------------------------ config
def test_train_config_fields_and_defaults_match():
    def fields(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)
                if f.name != "opt"]

    assert fields(ts.TrainConfig) == fields(ref_ts.TrainConfig)
    assert dataclasses.asdict(ts.TrainConfig().opt) | {"state_dtype": 0} \
        == dataclasses.asdict(ref_ts.TrainConfig().opt) | {"state_dtype": 0}


# -------------------------------------------------------------- chunked CE
@pytest.mark.parametrize("s,chunk,z_loss", [(37, 16, 1e-4), (32, 8, 0.0),
                                            (5, 512, 1e-4)])
def test_chunked_ce_loss_matches_reference(s, chunk, z_loss):
    """Ragged s, -1 targets (the last position and random ones), z-loss:
    the loss and its gradient w.r.t. the hidden states and the unembed."""
    rm, rp, pm, pp = pair("qwen2-0.5b", "f32", tie_embeddings=False)
    rng = np.random.default_rng(7)
    hidden = rng.normal(size=(3, s, rm.cfg.d_model)).astype(np.float32)
    tgt = rng.integers(0, rm.cfg.vocab, (3, s)).astype(np.int32)
    tgt[:, -1] = -1
    tgt[rng.random((3, s)) < 0.2] = -1

    def ref(h, w):
        return ref_ts.chunked_ce_loss(rm.cfg, {**rp, "unembed": w}, h,
                                      jnp.asarray(tgt), chunk, z_loss)

    want, (rgh, rgw) = jax.value_and_grad(ref, argnums=(0, 1))(
        jnp.asarray(hidden), rp["unembed"])
    th = t(hidden).requires_grad_(True)
    tw = pp["unembed"].clone().requires_grad_(True)
    got = ts.chunked_ce_loss(pm.cfg, {**pp, "unembed": tw}, th, t(tgt),
                             chunk, z_loss)
    assert abs(float(got.detach()) - float(want)) <= CE_BAND * abs(
        float(want))
    pgh, pgw = torch.autograd.grad(got, (th, tw))
    assert rel(n(pgh), rgh) <= CE_BAND * 10
    assert rel(n(pgw), rgw) <= CE_BAND * 10
    with torch.no_grad():
        assert torch.equal(ts.chunked_ce_loss(
            pm.cfg, {**pp, "unembed": tw}, th, t(tgt), chunk, z_loss), got)


def test_chunked_ce_loss_all_targets_masked_is_zero():
    rm, rp, pm, pp = pair("qwen2-0.5b", "f32")
    h = torch.ones(2, 5, rm.cfg.d_model)
    tgt = torch.full((2, 5), -1, dtype=torch.int32)
    assert float(ts.chunked_ce_loss(pm.cfg, pp, h, tgt, 4, 1e-4)) == 0.0
    want = ref_ts.chunked_ce_loss(rm.cfg, rp, jnp.ones((2, 5, rm.cfg.d_model)),
                                  jnp.full((2, 5), -1, jnp.int32), 4, 1e-4)
    assert float(want) == 0.0


# ---------------------------------------------------- loss and gradients
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference_f32(arch):
    """``loss_fn`` (remat, chunk 6 over 16 positions: a ragged last chunk)
    and every gradient leaf against ``jax.value_and_grad`` of the
    reference's on the same params and batch."""
    rm, rp, pm, pp = pair(arch, "f32")
    rb, pb = batches(rm.cfg)
    rt, pt = (ref_ts.TrainConfig(loss_chunk=6),
              ts.TrainConfig(loss_chunk=6))
    rl, rg = jax.value_and_grad(
        lambda p: ref_ts.loss_fn(rm.cfg, rt, p, rb))(rp)
    pl, pg = ts.value_and_grad(pm.cfg, pt, pp, pb)
    assert abs(float(pl) - float(rl)) <= BAND["f32"] * abs(float(rl))
    grads_agree(pg, rg, BAND["f32"], arch)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "recurrentgemma-2b",
                                  "dbrx-132b", "mamba2-2.7b",
                                  "internvl2-26b"])
def test_remat_matches_no_remat(arch):
    """On the CPU the recompute is the same arithmetic: loss, aux and every
    gradient equal bit for bit with and without remat (the hybrid's
    pattern groups and its unwrapped tail included)."""
    cfg = get_smoke_config(arch)
    if arch == "recurrentgemma-2b":
        assert cfg.n_layers % len(cfg.pattern)      # it has a tail
    pm_params = lm.init_params(cfg, torch.Generator().manual_seed(0))
    _, pb = batches(cfg)
    out = []
    for remat in (False, True):
        tc = ts.TrainConfig(loss_chunk=8, remat=remat)
        out.append(ts.value_and_grad(cfg, tc, pm_params, pb))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    for a, b in zip(opt.tree_leaves(g0), opt.tree_leaves(g1)):
        assert torch.equal(a, b)


def test_forward_remat_and_moe_aux_match_reference():
    """``lm.forward(remat=True)``: hidden and MoE aux against the
    reference's."""
    rm, rp, pm, pp = pair("dbrx-132b", "f32")
    tok = tokens(rm.cfg, 2, 16)
    rh, raux = ref_lm.forward(rm.cfg, rp, jnp.asarray(tok), remat=True)
    ph, paux = lm.forward(pm.cfg, pp, t(tok), remat=True)
    assert rel(n(ph), rh) <= BAND["f32"]
    assert abs(float(paux) - float(raux)) <= BAND["f32"] * float(raux)
    assert float(paux) > 0


def test_unused_params_get_zero_gradients():
    """``value_and_grad`` gives a leaf the loss does not use a zero
    gradient, as ``jax.grad`` does."""
    cfg = get_smoke_config("qwen2-0.5b")
    params = lm.init_params(cfg, torch.Generator().manual_seed(0))
    params["unused"] = torch.ones(3)
    _, pb = batches(cfg)
    _, g = ts.value_and_grad(cfg, ts.TrainConfig(loss_chunk=8), params, pb)
    assert torch.equal(g["unused"], torch.zeros(3))


# -------------------------------------------------- substrate properties
def _setup(microbatches=1, opt_kind="adamw", compress=False):
    """``tests/test_substrate.py::_setup`` on the port's own data."""
    cfg = get_smoke_config("qwen2-0.5b")
    params = lm.init_params(cfg, torch.Generator().manual_seed(0))
    tcfg = ts.TrainConfig(
        opt=opt.OptConfig(kind=opt_kind, lr=1e-3, compress_grads=compress,
                          warmup_steps=2),
        loss_chunk=16, microbatches=microbatches, remat=True)
    dcfg = DataConfig(seed=7, global_batch=4, seq_len=32)
    return (params, opt.init(params, tcfg.opt), ts.make_train_step(cfg, tcfg),
            lambda step: synthetic_batch(dcfg, cfg, step, "cpu"))


@pytest.mark.parametrize("compress", [False, True])
def test_loss_decreases_over_steps(compress):
    """12 steps on one batch overfit it: the loss falls by 0.5, with and
    without int8 compression of the gradients."""
    params, state, step, batch_fn = _setup(compress=compress)
    losses = []
    for _ in range(12):
        params, state, metrics = step(params, state, batch_fn(0))
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] - 0.5, losses


@pytest.mark.parametrize("opt_kind", ["adamw", "adafactor"])
def test_optimizers_make_finite_progress(opt_kind):
    params, state, step, batch_fn = _setup(opt_kind=opt_kind)
    for s in range(3):
        params, state, metrics = step(params, state, batch_fn(s))
        assert np.isfinite(float(metrics["loss"]))
        assert np.isfinite(float(metrics["grad_norm"]))
    assert all(bool(torch.isfinite(x.float()).all())
               for x in opt.tree_leaves(params))


def test_microbatch_accumulation_matches_full_batch():
    p1, s1, step1, batch_fn = _setup(microbatches=1)
    p2, s2, step2, _ = _setup(microbatches=2)
    b = batch_fn(0)
    p1n, _, m1 = step1(p1, s1, b)
    p2n, _, m2 = step2(p2, s2, b)
    d = max(float((x.float() - y.float()).abs().max())
            for x, y in zip(opt.tree_leaves(p1n), opt.tree_leaves(p2n)))
    assert d < 5e-2, float(m1["loss"])
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 1e-2
