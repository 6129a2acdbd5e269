"""The port's hybrid family (recurrentgemma: RG-LRU blocks and local
attention in a (rglru, rglru, attn) pattern) against the reference: the
layer walk and the parameter and cache trees (``blocks.slot{i}`` stacked
over the pattern's repetitions, ``tail.tail{i}`` with a leading axis of 1),
the recurrent block, and the windowed attention past its window, in
prefill and in cached decode.

Bands as ``tests/_torch_lm.py``: 1e-4 relative in f32, 0.02 in bf16
against the reference run op by op.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm import BAND, DTYPES, f32, leaves, pair, ref_mode, rel, tokens
from _torch_parity import t
from repro.configs import get_config as ref_get_config
from repro.models import lm as ref_lm
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import lm

ARCH = "recurrentgemma-2b"


@pytest.mark.parametrize("which", ["CONFIG", "SMOKE"])
def test_hybrid_layers_walk_the_pattern_in_depth_order(which):
    """26 layers = 8 repetitions of (rglru, rglru, attn) + 2 rglru tail
    layers (8 attention layers); the smoke config's 5 = 1 + 2."""
    cfg = get_config(ARCH) if which == "CONFIG" else get_smoke_config(ARCH)
    walk = list(lm._hybrid_layers(cfg))
    assert tuple(k for k, _, _ in walk) == cfg._full_pattern()
    reps = cfg.n_layers // len(cfg.pattern)
    assert [key for _, key, _ in walk[reps * 3:]] == [
        f"tail{i}" for i in range(cfg.n_layers - reps * 3)]
    assert [(key, j) for _, key, j in walk[:3]] == [
        ("slot0", 0), ("slot1", 0), ("slot2", 0)]
    if which == "CONFIG":
        assert sum(k == "attn" for k, _, _ in walk) == 8 and reps == 8


def test_params_from_numpy_carries_the_hybrid_tree():
    rm, rp, pm, pp = pair(ARCH, "bf16")
    want = leaves(jax.tree.map(np.asarray, rp))
    got = leaves(pp)
    assert got.keys() == want.keys()
    assert "tail.tail1.mix.lam" in got and "blocks.slot2.mix.wq" in got
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape, k
        assert str(got[k].dtype).removeprefix("torch.") == str(v.dtype), k
        np.testing.assert_array_equal(f32(got[k]), np.asarray(v, np.float32))
    assert got["tail.tail0.mix.lam"].shape[0] == 1
    assert got["tail.tail0.mix.lam"].dtype == torch.float32


def test_layer_slices_deep_and_flat_trees():
    deep = {"a": {"b": {"c": torch.arange(6).reshape(3, 2)}},
            "d": torch.arange(3)}
    flat = {"w": torch.arange(4).reshape(2, 2)}
    assert lm._layer(deep, 1)["a"]["b"]["c"].tolist() == [2, 3]
    assert lm._layer(deep, 2)["d"].item() == 2
    assert lm._layer(flat, 1)["w"].tolist() == [2, 3]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_rg_block_prefill_and_decode_match_reference(dt):
    """The Griffin recurrent block of ``blocks.slot0``: a 24-token prefill,
    then 4 decode steps carrying h and the conv context."""
    rm, rp, pm, pp = pair(ARCH, dt)
    jdt, tdt = DTYPES[dt]
    x = np.random.default_rng(3).normal(size=(2, 24, 64)).astype(np.float32)
    rlp = jax.tree.map(lambda a: a[0], rp["blocks"]["slot0"]["mix"])
    plp = lm._layer(pp["blocks"]["slot0"]["mix"], 0)
    with ref_mode(dt):
        want, rh, rcv = ref_lm._rg_apply(rm.cfg, rlp,
                                         jnp.asarray(x).astype(jdt))
        rc = rm.init_cache(2, 4)["slot0"]
        h, cv, rsteps = rc["h"][0], rc["conv"][0], []
        for i in range(4):
            y, h, cv = ref_lm._rg_apply(
                rm.cfg, rlp, jnp.asarray(x[:, i:i + 1]).astype(jdt), h, cv,
                decode=True)
            rsteps.append(y)
    got, ph, pcv = lm._rg_apply(pm.cfg, plp, t(x).to(tdt))
    assert got.dtype == tdt and ph.dtype == torch.float32
    assert rel(f32(got) - x, f32(want) - x) < BAND[dt]
    assert rel(f32(ph), f32(rh)) < BAND[dt]
    assert rel(f32(pcv), f32(rcv)) < BAND[dt]
    pc = pm.init_cache(2, 4, "cpu")["slot0"]
    h, cv = pc["h"][0], pc["conv"][0]
    for i in range(4):
        y, h, cv = lm._rg_apply(pm.cfg, plp, t(x[:, i:i + 1]).to(tdt), h,
                                cv, decode=True)
        assert rel(f32(y) - x[:, i:i + 1],
                   f32(rsteps[i]) - x[:, i:i + 1]) < BAND[dt], i


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_local_attention_past_its_window_matches_reference(dt):
    """The smoke config's window is 32: a 72-token forward, and 40 cached
    decode steps, so queries see only their last 32 keys."""
    rm, rp, pm, pp = pair(ARCH, dt)
    assert pm.cfg.local_window == 32
    tok = tokens(pm.cfg, 2, 72, seed=4)
    with ref_mode(dt):
        rh, _ = rm.forward(rp, jnp.asarray(tok))
        rl = rm.logits(rp, rh[:, -8:])
    ph, _ = pm.forward(pp, t(tok))
    assert rel(f32(ph), f32(rh)) < BAND[dt]
    assert rel(f32(pm.logits(pp, ph[:, -8:])), f32(rl)) < BAND[dt]
    if dt == "bf16":
        return
    s = 40
    rc, pc = rm.init_cache(2, s), pm.init_cache(2, s, "cpu")
    step = jax.jit(rm.decode_step)
    for i in range(s):
        rl, rc = step(rp, jnp.asarray(tok[:, i:i + 1]), rc,
                      jnp.asarray(i, jnp.int32))
        pl, pc = pm.decode_step(pp, t(tok[:, i:i + 1]), pc, i)
        assert rel(f32(pl), f32(rl)) < BAND[dt], i


def test_decode_writes_the_hybrid_cache_in_place():
    cfg = get_smoke_config(ARCH)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0))
    cache = lm.init_cache(cfg, 1, 4, "cpu")
    before = leaves(cache)
    _, out = lm.decode_step(cfg, params, torch.tensor([[3]]), cache, 2)
    after = leaves(out)
    assert all(after[k] is v for k, v in before.items())
    assert after["slot2.k"][:, :, 2].any() and not after["slot2.k"][
        :, :, 3].any()
    assert after["slot0.h"].any() and after["tail1.conv"][:, :, -1].any()


def test_num_params_counts_the_pattern():
    """recurrentgemma-2b: 2.66 B parameters by the reference's formula."""
    assert get_config(ARCH).num_params() == \
        ref_get_config(ARCH).num_params() == 2_658_457_600
