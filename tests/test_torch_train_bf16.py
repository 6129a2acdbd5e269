"""The port's ``loss_fn`` and its gradient in bf16 against the reference's
run op by op (``jax.disable_jit``, as ``tests/_torch_lm.py`` explains), for
every arch's SMOKE config, on the same params and batch.

Bands: the loss within 0.02 relative (``_torch_lm.BAND["bf16"]``); each
gradient leaf within 0.02 of its max |grad| (the worst reading is 0.0185,
qwen2.5-3b's ``bq``), except the hybrid's (recurrentgemma-2b) at 0.05.
There the reference's own two bf16 runs of the same gradient, jitted and
op by op, differ by 0.043 of max |grad| on the RG-LRU's leaves (the last
test below), and the port's differs from the op-by-op run by 0.041. The
f32 tests (``tests/test_torch_train.py``) hold the same code within 1e-4.
"""

import jax
import pytest

from _torch_lm import BAND, batches, f32, leaves, pair, rel
from repro.train import train_step as ref_ts
from repro_torch.configs import ARCHS
from repro_torch.train import train_step as ts

GRAD_BAND = {"recurrentgemma-2b": 0.05}


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference_bf16(arch):
    rm, rp, pm, pp = pair(arch, "bf16")
    rb, pb = batches(rm.cfg)
    rt, pt = ref_ts.TrainConfig(loss_chunk=6), ts.TrainConfig(loss_chunk=6)
    with jax.disable_jit():
        rl, rg = jax.value_and_grad(
            lambda p: ref_ts.loss_fn(rm.cfg, rt, p, rb))(rp)
    pl, pg = ts.value_and_grad(pm.cfg, pt, pp, pb)
    assert abs(float(pl) - float(rl)) <= BAND["bf16"] * abs(float(rl))
    want, got = leaves(rg), leaves(pg)
    assert sorted(got) == sorted(want)
    for k in want:
        assert str(got[k].dtype).removeprefix("torch.") == str(
            want[k].dtype), k
        err = rel(f32(got[k]), f32(want[k]))
        assert err <= GRAD_BAND.get(arch, BAND["bf16"]), (arch, k, err)


def test_reference_bf16_gradient_spread_on_the_hybrid():
    """Why the hybrid's band is wider: the reference's jitted bf16 gradient
    of recurrentgemma's SMOKE config differs from its op-by-op one by more
    than 0.02 of max |grad|, and within the 0.05 the port is held to."""
    rm, rp, _, _ = pair("recurrentgemma-2b", "bf16")
    rb, _ = batches(rm.cfg)
    rt = ref_ts.TrainConfig(loss_chunk=6)
    grad = jax.grad(lambda p: ref_ts.loss_fn(rm.cfg, rt, p, rb))
    with jax.disable_jit():
        eager = leaves(grad(rp))
    jitted = leaves(jax.jit(grad)(rp))
    spread = max(rel(f32(jitted[k]), f32(eager[k])) for k in eager)
    assert BAND["bf16"] < spread <= GRAD_BAND["recurrentgemma-2b"], spread
