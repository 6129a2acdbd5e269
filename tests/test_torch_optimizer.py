"""The port's optimizers (``repro_torch.train.optimizer``) against the
reference's, on the same trees and gradients built with numpy from a seed.

Bands: in f32 the state and params agree within 2e-6 of each leaf's max
|value| (the same elementwise arithmetic; only the global norm's order of
sums and the libraries' pow/sqrt differ by an ulp). bf16 params are rounded
from f32 on both sides, so they agree within one bf16 ulp of each element
(2^-8 relative), their f32 state within 2e-6. The int8 codec is exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm import leaves
from _torch_parity import n, t
from repro.train import optimizer as ref_opt
from repro_torch.train import optimizer as opt

F32_BAND = 2e-6
BF16_ULP = 2.0 ** -8

SHAPES = {
    "embed": (48, 16),
    "final_norm": (16,),
    "blocks": {"norm": (3, 16),                 # a stacked norm: 2-D
               "w": (3, 16, 24),
               "bias": (3, 24)},
}


def _tree(shapes, rng, scale=1.0):
    if isinstance(shapes, dict):
        return {k: _tree(v, rng, scale) for k, v in shapes.items()}
    return (scale * rng.normal(size=shapes)).astype(np.float32)


def _to_ref(tree, dtype):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)


def _to_port(tree, dtype):
    return opt.tree_map(lambda a: t(a).to(dtype), tree)


def _np(tree):
    """A tree of either package as float64 numpy leaves by path."""
    out = {}
    for k, v in leaves(tree).items():
        out[k] = (n(v.double()) if isinstance(v, torch.Tensor)
                  else np.asarray(v, np.float64))
    return out


def _close(got, want, band, label):
    for k in want:
        g, w = got[k], want[k]
        assert g.shape == w.shape, (label, k)
        err = np.abs(g - w).max() / (np.abs(w).max() + 1e-30)
        assert err <= band, (label, k, err)


def _bf16_close(got, want, label):
    for k in want:
        err = np.abs(got[k] - want[k])
        assert (err <= BF16_ULP * np.abs(want[k]) + 1e-30).all(), \
            (label, k, err.max())


def _run(kind, dtype, compress, steps=3, seed=0):
    rng = np.random.default_rng(seed)
    p0 = _tree(SHAPES, rng, 0.3)
    grads = [_tree(SHAPES, rng, 0.05) for _ in range(steps)]
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    rcfg = ref_opt.OptConfig(kind=kind, lr=1e-2, warmup_steps=2,
                             compress_grads=compress)
    pcfg = opt.OptConfig(kind=kind, lr=1e-2, warmup_steps=2,
                         compress_grads=compress)
    rp, pp = _to_ref(p0, jdt), _to_port(p0, tdt)
    rs, ps = ref_opt.init(rp, rcfg), opt.init(pp, pcfg)
    for g in grads:
        rp, rs = ref_opt.update(rp, _to_ref(g, jdt), rs, rcfg)
        pp, ps = opt.update(pp, _to_port(g, tdt), ps, pcfg)
    return rp, rs, pp, ps


# ------------------------------------------------------------------ config
def test_opt_config_fields_and_defaults_match():
    def fields(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)
                if f.name != "state_dtype"]

    assert fields(opt.OptConfig) == fields(ref_opt.OptConfig)
    assert opt.OptConfig().state_dtype is torch.float32
    assert ref_opt.OptConfig().state_dtype is jnp.float32


# ----------------------------------------------------------------- updates
@pytest.mark.parametrize("kind,compress", [("adamw", False),
                                           ("adamw", True),
                                           ("adafactor", False)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_updates_match_reference(kind, compress, dtype):
    """Three updates from the same params and gradients: params, moments,
    factored second moments, residuals and the step counter."""
    rp, rs, pp, ps = _run(kind, dtype, compress)
    assert int(ps["step"]) == int(rs["step"]) == 3
    assert ps["step"].dtype == torch.int32
    state_keys = sorted(k for k in rs if k != "step")
    assert sorted(k for k in ps if k != "step") == state_keys
    for k in state_keys:
        _close(_np(ps[k]), _np(rs[k]), F32_BAND, f"{kind} state {k}")
    if dtype == "f32":
        _close(_np(pp), _np(rp), F32_BAND, f"{kind} params")
    else:
        assert all(v.dtype == torch.bfloat16 for v in leaves(pp).values())
        _bf16_close(_np(pp), _np(rp), f"{kind} params")


def test_adafactor_factors_stacked_norms_as_the_reference():
    """A stacked (n_layers, d) norm is 2-D, so it is factored (vr (n,),
    vc (d,)) and decayed, as in the reference."""
    _, rs, _, ps = _run("adafactor", "f32", False, steps=1)
    for key in ("norm", "bias"):
        assert set(ps["v"]["blocks"][key]) == set(rs["v"]["blocks"][key]) \
            == {"vr", "vc"}
        assert tuple(ps["v"]["blocks"][key]["vr"].shape) == (3,)
    assert set(ps["v"]["final_norm"]) == {"v"}


def test_schedule_matches_reference():
    rcfg, pcfg = ref_opt.OptConfig(warmup_steps=4), opt.OptConfig(
        warmup_steps=4)
    for step in range(7):
        want = float(ref_opt._schedule(rcfg, jnp.int32(step)))
        got = float(opt._schedule(pcfg, torch.tensor(step,
                                                     dtype=torch.int32)))
        assert got == want, step


def test_updates_return_new_trees_and_leave_inputs_unchanged():
    rng = np.random.default_rng(3)
    for kind in ("adamw", "adafactor"):
        cfg = opt.OptConfig(kind=kind, compress_grads=kind == "adamw")
        p = _to_port(_tree(SHAPES, rng), torch.float32)
        g = _to_port(_tree(SHAPES, rng, 0.1), torch.float32)
        s = opt.init(p, cfg)
        before = [x.clone() for x in opt.tree_leaves({"p": p, "g": g,
                                                      "s": s})]
        p2, s2 = opt.update(p, g, s, cfg)
        after = opt.tree_leaves({"p": p, "g": g, "s": s})
        assert all(torch.equal(a, b) for a, b in zip(before, after)), kind
        assert not torch.equal(p2["embed"], p["embed"])


def test_global_norm_matches_reference():
    rng = np.random.default_rng(4)
    tree = _tree(SHAPES, rng)
    want = float(ref_opt._global_norm(_to_ref(tree, jnp.float32)))
    got = float(opt._global_norm(_to_port(tree, torch.float32)))
    assert abs(got - want) <= 1e-6 * want


# ------------------------------------------------------------- int8 codec
def test_int8_codec_matches_reference_bit_for_bit():
    """Quantize, dequantize and the feedback step on the same f32 inputs,
    halves included (both round half to even)."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(257,)).astype(np.float32)
    # scale 127 / 127 rounds to 1 in f32: 0.5, 1.5, 2.5 are ties
    for a in (x, np.array([0.5, 1.5, 2.5, -0.5, 127.0], np.float32)):
        rq, rsc = ref_opt.quantize_int8(jnp.asarray(a))
        pq, psc = opt.quantize_int8(t(a))
        assert pq.dtype == torch.int8
        np.testing.assert_array_equal(n(pq), np.asarray(rq))
        assert float(psc) == float(rsc)
        np.testing.assert_array_equal(n(opt.dequantize_int8(pq, psc)),
                                      np.asarray(ref_opt.dequantize_int8(rq,
                                                                         rsc)))
    res = rng.normal(size=(257,)).astype(np.float32) * 1e-3
    rd, rr = ref_opt.compress_with_feedback(jnp.asarray(x), jnp.asarray(res))
    pd, pr = opt.compress_with_feedback(t(x), t(res))
    np.testing.assert_array_equal(n(pd), np.asarray(rd))
    np.testing.assert_array_equal(n(pr), np.asarray(rr))


def test_gradient_compression_error_feedback():
    """The reference's property: with error feedback the quantization error
    is carried, so the mean of the delivered gradients tracks the true
    one."""
    g = torch.linspace(-1e-3, 1e-3, 128)
    residual = torch.zeros_like(g)
    delivered = torch.zeros_like(g)
    for _ in range(50):
        d, residual = opt.compress_with_feedback(g, residual)
        delivered += d
    np.testing.assert_allclose(n(delivered / 50), n(g), atol=1e-6)


def test_compression_bounds_the_residual():
    """Each delivered gradient is the int8 grid's value of g + residual,
    so the new residual is at most half a step of the grid."""
    rng = np.random.default_rng(6)
    g = t(rng.normal(size=(1000,)).astype(np.float32))
    residual = torch.zeros_like(g)
    for _ in range(5):
        gf = g + residual
        step = float(gf.abs().max()) / 127.0 + 1e-12
        d, residual = opt.compress_with_feedback(g, residual)
        assert float(residual.abs().max()) <= 0.5 * step * (1 + 1e-6)
        assert float((d + residual - gf).abs().max()) <= 1e-6 * float(
            gf.abs().max())
