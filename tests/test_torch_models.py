"""The port's dense LM (``repro_torch.models``, ``configs``, ``train``,
``launch.serve_lm``) against the reference's, on the SMOKE configs of the
four dense archs, with the reference's parameters from ``PRNGKey(0)``
carried across by ``params_from_numpy``.

Bands: 1e-4 relative (max |diff| / max |ref|) in f32, where only the order
of sums differs; 0.02 relative in bf16, the band of
``tests/test_models.py::test_decode_matches_forward``, since the two
frameworks round bf16 at different places. The prefill attention is the
flash kernel's plain version here (CPU tensors); the reference's is
``chunked_attention``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import n, t
from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke_config as ref_get_smoke
from repro.models import common as ref_common
from repro.models import ffn as ref_ffn
from repro.models.registry import build as ref_build
from repro.train.serve_step import make_serve_step as ref_make_serve_step
from repro_torch.configs import ARCHS, PORTED, get_config, get_smoke_config
from repro_torch.kernels import flash_attention as port_flash
from repro_torch.launch import serve_lm
from repro_torch.models import common, ffn, lm
from repro_torch.models.common import ModelConfig
from repro_torch.models.registry import build
from repro_torch.train.serve_step import make_prefill, make_serve_step

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
BAND = {"f32": 1e-4, "bf16": 0.02}


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / (np.abs(want).max() + 1e-9)


def _f32(a):
    """torch tensor or JAX array -> float32 numpy."""
    if isinstance(a, torch.Tensor):
        return n(a.float())
    return np.asarray(a, np.float32)


def _pair(arch, dt):
    """(reference model, reference params, port model, port params)."""
    jdt, tdt = DTYPES[dt]
    rcfg = dataclasses.replace(ref_get_smoke(arch), dtype=jdt)
    pcfg = dataclasses.replace(get_smoke_config(arch), dtype=tdt)
    rm = ref_build(rcfg)
    rp = rm.init_params(jax.random.PRNGKey(0))
    pp = lm.params_from_numpy(jax.tree.map(np.asarray, rp), "cpu")
    return rm, rp, build(pcfg), pp


def _tokens(cfg, b, s, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s),
                                                dtype=np.int32)


def _cfg_dict(cfg):
    d = dataclasses.asdict(cfg)
    d["dtype"] = str(jnp.dtype(d["dtype"])) if not isinstance(
        d["dtype"], torch.dtype) else str(d["dtype"]).removeprefix("torch.")
    return d


# ------------------------------------------------------------------ configs
def test_model_config_fields_and_defaults_match():
    def fields(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)
                if f.name != "dtype"]

    assert fields(ModelConfig) == fields(ref_common.ModelConfig)
    assert ModelConfig.__dataclass_fields__["dtype"].default is torch.bfloat16


@pytest.mark.parametrize("which", ["CONFIG", "SMOKE"])
@pytest.mark.parametrize("arch", PORTED)
def test_configs_match_reference(arch, which):
    ref = (ref_get_config if which == "CONFIG" else ref_get_smoke)(arch)
    port = (get_config if which == "CONFIG" else get_smoke_config)(arch)
    assert _cfg_dict(port) == _cfg_dict(ref)
    assert (port.hd, port.kv_heads, port.num_params(),
            port.num_active_params()) == (ref.hd, ref.kv_heads,
                                          ref.num_params(),
                                          ref.num_active_params())


def test_qwen2_0_5b_is_half_a_billion_parameters():
    assert get_config("qwen2-0.5b").num_params() == 494_004_224


@pytest.mark.parametrize("arch", sorted(set(ARCHS) - set(PORTED)))
def test_unported_archs_raise(arch):
    with pytest.raises(NotImplementedError, match="item 6"):
        get_smoke_config(arch)


@pytest.mark.parametrize("kind", ["moe", "ssm", "hybrid", "encdec"])
def test_build_raises_on_unported_families(kind):
    cfg = ModelConfig(arch="x", kind=kind, n_layers=1, d_model=64,
                      n_heads=4, d_ff=128, vocab=64, n_experts=4, top_k=1)
    with pytest.raises(NotImplementedError, match="item 6"):
        build(cfg)


def test_tensor_parallel_config_raises():
    with pytest.raises(NotImplementedError, match="item 6"):
        dataclasses.replace(get_smoke_config("qwen2-0.5b"), tp_axis="model")


# ------------------------------------------------------------------- layers
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_rms_norm_matches_reference(dt):
    jdt, tdt = DTYPES[dt]
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 64)).astype(np.float32) * 3
    s = rng.normal(size=(64,)).astype(np.float32) * 0.1
    want = ref_common.rms_norm(jnp.asarray(x).astype(jdt),
                               jnp.asarray(s).astype(jdt), 1e-6)
    got = common.rms_norm(t(x).to(tdt), t(s).to(tdt), 1e-6)
    assert got.dtype == tdt
    assert _rel(_f32(got), _f32(want)) <= (1e-6 if dt == "f32" else 8e-3)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_matches_reference(dt, theta):
    jdt, tdt = DTYPES[dt]
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 37, 3, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(37, dtype=np.int32) + 500, (2, 37))
    want = ref_common.rope(jnp.asarray(x).astype(jdt), jnp.asarray(pos),
                           theta)
    got = common.rope(t(x).to(tdt), t(pos), theta)
    assert got.dtype == tdt
    assert _rel(_f32(got), _f32(want)) <= (1e-5 if dt == "f32" else 8e-3)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("act", ["swiglu", "geglu"])
def test_gated_ffn_matches_reference(dt, act):
    jdt, tdt = DTYPES[dt]
    rng = np.random.default_rng(2)
    arrs = [rng.normal(size=s).astype(np.float32) / np.sqrt(s[0])
            for s in ((4, 9, 64), (64, 96), (64, 96), (96, 64))]
    want = ref_ffn.gated_ffn(*(jnp.asarray(a).astype(jdt) for a in arrs),
                             act)
    got = ffn.gated_ffn(*(t(a).to(tdt) for a in arrs), act)
    assert _rel(_f32(got), _f32(want)) <= (1e-5 if dt == "f32" else BAND[dt])


def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-4, 4, 101, dtype=np.float32)
    want = jax.nn.gelu(jnp.asarray(x))
    got = common.act_fn("geglu")(t(x))
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_repeat_kv_and_plain_ffn_match_reference():
    from repro.models.attention import repeat_kv as ref_repeat_kv

    from repro_torch.models.attention import repeat_kv
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 5, 3, 8)).astype(np.float32)
    for g in (1, 4):
        np.testing.assert_array_equal(n(repeat_kv(t(x), g)),
                                      np.asarray(ref_repeat_kv(
                                          jnp.asarray(x), g)))
    arrs = [rng.normal(size=s).astype(np.float32) / np.sqrt(s[-1])
            for s in ((4, 9, 32), (32, 48), (48,), (48, 32), (32,))]
    want = ref_ffn.plain_ffn(*(jnp.asarray(a) for a in arrs), "gelu")
    got = ffn.plain_ffn(*(t(a) for a in arrs), "gelu")
    assert _rel(n(got), np.asarray(want)) < 1e-5


def test_sinusoidal_positions_match_reference():
    np.testing.assert_allclose(n(common.sinusoidal_positions(50, 32)),
                               np.asarray(ref_common.sinusoidal_positions(
                                   50, 32)), rtol=1e-5, atol=1e-5)


# -------------------------------------------------------------------- model
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("arch", PORTED)
def test_forward_and_logits_match_reference(arch, dt):
    rm, rp, pm, pp = _pair(arch, dt)
    tok = _tokens(pm.cfg, 2, 24)
    rh, _ = rm.forward(rp, jnp.asarray(tok))
    ph, aux = pm.forward(pp, t(tok))
    assert ph.dtype == DTYPES[dt][1] and float(aux) == 0.0
    assert _rel(_f32(ph), _f32(rh)) < BAND[dt]
    assert _rel(_f32(pm.logits(pp, ph)), _f32(rm.logits(rp, rh))) < BAND[dt]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("arch", PORTED)
def test_decode_steps_match_reference(arch, dt):
    """16 cached decode steps, logits compared at every step."""
    rm, rp, pm, pp = _pair(arch, dt)
    b, s = 2, 16
    tok = _tokens(pm.cfg, b, s, seed=2)
    rc, pc = rm.init_cache(b, s), pm.init_cache(b, s, "cpu")
    step = jax.jit(rm.decode_step)
    for i in range(s):
        rl, rc = step(rp, jnp.asarray(tok[:, i:i + 1]), rc,
                      jnp.asarray(i, jnp.int32))
        pl, pc = pm.decode_step(pp, t(tok[:, i:i + 1]), pc, i)
        assert pl.shape == (b, 1, pm.cfg.vocab)
        assert _rel(_f32(pl), _f32(rl)) < BAND[dt], (arch, dt, i)
    assert _rel(_f32(pc["k"]), _f32(rc["k"])) < BAND[dt]
    assert _rel(_f32(pc["v"]), _f32(rc["v"])) < BAND[dt]


def test_sinusoidal_dense_model_matches_reference():
    """A dense config with ``pos='sinusoidal'`` (as whisper's decoder
    has): forward and decode against the reference, in f32."""
    jcfg = dataclasses.replace(ref_get_smoke("qwen2-0.5b"), pos="sinusoidal",
                               dtype=jnp.float32)
    pcfg = dataclasses.replace(get_smoke_config("qwen2-0.5b"),
                               pos="sinusoidal", dtype=torch.float32)
    rm, pm = ref_build(jcfg), build(pcfg)
    rp = rm.init_params(jax.random.PRNGKey(0))
    pp = lm.params_from_numpy(jax.tree.map(np.asarray, rp), "cpu")
    tok = _tokens(pcfg, 2, 12)
    rh, _ = rm.forward(rp, jnp.asarray(tok))
    ph, _ = pm.forward(pp, t(tok))
    assert _rel(n(ph), np.asarray(rh)) < BAND["f32"]
    rc, pc = rm.init_cache(2, 12), pm.init_cache(2, 12, "cpu")
    for i in range(12):
        rl, rc = rm.decode_step(rp, jnp.asarray(tok[:, i:i + 1]), rc,
                                jnp.asarray(i, jnp.int32))
        pl, pc = pm.decode_step(pp, t(tok[:, i:i + 1]), pc, i)
        assert _rel(n(pl), np.asarray(rl)) < BAND["f32"], i


@pytest.mark.parametrize("arch", PORTED)
def test_decode_matches_forward(arch):
    """Step-by-step decode reproduces teacher-forced logits (the port of
    ``tests/test_models.py::test_decode_matches_forward``)."""
    _, _, m, params = _pair(arch, "bf16")
    b, s = 2, 16
    tok = t(_tokens(m.cfg, b, s))
    h, _ = m.forward(params, tok)
    ref = _f32(m.logits(params, h))
    cache = m.init_cache(b, s, "cpu")
    outs = []
    for i in range(s):
        lg, cache = m.decode_step(params, tok[:, i:i + 1], cache, i)
        outs.append(_f32(lg[:, 0]))
    assert _rel(np.stack(outs, axis=1), ref) < 0.02


@pytest.mark.parametrize("arch", PORTED)
def test_serve_step_greedy_tokens_match_reference(arch):
    rm, rp, pm, pp = _pair(arch, "f32")
    b, prompt_len, new = 2, 8, 8
    tok = _tokens(pm.cfg, b, prompt_len, seed=3)
    rserve = jax.jit(ref_make_serve_step(rm.cfg))
    pserve = make_serve_step(pm.cfg)
    rc = rm.init_cache(b, prompt_len + new)
    pc = pm.init_cache(b, prompt_len + new, "cpu")
    for i in range(prompt_len):
        rn, rc = rserve(rp, jnp.asarray(tok[:, i:i + 1]), rc,
                        jnp.asarray(i, jnp.int32))
        pn, pc = pserve(pp, t(tok[:, i:i + 1]), pc, i)
    rgen, pgen = [np.asarray(rn)], [n(pn)]
    for i in range(prompt_len, prompt_len + new - 1):
        rn, rc = rserve(rp, rn, rc, jnp.asarray(i, jnp.int32))
        pn, pc = pserve(pp, pn, pc, i)
        rgen.append(np.asarray(rn))
        pgen.append(n(pn))
    np.testing.assert_array_equal(np.concatenate(pgen, 1),
                                  np.concatenate(rgen, 1))


def test_prefill_is_the_forward_and_launches_no_kernel_on_cpu():
    _, _, m, params = _pair("qwen2-0.5b", "f32")
    tok = t(_tokens(m.cfg, 2, 20))
    before = port_flash.flash_attention.launches
    h, _ = make_prefill(m.cfg)(params, tok)
    want, _ = m.forward(params, tok)
    assert torch.equal(h, want)
    assert port_flash.flash_attention.launches == before == 0


@pytest.mark.parametrize("arch", PORTED)
def test_init_cache_shapes(arch):
    cfg = get_smoke_config(arch)
    ref = ref_build(ref_get_smoke(arch)).init_cache(3, 11)
    got = build(cfg).init_cache(3, 11, "cpu")
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in ref.items()}
    assert all(v.dtype == torch.bfloat16 and not v.any()
               for v in got.values())


def test_init_params_keys_and_shapes_match_reference():
    cfg = get_smoke_config("qwen2-7b")      # untied: has an unembed
    ref = ref_build(ref_get_smoke("qwen2-7b")).init_params(
        jax.random.PRNGKey(0))
    got = build(cfg).init_params(torch.Generator().manual_seed(0))
    shapes = jax.tree.map(lambda a: tuple(a.shape), ref)
    assert jax.tree.map(lambda a: tuple(a.shape), got) == shapes


def test_update_cache_writes_in_place():
    cfg = get_smoke_config("qwen2-0.5b")
    m = build(cfg)
    params = m.init_params(torch.Generator().manual_seed(0))
    cache = m.init_cache(1, 4, "cpu")
    k_before = cache["k"]
    _, out = m.decode_step(params, torch.tensor([[3]]), cache, 2)
    assert out["k"] is k_before
    assert k_before[:, :, 2].any() and not k_before[:, :, 3].any()


# ----------------------------------------------------------------- launcher
def test_serve_lm_on_cpu_prints_the_reference_lines(capsys):
    serve_lm.main(["--device", "cpu", "--batch", "2", "--prompt-len", "6",
                   "--tokens", "5"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 3
    assert lines[0].startswith("prefill: ") and "tok/s" in lines[0]
    assert lines[1].startswith("arch=qwen2-0.5b generated 5 tokens x batch 2")
    assert lines[2].startswith("first row: [")
    row = eval(lines[2].removeprefix("first row: "))
    assert len(row) == 5 and all(0 <= x < 512 for x in row)


def test_serve_lm_without_a_card_raises():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_lm.main(["--tokens", "2"])
