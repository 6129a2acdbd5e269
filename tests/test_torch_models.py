"""The port's LM (``repro_torch.models``, ``configs``, ``train``,
``launch.serve_lm``) against the reference's, on the SMOKE configs of all
ten archs (the dense, vlm, moe, ssm, hybrid and encdec kinds), with the
reference's parameters from ``PRNGKey(0)`` carried across by
``params_from_numpy``.

Bands (``tests/_torch_lm.py``): 1e-4 relative (max |diff| / max |ref|) in
f32, where only the order of sums differs; 0.02 relative in bf16, the band
of ``tests/test_models.py::test_decode_matches_forward``, against the
reference run op by op (see ``_torch_lm``). The prefill attention is the
flash kernel's plain version here (CPU tensors); the reference's is
``chunked_attention``. Per kind, as the reference's own tests do: the SSM
takes a multiple of its chunk, the encoder-decoder frames, the vlm prefix
embeddings, and decode == forward runs the MoE at capacity_factor 100 (no
drops).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm import (BAND, DTYPES, aux_input, caches, f32, jnp_or_none,
                       leaves, pair, ref_mode, rel, seq_len, t_or_none,
                       tokens)
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

# the kinds this slice added
NEW_KIND_ARCHS = ("llama4-maverick-400b-a17b", "dbrx-132b",
                  "recurrentgemma-2b", "whisper-base", "internvl2-26b",
                  "mamba2-2.7b")


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
    assert (port.attention_free, port.subquadratic, port._full_pattern()) \
        == (ref.attention_free, ref.subquadratic, ref._full_pattern())


def test_qwen2_0_5b_is_half_a_billion_parameters():
    assert get_config("qwen2-0.5b").num_params() == 494_004_224


def test_every_arch_is_ported():
    assert PORTED == ARCHS


def test_build_raises_on_an_unknown_kind():
    cfg = ModelConfig(arch="x", kind="bogus", n_layers=1, d_model=64,
                      n_heads=4, d_ff=128, vocab=64)
    with pytest.raises(ValueError, match="unknown model kind"):
        build(cfg)


def test_tensor_parallel_config_raises():
    """``tp_axis`` names an axis of the DeviceMesh: the config is legal, a
    plain tensor passes ``constrain`` unchanged, and a DTensor on a mesh
    without that axis raises."""
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.sharding import rules

    cfg = dataclasses.replace(get_smoke_config("qwen2-0.5b"), tp_axis="pod")
    x = torch.ones(2, 8)
    assert common.constrain(x, cfg, ("dp", "tp")) is x
    assert not torch.distributed.is_initialized()
    mesh = mesh_lib.make_debug_mesh(1, 1, device="cpu")
    try:
        dx = distribute_tensor(x, mesh, [Replicate(), Replicate()])
        with pytest.raises(ValueError, match="no axis 'pod'"):
            common.constrain(dx, cfg, ("dp", "tp"))
        ok = dataclasses.replace(cfg, tp_axis="model", dp_axes=("data",))
        assert common.constrain(dx, ok, ("dp", "tp")).placements == \
            rules.placements(rules.Spec("data", "model"), mesh)
    finally:
        mesh_lib.stop_group()


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
    assert rel(f32(got), f32(want)) <= (1e-6 if dt == "f32" else 8e-3)


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
    assert rel(f32(got), f32(want)) <= (1e-5 if dt == "f32" else 8e-3)


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
    assert rel(f32(got), f32(want)) <= (1e-5 if dt == "f32" else BAND[dt])


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_activations_match_reference_bitwise_in_bf16(act):
    """``common.silu`` and ``gelu`` chain the reference's ops in the input
    dtype: equal to ``jax.nn.silu`` / ``jax.nn.gelu`` bit for bit in bf16,
    where torch's fused versions, rounding once, are not."""
    x = np.random.default_rng(4).normal(size=(20000,)).astype(np.float32) * 4
    want = f32(getattr(jax.nn, act)(jnp.asarray(x, jnp.bfloat16)))
    xt = t(x).to(torch.bfloat16)
    np.testing.assert_array_equal(f32(getattr(common, act)(xt)), want)
    fused = (torch.nn.functional.silu(xt) if act == "silu" else
             torch.nn.functional.gelu(xt, approximate="tanh"))
    assert (f32(fused) != want).any()


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
    assert rel(n(got), np.asarray(want)) < 1e-5


def test_sinusoidal_positions_match_reference():
    np.testing.assert_allclose(n(common.sinusoidal_positions(50, 32)),
                               np.asarray(ref_common.sinusoidal_positions(
                                   50, 32)), rtol=1e-5, atol=1e-5)


# -------------------------------------------------------------------- model
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("arch", PORTED)
def test_forward_and_logits_match_reference(arch, dt):
    rm, rp, pm, pp = pair(arch, dt)
    tok = tokens(pm.cfg, 2, seq_len(pm.cfg, 24))
    aux = aux_input(pm.cfg, 2)
    with ref_mode(dt):
        rh, raux = rm.forward(rp, jnp.asarray(tok), jnp_or_none(aux))
        rl = rm.logits(rp, rh)
    ph, paux = pm.forward(pp, t(tok), t_or_none(aux))
    assert ph.dtype == DTYPES[dt][1] and ph.shape == rh.shape
    assert rel(f32(ph), f32(rh)) < BAND[dt]
    assert rel(f32(pm.logits(pp, ph)), f32(rl)) < BAND[dt]
    assert paux.dtype == torch.float32
    if pm.cfg.kind == "moe":
        assert float(paux) > 0
        assert abs(float(paux) - float(raux)) <= BAND[dt] * float(raux)
    else:
        assert float(paux) == float(raux) == 0.0


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("arch", PORTED)
def test_decode_steps_match_reference(arch, dt):
    """16 cached decode steps, logits compared at every step, and every
    leaf of the cache after them."""
    rm, rp, pm, pp = pair(arch, dt)
    b, s = 2, 16
    tok = tokens(pm.cfg, b, s, seed=2)
    with ref_mode(dt):
        rc, pc = caches(rm, rp, pm, pp, b, s, aux_input(pm.cfg, b))
        step = jax.jit(rm.decode_step)
        for i in range(s):
            rl, rc = step(rp, jnp.asarray(tok[:, i:i + 1]), rc,
                          jnp.asarray(i, jnp.int32))
            pl, pc = pm.decode_step(pp, t(tok[:, i:i + 1]), pc, i)
            assert pl.shape == (b, 1, pm.cfg.vocab)
            assert rel(f32(pl), f32(rl)) < BAND[dt], (arch, dt, i)
    want = leaves(rc)
    got = leaves(pc)
    assert got.keys() == want.keys()
    for k in want:
        assert rel(f32(got[k]), f32(want[k])) < BAND[dt], k


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
    tok = tokens(pcfg, 2, 12)
    rh, _ = rm.forward(rp, jnp.asarray(tok))
    ph, _ = pm.forward(pp, t(tok))
    assert rel(n(ph), np.asarray(rh)) < BAND["f32"]
    rc, pc = rm.init_cache(2, 12), pm.init_cache(2, 12, "cpu")
    for i in range(12):
        rl, rc = rm.decode_step(rp, jnp.asarray(tok[:, i:i + 1]), rc,
                                jnp.asarray(i, jnp.int32))
        pl, pc = pm.decode_step(pp, t(tok[:, i:i + 1]), pc, i)
        assert rel(n(pl), np.asarray(rl)) < BAND["f32"], i


@pytest.mark.parametrize("arch", PORTED)
def test_decode_matches_forward(arch):
    """Step-by-step decode reproduces teacher-forced logits (the port of
    ``tests/test_models.py::test_decode_matches_forward``: the MoE at
    capacity_factor 100, the encoder-decoder with its frames)."""
    cap = {"capacity_factor": 100.0} if get_smoke_config(
        arch).kind == "moe" else {}
    _, _, m, params = pair(arch, "bf16", **cap)
    b, s = 2, 16
    tok = t(tokens(m.cfg, b, s))
    frames = aux_input(m.cfg, b)
    use = t(frames) if m.cfg.kind == "encdec" else None
    h, _ = m.forward(params, tok, use)
    ref = f32(m.logits(params, h))
    cache = m.init_cache(b, s, "cpu")
    if m.cfg.kind == "encdec":
        from repro_torch.models import whisper
        cache = whisper.prefill_cross(m.cfg, params, cache, use)
    outs = []
    for i in range(s):
        lg, cache = m.decode_step(params, tok[:, i:i + 1], cache, i)
        outs.append(f32(lg[:, 0]))
    assert rel(np.stack(outs, axis=1), ref) < 0.02


@pytest.mark.parametrize("arch", PORTED)
def test_serve_step_greedy_tokens_match_reference(arch):
    rm, rp, pm, pp = pair(arch, "f32")
    b, prompt_len, new = 2, 8, 8
    tok = tokens(pm.cfg, b, prompt_len, seed=3)
    rserve = jax.jit(ref_make_serve_step(rm.cfg))
    pserve = make_serve_step(pm.cfg)
    rc, pc = caches(rm, rp, pm, pp, b, prompt_len + new, aux_input(pm.cfg, b))
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
    _, _, m, params = pair("qwen2-0.5b", "f32")
    tok = t(tokens(m.cfg, 2, 20))
    before = port_flash.flash_attention.launches
    h, _ = make_prefill(m.cfg)(params, tok)
    want, _ = m.forward(params, tok)
    assert torch.equal(h, want)
    assert port_flash.flash_attention.launches == before == 0


@pytest.mark.parametrize("arch", PORTED)
def test_init_cache_shapes(arch):
    cfg = get_smoke_config(arch)
    ref = leaves(ref_build(ref_get_smoke(arch)).init_cache(3, 11))
    got = leaves(build(cfg).init_cache(3, 11, "cpu"))
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in ref.items()}
    for k, v in got.items():
        assert str(v.dtype).removeprefix("torch.") == str(ref[k].dtype), k
        assert not v.any(), k


@pytest.mark.parametrize("arch", PORTED)
def test_init_params_keys_and_shapes_match_reference(arch):
    ref = ref_build(ref_get_smoke(arch)).init_params(jax.random.PRNGKey(0))
    got = build(get_smoke_config(arch)).init_params(
        torch.Generator().manual_seed(0))
    assert jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype).removeprefix(
        "torch.")), got) == jax.tree.map(lambda a: (tuple(a.shape),
                                                     str(a.dtype)), ref)


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


@pytest.mark.parametrize("arch", NEW_KIND_ARCHS)
def test_serve_lm_on_cpu_runs_every_new_kind(arch, capsys):
    """Each kind this slice added, at its smoke config, in the reference
    launcher's two-line form after the prefill line."""
    serve_lm.main(["--device", "cpu", "--arch", arch, "--batch", "2",
                   "--prompt-len", "16", "--tokens", "4"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 3 and lines[0].startswith("prefill: ")
    assert lines[1].startswith(f"arch={arch} generated 4 tokens x batch 2")
    row = eval(lines[2].removeprefix("first row: "))
    vocab = get_smoke_config(arch).vocab
    assert len(row) == 4 and all(0 <= x < vocab for x in row)


def test_serve_lm_refuses_an_ssm_prompt_off_its_chunk(capsys):
    with pytest.raises(SystemExit):
        serve_lm.main(["--device", "cpu", "--arch", "mamba2-2.7b",
                       "--prompt-len", "20"])
    err = capsys.readouterr().err
    assert "--prompt-len 20" in err and "multiple of 16" in err


def test_serve_lm_without_a_card_raises():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_lm.main(["--tokens", "2"])
