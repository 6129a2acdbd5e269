"""Helpers shared by the tests that hold the port's LM families against the
reference: a reference model and the port's on the reference's parameters,
seeded inputs, and the bands.

Bands: 1e-4 relative (max |diff| / max |ref|) in f32, where only the order
of sums differs; 0.02 relative in bf16, the band of
``tests/test_models.py::test_decode_matches_forward``.

In bf16 the reference is run op by op (``jax.disable_jit``): XLA fuses its
scanned layers and then rounds differently from its own code as written;
on llama4's smoke config its top-1 routes differ between the fused and
the op-by-op run (``tests/test_torch_moe.py``).
The port computes every op in the model's dtype as the code is written
(``models.common.silu`` and ``gelu`` included), so it is held to the run
that rounds as written. In f32 both runs agree within 1e-6, and the fused
run is used.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_parity import n, t
from repro.configs import get_smoke_config as ref_get_smoke
from repro.models import whisper as ref_whisper
from repro.models.registry import build as ref_build
from repro_torch.configs import get_smoke_config
from repro_torch.models import lm, whisper
from repro_torch.models.registry import build

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
BAND = {"f32": 1e-4, "bf16": 0.02}


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / (np.abs(want).max() + 1e-9)


def f32(a):
    """torch tensor or JAX array -> float32 numpy."""
    if isinstance(a, torch.Tensor):
        return n(a.float())
    return np.asarray(a, np.float32)


def ref_mode(dt):
    """The context the reference runs in for dtype ``dt`` (see above)."""
    return jax.disable_jit() if dt == "bf16" else contextlib.nullcontext()


def pair(arch, dt, **replace):
    """(reference model, reference params from PRNGKey(0), port model, the
    same params as torch tensors on the CPU) at the arch's smoke config."""
    jdt, tdt = DTYPES[dt]
    rcfg = dataclasses.replace(ref_get_smoke(arch), dtype=jdt, **replace)
    pcfg = dataclasses.replace(get_smoke_config(arch), dtype=tdt, **replace)
    rm = ref_build(rcfg)
    rp = rm.init_params(jax.random.PRNGKey(0))
    pp = lm.params_from_numpy(jax.tree.map(np.asarray, rp), "cpu")
    return rm, rp, build(pcfg), pp


def tokens(cfg, b, s, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s),
                                                dtype=np.int32)


def seq_len(cfg, s):
    """s rounded up to the SSM's chunk (the only length rule of a kind)."""
    if cfg.kind == "ssm":
        return -(-s // cfg.ssm_chunk) * cfg.ssm_chunk
    return s


def aux_input(cfg, b, seed=2):
    """The stub frontend's input: frames (encdec) or prefix embeddings
    (vlm), 0.1 x normal from a numpy seed; None for the other kinds."""
    rng = np.random.default_rng(seed)
    if cfg.kind == "encdec":
        return 0.1 * rng.normal(size=(b, cfg.enc_seq, cfg.d_model)).astype(
            np.float32)
    if cfg.kind == "vlm":
        return 0.1 * rng.normal(size=(b, cfg.frontend_tokens,
                                      cfg.d_model)).astype(np.float32)
    return None


def jnp_or_none(a):
    return None if a is None else jnp.asarray(a)


def t_or_none(a):
    return None if a is None else t(a)


def caches(rm, rp, pm, pp, b, s_max, frames=None):
    """Both decode caches; the encoder-decoder's with the cross K/V of
    ``frames`` written by each side's ``prefill_cross``."""
    rc, pc = rm.init_cache(b, s_max), pm.init_cache(b, s_max, "cpu")
    if pm.cfg.kind == "encdec":
        rc = ref_whisper.prefill_cross(rm.cfg, rp, rc, jnp.asarray(frames))
        pc = whisper.prefill_cross(pm.cfg, pp, pc, t(frames))
    return rc, pc


def leaves(tree, prefix=""):
    """{path: leaf} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(leaves(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def batches(cfg, b=2, s=16, seed=1):
    """A training batch for both packages, (reference's, port's): tokens,
    and the stub frontend's input for the encoder-decoder and the vlm."""
    tok = tokens(cfg, b, s, seed)
    aux = aux_input(cfg, b)
    rb, pb = {"tokens": jnp.asarray(tok)}, {"tokens": t(tok)}
    if aux is not None:
        rb["frontend"], pb["frontend"] = jnp.asarray(aux), t(aux)
    return rb, pb
