"""The port's roofline counters: FLOPs of a sharded matmul on a fake
16 x 16 mesh, the flash operator's formula, and the count of a whole
forward against the reference's HLO parser.

The reference's ``hlo_parser.analyze_text`` counts the dots of the
compiled forward: its attention is ``chunked_attention``, which computes
every (q, kv) chunk pair over chunks padded to 512 queries and 1,024 keys.
The port's forward launches the flash operator, counted at 4 * hd FLOPs a
pair its mask lets through (the causal half). The projections and the FFN
are the same dots in both. So the port's count equals the reference's
with the padded chunks' attention taken out and the causal pairs' put in,
exactly; at 1,024 tokens of the qwen2 SMOKE config that is 0.61 of the
reference's count, the band the test states.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import get_smoke_config as ref_smoke
from repro.models import lm as ref_lm
from repro.models.registry import build as ref_build
from repro.roofline.hlo_parser import analyze_text
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import lm
from repro_torch.roofline import analysis


@pytest.fixture(scope="module")
def pod():
    assert not torch.distributed.is_initialized()
    mesh_lib.start_group("fake", 256)
    try:
        yield mesh_lib.make_production_mesh(device="cpu")
    finally:
        mesh_lib.stop_group()


def test_matmul_counts_this_ranks_share_on_a_fake_mesh(pod):
    """(4,096 x 896) @ (896 x 4,864) with rows over data and columns over
    model: each chip multiplies a 256 x 896 by a 896 x 304 block, 1/256 of
    the product; the collective is the all-gather of the columns."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    with FakeTensorMode():
        x = distribute_tensor(torch.empty(4096, 896), pod,
                              [Shard(0), Replicate()], src_data_rank=None)
        w = distribute_tensor(torch.empty(896, 4864), pod,
                              [Replicate(), Shard(1)], src_data_rank=None)
        with analysis.CostMode() as cost:
            y = x @ w
            y.redistribute(pod, [Shard(0), Replicate()])
    assert cost.flops == 2 * 256 * 896 * 304
    assert cost.flops * 256 == 2 * 4096 * 896 * 4864
    assert cost.by_op == {"aten.mm": cost.flops}
    assert cost.coll["all-gather"] == 256 * 4864 * 4
    assert cost.hbm_bytes >= (256 * 896 + 896 * 304 + 256 * 304) * 4
    roof = analysis.from_counts(cost, 256, model_flops=2 * 4096 * 896 * 4864)
    assert roof.useful_flops_ratio == pytest.approx(1.0)
    assert roof.t_compute == cost.flops / analysis.PEAK_FLOPS
    assert roof.bottleneck in ("compute", "memory", "collective")
    assert set(roof.row()) == {
        "t_compute_s", "t_memory_s", "t_collective_s", "bottleneck",
        "hlo_gflops_per_chip", "hbm_gbytes_per_chip", "coll_mbytes_per_chip",
        "coll_breakdown", "useful_flops_ratio"}


def brute_pairs(sq, skv, causal, window):
    i = np.arange(sq)[:, None]
    j = np.arange(skv)[None, :]
    ok = np.ones((sq, skv), bool)
    if causal:
        ok &= j <= i
    if window > 0:
        ok &= j > i - window
    return int(ok.sum())


@pytest.mark.parametrize("sq,skv,causal,window", [
    (40, 40, True, 0), (40, 40, True, 7), (33, 57, False, 0),
    (57, 33, True, 0), (64, 64, False, 16), (4096, 4096, True, 0)])
def test_flash_formula_counts_unmasked_pairs(sq, skv, causal, window):
    assert fa.unmasked_pairs(sq, skv, causal, window) == brute_pairs(
        sq, skv, causal, window)
    assert fa.flops((2, sq, 4, 16), (2, skv, 2, 16), causal, window) == \
        4 * 16 * 2 * 4 * brute_pairs(sq, skv, causal, window)


def test_flash_operator_meets_the_flop_counter():
    """FlopCounterMode counts the registered operator by its formula (the
    bound of ``PERF.md``: 240.6 GFLOP at 8 x 4,096, 14 heads of 64)."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 40, 4, 16, generator=g)
    k = torch.randn(2, 40, 2, 16, generator=g)
    v = torch.randn(2, 40, 2, 16, generator=g)
    with FlopCounterMode(display=False) as fc:
        out = torch.ops.repro_torch.flash_attention(q, k, v, True, 7)
    assert fc.get_total_flops() == fa.flops(q.shape, k.shape, True, 7)
    assert torch.equal(out, fa.flash_attention_plain(q, k, v, causal=True,
                                                     window=7))
    assert fa.flops((8, 4096, 14, 64), (8, 4096, 2, 64), True, 0) == \
        240_576_888_832


def test_flash_operator_on_fake_tensors_allocates_nothing():
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        q = torch.empty(8, 4096, 14, 64, dtype=torch.bfloat16)
        k = torch.empty(8, 4096, 2, 64, dtype=torch.bfloat16)
        with analysis.CostMode() as cost:
            out = torch.ops.repro_torch.flash_attention(q, k, k, True, 0)
    assert out.shape == q.shape and out.dtype == q.dtype
    assert cost.by_op == {"repro_torch.flash_attention": 240_576_888_832}
    assert cost.hbm_bytes == (2 * q.numel() + 2 * k.numel()) * 2


def test_forward_count_matches_the_reference_hlo_parser():
    b, s = 2, 1024
    rcfg = dataclasses.replace(ref_smoke("qwen2-0.5b"), dtype=jnp.float32)
    rp = ref_build(rcfg).init_params(jax.random.PRNGKey(0))
    tok = np.random.default_rng(0).integers(0, rcfg.vocab, (b, s),
                                            dtype=np.int32)
    compiled = jax.jit(lambda p, t: ref_lm.forward(rcfg, p, t)[0]).lower(
        rp, jnp.asarray(tok)).compile()
    ref_flops, _, ref_coll = analyze_text(compiled.as_text())

    cfg = dataclasses.replace(get_smoke_config("qwen2-0.5b"),
                              dtype=torch.float32)
    params = lm.params_from_numpy(jax.tree.map(np.asarray, rp), "cpu")
    roof, hidden = analysis.analyze(
        lambda: lm.forward(cfg, params, torch.from_numpy(tok)), 1)
    assert hidden[0].shape == (b, s, cfg.d_model)

    h, hd, layers = cfg.n_heads, cfg.hd, cfg.n_layers
    padded = layers * 4 * hd * b * h * (-(-s // 512) * 512) * (
        -(-s // 1024) * 1024)
    causal = layers * fa.flops((b, s, h, hd), (b, s, cfg.kv_heads, hd),
                               True, 0)
    assert roof.flops == ref_flops - padded + causal
    assert 0.60 < roof.flops / ref_flops < 0.62
    assert roof.coll_bytes == 0 and not any(ref_coll.values())
