"""Training on a DeviceMesh, on the CPU: the tensor-parallel and bf16-p
forwards against the reference's, the launcher's ``--mesh debug`` step
against its meshless step bit for bit, DTensor checkpoints and the mesh
form of elastic resharding.

The mesh is the 1 x 1 ``make_debug_mesh`` on a gloo process group of one
(the module's fixture starts it and destroys it). On it every op runs on
the same local tensors as without a mesh, so the two runs agree bit for
bit; the reference's constraints run on its own 1-device mesh.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from _torch_lm import BAND, f32, pair, rel, tokens
from repro.launch.mesh import make_debug_mesh as ref_debug_mesh
from repro_torch.ckpt.checkpoint import Checkpointer
from repro_torch.configs import get_smoke_config
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import train as train_launcher
from repro_torch.models import common
from repro_torch.runtime import elastic
from repro_torch.sharding import rules
from repro_torch.train import optimizer as opt

KNOBS = {
    "tp": dict(tp_axis="model", dp_axes=("data",)),
    "tp_seq_parallel": dict(tp_axis="model", dp_axes=("data",), tp_size=1),
    "p_bf16": dict(attn_p_bf16=True),
    "tp_p_bf16_dp_only": dict(tp_axis="model", dp_axes=("data",),
                              attn_p_bf16=True, attn_dp_only=True),
    "tp_p_bf16_seq": dict(tp_axis="model", dp_axes=("data",), tp_size=1,
                          attn_p_bf16=True),
}


@pytest.fixture(scope="module")
def mesh():
    assert not torch.distributed.is_initialized()
    m = mesh_lib.make_debug_mesh(1, 1, device="cpu")
    try:
        yield m
    finally:
        mesh_lib.stop_group()


def leaves_equal(a, b) -> bool:
    la, lb = opt.tree_leaves(a), opt.tree_leaves(b)
    return len(la) == len(lb) and all(
        torch.equal(x.full_tensor() if isinstance(x, DTensor) else x,
                    y.full_tensor() if isinstance(y, DTensor) else y)
        for x, y in zip(la, lb))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("knobs", list(KNOBS))
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "dbrx-132b"])
def test_knob_forwards_match_the_reference(mesh, arch, knobs, dt):
    """The forward with the reference's performance knobs, meshless and on
    the mesh (DTensor parameters), against the reference's forward with the
    same flags under its 1-device mesh."""
    rm, rp, pm, pp = pair(arch, dt, **KNOBS[knobs])
    tok = tokens(pm.cfg, 2, 64)
    with ref_debug_mesh(1, 1):
        rh, _ = jax.jit(rm.forward)(rp, jnp.asarray(tok))
    ph, _ = pm.forward(pp, torch.from_numpy(tok))
    assert rel(f32(ph), f32(rh)) < BAND[dt]
    dp = rules.distribute(pp, rules.param_specs(pm.cfg, pp, mesh), mesh)
    dtok = rules.place(torch.from_numpy(tok), mesh, rules.batch_spec(mesh))
    dh, _ = pm.forward(dp, dtok)
    assert isinstance(dh, DTensor)
    assert torch.equal(dh.full_tensor(), ph)


def test_a_p_bf16_forward_rounds_p():
    """attn_p_bf16 changes the f32 forward (p rounded to bf16), as the
    reference's flag does; the knobs alone do not."""
    _, _, pm, pp = pair("qwen2-0.5b", "f32")
    _, _, pb, _ = pair("qwen2-0.5b", "f32", attn_p_bf16=True)
    _, _, pt, _ = pair("qwen2-0.5b", "f32", **KNOBS["tp"])
    tok = torch.from_numpy(tokens(pm.cfg, 2, 64))
    h, _ = pm.forward(pp, tok)
    assert not torch.equal(pb.forward(pp, tok)[0], h)
    assert rel(f32(pb.forward(pp, tok)[0]), f32(h)) < 1e-2
    assert torch.equal(pt.forward(pp, tok)[0], h)


def run_launcher(mesh_obj, steps=2, arch="qwen2-0.5b", tmp=None):
    args = types.SimpleNamespace(seq=32, batch=2, microbatches=1,
                                 steps=steps, ckpt_dir=str(tmp),
                                 ckpt_every=steps)
    return train_launcher._train(args, get_smoke_config(arch),
                                 torch.device("cpu"), mesh_obj)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mamba2-2.7b"])
def test_launcher_mesh_step_equals_the_meshless_step(mesh, arch, tmp_path):
    """``launch.train --device cpu --mesh debug``'s loop against the same
    loop without a mesh: every loss, parameter and optimizer-state leaf
    bit for bit, and every leaf of the mesh run a DTensor."""
    _, log0, p0, s0 = run_launcher(None, arch=arch, tmp=tmp_path / "plain")
    _, log1, p1, s1 = run_launcher(mesh, arch=arch, tmp=tmp_path / "mesh")
    assert [m["loss"] for m in log0] == [m["loss"] for m in log1]
    assert all(isinstance(x, DTensor) for x in opt.tree_leaves(p1))
    assert all(isinstance(x, DTensor) for x in opt.tree_leaves(s1))
    assert leaves_equal(p0, p1) and leaves_equal(s0, s1)
    # the checkpoints hold the same full arrays
    c0, c1 = Checkpointer(str(tmp_path / "plain")), Checkpointer(
        str(tmp_path / "mesh"))
    f0, f1 = c0.restore_flat()[1], c1.restore_flat()[1]
    assert sorted(f0) == sorted(f1)
    assert all(np.array_equal(f0[k], f1[k]) for k in f0)


def test_launcher_prints_the_same_line_with_a_mesh(mesh, tmp_path, capsys):
    lines = []
    for extra in ([], ["--mesh", "debug"]):
        train_launcher.main(["--device", "cpu", "--steps", "2", "--batch",
                             "2", "--seq", "32", "--ckpt-dir",
                             str(tmp_path / str(len(extra)))] + extra)
        lines.append(capsys.readouterr().out.strip().splitlines()[-1])
    assert lines[0].split(";")[1] == lines[1].split(";")[1]
    assert torch.distributed.is_initialized()   # not the launcher's group


def test_production_mesh_refuses_a_small_group(mesh):
    with pytest.raises(RuntimeError, match="needs 256 ranks; the process "
                       "group has 1"):
        mesh_lib.make_production_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="needs 512 ranks"):
        mesh_lib.make_production_mesh(multi_pod=True, device="cpu")


def small_state(mesh):
    g = torch.Generator().manual_seed(3)
    state = {"w": torch.randn(8, 6, generator=g),
             "b": {"c": torch.randn(4, 6, generator=g).bfloat16(),
                   "step": torch.tensor(5, dtype=torch.int32)}}
    specs = {"w": rules.Spec("data", "model"),
             "b": {"c": rules.Spec(None, "model"), "step": rules.Spec()}}
    return state, specs


def test_reshard_state_places_each_leaf_by_its_spec(mesh):
    state, specs = small_state(mesh)
    out = elastic.reshard_state(state, specs, mesh)
    assert out["w"].placements == (Shard(0), Shard(1))
    assert out["b"]["c"].placements == (Replicate(), Shard(1))
    assert out["b"]["step"].placements == (Replicate(), Replicate())
    assert leaves_equal(out, state)
    # and back to the one-device shorthand through a checkpoint
    back = elastic.reshard_via_checkpoint(out, "cpu")
    assert not isinstance(back["w"], DTensor) and leaves_equal(back, state)


def test_reshard_via_checkpoint_to_a_mesh(mesh, tmp_path):
    """A DTensor state saved as its full tensors (the reference's layout)
    and restored with the target's placements, dtypes kept."""
    state, specs = small_state(mesh)
    src = elastic.reshard_state(state, specs, mesh)
    target = {"w": rules.Spec(None, "data"),
              "b": {"c": rules.Spec("data", None), "step": rules.Spec()}}
    out = elastic.reshard_via_checkpoint(src, target, mesh, str(tmp_path))
    assert out["w"].placements == (Shard(1), Replicate())
    assert out["b"]["c"].placements == (Shard(0), Replicate())
    assert out["b"]["c"].dtype == torch.bfloat16
    assert leaves_equal(out, state)
    _, flat, _ = Checkpointer(str(tmp_path)).restore_flat(0)
    assert np.array_equal(flat["w"], state["w"].numpy())
    # a plain state to the mesh, too
    out2 = elastic.reshard_via_checkpoint(state, specs, mesh)
    assert out2["w"].placements == (Shard(0), Shard(1))
    assert leaves_equal(out2, state)


def test_checkpoint_restores_a_dtensor_like_its_like_leaf(mesh, tmp_path):
    state, specs = small_state(mesh)
    like = elastic.reshard_state(state, specs, mesh)
    ck = Checkpointer(str(tmp_path))
    ck.save(1, like, blocking=True)
    _, out = ck.restore(1, like=like)
    for a, b in zip(opt.tree_leaves(out), opt.tree_leaves(like)):
        assert isinstance(a, DTensor) and a.placements == b.placements
    assert leaves_equal(out, state)


def test_gather_rows_on_a_mesh_equals_indexing(mesh):
    g = torch.Generator().manual_seed(0)
    table = torch.randn(50, 8, generator=g, requires_grad=True)
    idx = torch.randint(0, 50, (4, 6), generator=g)
    want = table[idx]
    want.sum().backward()
    dt = rules.place(table.detach(), mesh, rules.Spec("model", None))
    dt.requires_grad_(True)
    got = rules.gather_rows(dt, rules.place(idx, mesh,
                                            rules.batch_spec(mesh)))
    assert torch.equal(got.full_tensor(), want)
    got.sum().backward()
    assert torch.equal(dt.grad.full_tensor(), table.grad)


def test_mesh_ops_is_reentrant(mesh):
    from torch.distributed.tensor import distribute_tensor

    x = distribute_tensor(torch.ones(2, 2), mesh, [Replicate(), Replicate()])
    with common.mesh_ops():
        with common.mesh_ops():
            y = x * torch.ones(2, 2)
        y = y + torch.ones(2, 2)            # still allowed after the inner
    assert torch.equal(y.full_tensor(), torch.full((2, 2), 2.0))
    with pytest.raises(RuntimeError, match="mixed torch.Tensor and DTensor"):
        x * torch.ones(2, 2)


def test_flash_operator_takes_dtensors(mesh):
    """The registered operator on DTensors: the rule places q, k, v alike
    and the output takes q's placement; the values are the plain
    version's."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    g = torch.Generator().manual_seed(1)
    q = torch.randn(2, 24, 4, 16, generator=g)
    k = torch.randn(2, 24, 2, 16, generator=g)
    v = torch.randn(2, 24, 2, 16, generator=g)
    for spec in (rules.Spec("data"), rules.Spec(None, None, "model"),
                 rules.Spec()):
        dq, dk, dv = (rules.place(t, mesh, spec) for t in (q, k, v))
        out = ops.flash_attention(dq, dk, dv, causal=True)
        assert out.placements == dq.placements
        assert torch.equal(out.full_tensor(),
                           fa.flash_attention_plain(q, k, v))
