"""The port's partitioning rules and meshes against the reference's.

The reference's specs are taken on ``jax.sharding.AbstractMesh``es of the
production shapes, which need no devices; the port's on torch
``DeviceMesh``es of the same shapes under torch's ``fake`` process group
at world 512 (ranks that exist only as names), which the module's fixture
starts and destroys. Every spec is compared with the reference's
``PartitionSpec`` entry by entry.
"""

import jax
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as P

from repro.configs import get_smoke_config as ref_smoke
from repro.launch import mesh as ref_mesh
from repro.models.registry import build as ref_build
from repro.sharding import rules as ref_rules
from repro_torch.configs import ARCHS, get_smoke_config
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.registry import build
from repro_torch.sharding import rules
from repro_torch.train import optimizer as opt

MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}


@pytest.fixture(scope="module")
def meshes():
    """The port's two production meshes (device type cpu) on a fake group
    of 512 ranks, destroyed after the module."""
    assert not torch.distributed.is_initialized()
    mesh_lib.start_group("fake", 512)
    try:
        yield {"pod": mesh_lib.make_production_mesh(device="cpu"),
               "multipod": mesh_lib.make_production_mesh(multi_pod=True,
                                                         device="cpu")}
    finally:
        mesh_lib.stop_group()


def ref_abstract(name):
    return AbstractMesh(*MESHES[name])


def same(spec, ref) -> bool:
    """A port spec equals a reference PartitionSpec entry by entry."""
    return isinstance(spec, rules.Spec) and tuple(spec) == tuple(ref)


def ref_params(arch):
    return jax.eval_shape(ref_build(ref_smoke(arch)).init_params,
                          jax.random.PRNGKey(0))


def port_params(arch):
    return build(get_smoke_config(arch)).init_params(torch.Generator())


def pairs(port_tree, ref_tree, path=()):
    """(path, port leaf, reference leaf) over the port's nested dicts."""
    if isinstance(port_tree, dict):
        assert sorted(port_tree) == sorted(ref_tree), path
        for k in port_tree:
            yield from pairs(port_tree[k], ref_tree[k], path + (k,))
    else:
        yield path, port_tree, ref_tree


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_reference(meshes, arch, mesh_name):
    rmesh = ref_abstract(mesh_name)
    want = ref_rules.param_specs(ref_smoke(arch), ref_params(arch), rmesh)
    got = rules.param_specs(get_smoke_config(arch), port_params(arch),
                            meshes[mesh_name])
    for path, g, w in pairs(got, want):
        assert same(g, w), (path, g, w)


@pytest.mark.parametrize("kind,compress", [("adamw", False),
                                           ("adafactor", False),
                                           ("adamw", True)])
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_opt_state_specs_equal_the_reference(meshes, arch, mesh_name, kind,
                                             compress):
    rmesh, mesh = ref_abstract(mesh_name), meshes[mesh_name]
    rp, pp = ref_params(arch), port_params(arch)
    want = ref_rules.opt_state_specs(
        kind, ref_rules.param_specs(ref_smoke(arch), rp, rmesh), rp, rmesh,
        compress)
    got = rules.opt_state_specs(
        kind, rules.param_specs(get_smoke_config(arch), pp, mesh), pp, mesh,
        compress)
    for path, g, w in pairs(got, want):
        assert same(g, w), (path, g, w)
    # the spec tree matches the optimizer's state tree leaf for leaf
    state = opt.init(pp, opt.OptConfig(kind=kind, compress_grads=compress))
    for path, x, spec in pairs(state, got):
        assert len(spec) <= x.ndim, (path, spec, tuple(x.shape))


@pytest.mark.parametrize("batch", [4, 64])
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_equal_the_reference(meshes, arch, mesh_name, batch):
    rmesh, mesh = ref_abstract(mesh_name), meshes[mesh_name]
    rcache = jax.eval_shape(lambda: ref_build(ref_smoke(arch)).init_cache(
        batch, 64))
    pcache = build(get_smoke_config(arch)).init_cache(batch, 64, "cpu")
    want = ref_rules.cache_specs(ref_smoke(arch), rcache, rmesh, batch)
    got = rules.cache_specs(get_smoke_config(arch), pcache, mesh, batch)
    for path, g, w in pairs(got, want):
        assert same(g, w), (path, g, w)
    for path, x, spec in pairs(pcache, got):
        assert len(spec) <= x.ndim, (path, spec)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_batch_activation_logits_specs(meshes, mesh_name):
    rmesh, mesh = ref_abstract(mesh_name), meshes[mesh_name]
    for fn in ("batch_spec", "activation_spec", "logits_spec"):
        assert same(getattr(rules, fn)(mesh), getattr(ref_rules, fn)(rmesh))
    assert rules.batch_axes(mesh) == ref_rules.batch_axes(rmesh)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_enforce_divisible_drops_what_does_not_divide(meshes, mesh_name):
    """whisper-base's vocab of 51,865 does not divide over 16: its
    embedding falls back to replicated, as the reference's does."""
    rmesh, mesh = ref_abstract(mesh_name), meshes[mesh_name]
    cases = [(P("model", None), (51865, 512)),
             (P("model", None), (51872, 512)),
             (P(None, ("pod", "data") if mesh_name == "multipod" else "data",
                "model"), (4, 64, 48)),
             (P(None, "model"), (24,)),
             (P(("data", "model"), None), (256, 8))]
    for spec, shape in cases:
        want = ref_rules.enforce_divisible(spec, shape, rmesh)
        got = rules.enforce_divisible(rules.Spec(*spec), shape, mesh)
        assert same(got, want), (spec, shape, got, want)
    assert tuple(rules.enforce_divisible(rules.Spec("model", None),
                                         (51865, 512), mesh)) == (None, None)


def test_opt_state_spec_from_param_spec_shapes(meshes):
    for name, mesh in meshes.items():
        rmesh = ref_abstract(name)
        for spec, shape in [((None, "model"), (24, 4096)),
                            ((None, None, "model"), (24, 896, 4864)),
                            ((None,), (24,)), ((None, None), (2, 32))]:
            want = ref_rules.opt_state_spec_from_param_spec(P(*spec), shape,
                                                            rmesh)
            got = rules.opt_state_spec_from_param_spec(rules.Spec(*spec),
                                                       shape, mesh)
            assert same(got, want), (name, spec, shape)


def test_placements_shard_each_named_axis_in_mesh_order(meshes):
    from torch.distributed.tensor import Replicate, Shard

    pod, multi = meshes["pod"], meshes["multipod"]
    assert rules.placements(rules.Spec(None, "model"), pod) == (
        Replicate(), Shard(1))
    assert rules.placements(rules.Spec(("pod", "data"), None, "model"),
                            multi) == (Shard(0), Shard(0), Shard(2))
    assert rules.placements(rules.Spec(None, None, ("data", "model")),
                            pod) == (Shard(2), Shard(2))
    assert rules.placements(rules.Spec(), multi) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="'pod'"):
        rules.placements(rules.Spec("pod"), pod)
    with pytest.raises(ValueError, match="twice"):
        rules.placements(rules.Spec("data", "data"), pod)


def test_param_shardings_are_the_placements_of_the_specs(meshes):
    mesh = meshes["multipod"]
    cfg = get_smoke_config("dbrx-132b")
    params = port_params("dbrx-132b")
    specs = rules.param_specs(cfg, params, mesh)
    got = rules.param_shardings(cfg, params, mesh)
    for path, pl, spec in pairs(got, specs):
        assert pl == rules.placements(spec, mesh), path


def test_a_dtensor_shards_unevenly_as_gspmd_pads(meshes):
    """14 heads' rows over a 16-way axis: DTensor shards unevenly (the
    first ranks hold one row, the last none) where GSPMD pads."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    mesh = meshes["pod"]
    with FakeTensorMode():
        x = rules.place(torch.empty(14, 64), mesh, rules.Spec("model", None))
        assert tuple(x.shape) == (14, 64)
        assert tuple(x.to_local().shape) == (1, 64)   # rank 0's share
        y = rules.distribute({"w": torch.empty(51865, 8)},
                             {"w": rules.Spec("model", None)}, mesh)["w"]
        assert tuple(y.to_local().shape) == (51865, 8)  # dropped: replicated


def test_domain_axes_and_counts(meshes):
    assert mesh_lib.domain_axes(meshes["pod"]) == ref_mesh.domain_axes(
        ref_abstract("pod")) == ("data",)
    assert mesh_lib.domain_axes(meshes["multipod"]) == ref_mesh.domain_axes(
        ref_abstract("multipod")) == ("pod", "data")
    assert mesh_lib.domain_count(meshes["pod"]) == 16
    assert mesh_lib.domain_count(meshes["multipod"]) == 32


def test_production_meshes_have_the_reference_axes(meshes):
    for name, mesh in meshes.items():
        shape, axes = MESHES[name]
        assert tuple(mesh.mesh_dim_names) == axes
        assert tuple(mesh.shape) == shape
        assert mesh.size() == (512 if name == "multipod" else 256)


def test_param_specs_cover_tree_exactly(meshes):
    """Mirror of the reference's test: the spec tree has the param tree's
    structure and no spec is longer than its parameter's rank."""
    for arch in ("qwen2-0.5b", "llama4-maverick-400b-a17b", "mamba2-2.7b",
                 "recurrentgemma-2b", "whisper-base"):
        params = port_params(arch)
        specs = rules.param_specs(get_smoke_config(arch), params,
                                  meshes["pod"])
        for path, x, spec in pairs(params, specs):
            assert isinstance(spec, rules.Spec) and len(spec) <= x.ndim, path
