"""The port's dry-run against the reference's (mirror of
``tests/test_dryrun_small.py``), and its report.

Cells are traced at reduced shapes and SMOKE configs on the 16 x 16 and
2 x 16 x 16 meshes of torch's ``fake`` process group (world 512), which
the module's fixture starts and destroys: nothing is allocated, and the
step runs once under ``FakeTensorMode``.
"""

import json

import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke_config as ref_smoke
from repro.launch import dryrun as ref_dryrun
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_lib
from repro_torch.roofline import report

SMALL = {
    "train_4k": dict(kind="train", seq=64, batch=32),
    "prefill_32k": dict(kind="prefill", seq=64, batch=32),
    "decode_32k": dict(kind="decode", seq=64, batch=32),
    "long_500k": dict(kind="decode", seq=128, batch=1),
}


@pytest.fixture(scope="module")
def meshes():
    assert not torch.distributed.is_initialized()
    mesh_lib.start_group("fake", dryrun.FAKE_WORLD)
    try:
        dev = dryrun.trace_device()
        yield {"pod16x16": mesh_lib.make_production_mesh(device=dev),
               "multipod2x16x16": mesh_lib.make_production_mesh(
                   multi_pod=True, device=dev)}
    finally:
        mesh_lib.stop_group()


@pytest.fixture
def small(monkeypatch):
    monkeypatch.setattr(dryrun, "SHAPES", SMALL)
    monkeypatch.setattr(dryrun, "get_config", get_smoke_config)


@pytest.mark.parametrize("arch,shape", [
    ("qwen2-0.5b", "decode_32k"),
    ("mamba2-2.7b", "long_500k"),
    ("whisper-base", "prefill_32k"),
    ("qwen2-0.5b", "train_4k"),
])
def test_input_specs_and_lowering_smoke(meshes, small, arch, shape):
    """Reduced configs through the real input_specs/lower_cell path."""
    mesh = meshes["pod16x16"]
    cfg = get_smoke_config(arch)
    traced, chips, mflops = dryrun.lower_cell(cfg, shape, mesh)
    assert chips == 256
    assert mflops > 0
    assert traced.cost.flops > 0 and traced.cost.hbm_bytes > 0
    assert 0 < traced.peak_bytes < dryrun.HBM_PER_CHIP


def test_input_specs_are_placed_fake_tensors(meshes, small):
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
    from torch.distributed.tensor import DTensor

    mesh = meshes["multipod2x16x16"]
    cfg = get_smoke_config("qwen2-0.5b")
    with FakeTensorMode():
        spec = dryrun.input_specs(cfg, "train_4k", mesh)
    for x in (spec["params"]["embed"], spec["batch"]["tokens"],
              spec["opt_state"]["m"]["embed"]):
        assert isinstance(x, DTensor)
        assert isinstance(x.to_local(), FakeTensor)
    tok = spec["batch"]["tokens"]
    assert tuple(tok.shape) == (32, 64)
    assert tuple(tok.to_local().shape) == (1, 64)   # 32 rows over pod x data
    with pytest.raises(RuntimeError, match="FakeTensorMode"):
        dryrun.input_specs(cfg, "train_4k", mesh)


@pytest.mark.parametrize("arch", ARCHS)
def test_every_arch_traces_at_reduced_shapes(meshes, small, arch):
    """Every cell of every arch at its SMOKE config: ok, or the
    reference's skip."""
    for shape in SMALL:
        row = dryrun.run_cell(arch, shape, meshes["pod16x16"], "pod16x16")
        if dryrun.skip_reason(get_smoke_config(arch), shape):
            assert row["status"] == "skipped"
            continue
        assert row["status"] == "ok", (shape, row.get("error"),
                                       row.get("trace"))
        ro = row["roofline"]
        assert ro["useful_flops_ratio"] <= 1, (shape, ro)
        assert row["fits_80g"] and row["chips"] == 256


def test_optimized_cells_trace(meshes, small):
    """The beyond-paper configuration (tp_axis, attn_p_bf16 and the MoE
    sub-groups) traces on both meshes."""
    for name, mesh in meshes.items():
        for arch, shape in (("qwen2-0.5b", "prefill_32k"),
                            ("qwen2-0.5b", "train_4k"),
                            ("dbrx-132b", "prefill_32k")):
            row = dryrun.run_cell(arch, shape, mesh, name, opt=True)
            assert row["status"] == "ok", (name, arch, shape,
                                           row.get("trace"))
            assert row["variant"] == "optimized"


def test_optimize_cfg_is_shape_gated(meshes):
    mesh = meshes["pod16x16"]
    cfg = get_smoke_config("qwen2-0.5b")
    short = dryrun.optimize_cfg(cfg, mesh, "train_4k")
    long_ = dryrun.optimize_cfg(cfg, mesh, "prefill_32k")
    assert short.attn_dp_only and not long_.attn_dp_only
    assert long_.tp_size == 16 and short.tp_size == 0
    assert short.attn_p_bf16 and long_.attn_p_bf16
    assert short.tp_axis == "model" and short.dp_axes == ("data",)
    multi = dryrun.optimize_cfg(cfg, meshes["multipod2x16x16"], "train_4k")
    assert multi.dp_axes == ("pod", "data")


def test_skip_reason_matches_subquadratic_rule():
    for arch, skip in [("qwen2-0.5b", True), ("mamba2-2.7b", False),
                       ("recurrentgemma-2b", False), ("gemma-7b", True)]:
        cfg = get_smoke_config(arch)
        reason = dryrun.skip_reason(cfg, "long_500k")
        assert (reason is not None) == skip, arch
        assert reason == ref_dryrun.skip_reason(ref_smoke(arch), "long_500k")
        assert dryrun.skip_reason(cfg, "train_4k") is None


def test_model_flops_accounting():
    cfg = get_smoke_config("llama4-maverick-400b-a17b")
    assert cfg.num_active_params() < cfg.num_params()
    dense = get_smoke_config("qwen2-7b")
    assert dense.num_active_params() == dense.num_params()


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_equal_the_reference(arch):
    assert dryrun.SHAPES == ref_dryrun.SHAPES
    for shape in dryrun.SHAPES:
        assert dryrun.model_flops(get_config(arch), shape) == \
            ref_dryrun.model_flops(ref_get_config(arch), shape), shape


def test_opt_config_follows_the_fsdp_archs():
    assert dryrun.opt_config_for(get_config("dbrx-132b")).kind == "adafactor"
    assert dryrun.opt_config_for(get_config("dbrx-132b")).state_dtype == \
        torch.bfloat16
    assert dryrun.opt_config_for(get_config("qwen2-0.5b")).kind == "adamw"


def test_a_failing_cell_is_a_failed_row(meshes, small, monkeypatch):
    def broken(*a, **k):
        raise ValueError("boom")

    monkeypatch.setattr(dryrun, "lower_cell", broken)
    row = dryrun.run_cell("qwen2-0.5b", "train_4k", meshes["pod16x16"],
                          "pod16x16")
    assert row["status"] == "FAILED" and "boom" in row["error"]


def test_main_writes_rows_and_exits_1_on_a_failure(meshes, small, tmp_path,
                                                   monkeypatch, capsys):
    out = tmp_path / "rows.json"
    dryrun.main(["--arch", "qwen2-0.5b", "--shape", "decode_32k", "--mesh",
                 "pod", "--out", str(out)])
    rows = json.loads(out.read_text())
    assert [r["status"] for r in rows] == ["ok"]
    assert "1 ok, 0 skipped, 0 FAILED" in capsys.readouterr().out
    assert torch.distributed.is_initialized()    # the fixture's group stays

    monkeypatch.setattr(dryrun, "lower_cell", lambda *a: 1 / 0)
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "qwen2-0.5b", "--shape", "train_4k", "--mesh",
                     "pod", "--out", str(out)])
    assert e.value.code == 1


def test_report_renders_rows(meshes, small, tmp_path):
    row = dryrun.run_cell("qwen2-0.5b", "decode_32k", meshes["pod16x16"],
                          "pod16x16")
    skipped = dryrun.run_cell("qwen2-0.5b", "long_500k", meshes["pod16x16"],
                              "pod16x16")
    path = tmp_path / "rows.json"
    path.write_text(json.dumps([row, skipped]))
    table = report.render(str(path))
    lines = table.splitlines()
    assert "fits 80G" in lines[0]
    assert lines[2].startswith("| qwen2-0.5b | decode_32k | pod16x16 |")
    assert lines[2].count("|") == lines[0].count("|")
    assert "Skipped cells:" in table and "long_500k" in table
    other = report.render(str(path), mesh="multipod2x16x16")
    assert other == report.HEADER


def test_pic_row_runs_one_engine_step(meshes, monkeypatch, tmp_path):
    """``--pic --device cpu`` at a shrunk §3.3 size: one real engine step
    at the mesh's 16 domains, its row and its table line."""
    from repro_torch.configs import pic_bit1

    monkeypatch.setattr(pic_bit1, "NC_GLOBAL", 1024)
    monkeypatch.setattr(pic_bit1, "N_PER_SPECIES", 4096)
    monkeypatch.setattr(pic_bit1, "CAPACITY", 8192)
    monkeypatch.setattr(dryrun, "SHAPES", {})
    out = tmp_path / "pic.json"
    dryrun.main(["--pic", "--device", "cpu", "--mesh", "pod", "--out",
                 str(out)])
    (row,) = json.loads(out.read_text())
    assert row["arch"] == "pic-bit1" and row["shape"] == "1024cells"
    assert row["status"] == "ok" and row["domains"] == 16
    ro = row["roofline"]
    assert ro["hbm_gbytes_per_chip"] > 0
    assert ro["coll_breakdown"]["collective-permute"] > 0
    assert "| pic-bit1 | 1024cells | pod16x16 |" in report.render(str(out))
