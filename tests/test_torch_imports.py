"""The PyTorch port stands alone: no JAX and nothing of ``repro`` at run
time, and configuration types equal to the reference's."""

import ast
import dataclasses
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from repro.configs import pic_bit1 as ref_cfgs
from repro.core import collisions as ref_coll
from repro.core import grid as ref_grid
from repro.core import pic as ref_pic
from repro_torch.configs import pic_bit1 as port_cfgs
from repro_torch.core import collisions as port_coll
from repro_torch.core import grid as port_grid
from repro_torch.core import pic as port_pic

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_no_reference(path):
    assert path.exists(), path
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_port_imports_with_jax_blocked():
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['jaxlib'] = None; sys.modules['repro'] = None\n"
            "import repro_torch.core.pic, repro_torch.kernels.ops\n"
            "import repro_torch.launch.pic_run, repro_torch.configs.pic_bit1\n"
            "import repro_torch.models.lm, repro_torch.models.registry\n"
            "import repro_torch.train.serve_step, repro_torch.launch.serve_lm\n"
            "from repro_torch.models import mamba2, moe, rglru, whisper\n"
            "import repro_torch.serve, repro_torch.core.params\n"
            "from repro_torch.serve import SimService, ensemble, service\n"
            "from repro_torch.configs import PORTED, get_config\n"
            "[get_config(a) for a in PORTED]\n"
            "print('ok')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={"PYTHONPATH": str(ROOT / "src"),
                                         "PATH": "/usr/bin:/bin"},
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _fields(cls):
    return [(f.name, f.default if f.default is not dataclasses.MISSING
             else None) for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("ref,port", [
    (ref_pic.PICConfig, port_pic.PICConfig),
    (ref_pic.SpeciesConfig, port_pic.SpeciesConfig),
    (ref_coll.CollisionConfig, port_coll.CollisionConfig),
    (ref_grid.Grid1D, port_grid.Grid1D),
], ids=lambda c: c.__name__)
def test_config_fields_and_defaults_match(ref, port):
    assert _fields(port) == _fields(ref)


@pytest.mark.parametrize("name,kw", [
    ("make_config", {}),
    ("make_config", {"mover_strategy": "fused"}),
    ("make_bench_config", {}),
    ("make_bench_config", {"nc": 256, "n": 2048, "strategy": "explicit"}),
    ("make_see_config", {"nc": 256, "n": 2048}),
    ("make_collision_config", {}),
    ("make_collision_config", {"nc": 256, "n": 2048, "menu": ("coulomb",),
                               "strategy": "fused", "rate_coulomb": 5e-3}),
    ("make_resilience_config", {}),
    ("make_resilience_config", {"nc": 256, "n": 2048, "field_solve": False}),
])
def test_scenario_configs_match(name, kw):
    ref = getattr(ref_cfgs, name)(**kw)
    port = getattr(port_cfgs, name)(**kw)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.length == ref.length
    assert port_pic._carries_rho(port) == ref_pic._carries_rho(ref)
    assert port_pic._stackable(port) == ref_pic._stackable(ref)


@pytest.mark.parametrize("menu", [("elastic", "cx", "coulomb"),
                                  ("charge_exchange",), ("coulomb", "bogus")])
def test_collision_menu_matches_reference(menu):
    def build(cfgs):
        try:
            return [dataclasses.asdict(c)
                    for c in cfgs.make_collision_menu(menu, rate_cx=5e-3)]
        except ValueError as e:
            return str(e)

    assert build(port_cfgs) == build(ref_cfgs)


@pytest.mark.parametrize("bad", [
    {"strategy": "bogus"},
    {"boundary": "reflect"},
    {"diag_every": 0},
    {"collisions": (port_coll.CollisionConfig("elastic", 0, 0),)},
    {"species": (port_pic.SpeciesConfig("e", -1.0, 1.0, 8, 9, 1.0),)},
])
def test_config_validation_matches_reference(bad):
    def conv(v):
        if isinstance(v, tuple) and v and dataclasses.is_dataclass(v[0]):
            cls = {"CollisionConfig": ref_coll.CollisionConfig,
                   "SpeciesConfig": ref_pic.SpeciesConfig}[type(v[0]).__name__]
            return tuple(cls(**dataclasses.asdict(c)) for c in v)
        return v

    with pytest.raises(ValueError) as ref_err:
        ref_pic.PICConfig(**{k: conv(v) for k, v in bad.items()})
    with pytest.raises(ValueError) as port_err:
        port_pic.PICConfig(**bad)
    assert str(port_err.value) == str(ref_err.value)


@pytest.mark.parametrize("alone", [False, True], ids=["checkout", "alone"])
def test_chip_smoke_fails_without_a_card_or_the_port(alone, tmp_path):
    """No CUDA device here: the script exits non-zero and prints no result,
    in the checkout and in a directory that holds only the script."""
    script = ROOT / "chip_smoke.py"
    if alone:
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    out = subprocess.run([sys.executable, str(script)], capture_output=True,
                         text=True, cwd=script.parent, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_distributed_imports_with_jax_blocked():
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['jaxlib'] = None; sys.modules['repro'] = None\n"
            "import repro_torch.distributed\n"
            "from repro_torch.distributed import engine, halo, perf\n"
            "import repro_torch.core.decomposition\n"
            "print('ok')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={"PYTHONPATH": str(ROOT / "src"),
                                         "PATH": "/usr/bin:/bin"},
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_engine_config_fields_match_but_for_the_mesh_axes():
    """The reference takes mesh axis names, the port a domain count; every
    other field and default is the reference's."""
    from repro.distributed import engine as ref_engine
    from repro_torch.distributed import engine as port_engine

    ref = [f for f in _fields(ref_engine.EngineConfig)
           if f[0] != "axis_names"]
    port = [f for f in _fields(port_engine.EngineConfig)
            if f[0] != "domains"]
    assert port == ref


def test_obs_ckpt_runtime_import_with_jax_blocked():
    """The observability, checkpoint and resilience modules, and the
    launcher that exposes them, import with JAX and the reference
    blocked."""
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['jaxlib'] = None; sys.modules['repro'] = None\n"
            "import repro_torch.obs\n"
            "from repro_torch.obs import autotune, metrics, tracing\n"
            "from repro_torch.ckpt import checkpoint\n"
            "from repro_torch.runtime import fault_tolerance, resilience\n"
            "import repro_torch.launch.pic_run\n"
            "print('ok')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={"PYTHONPATH": str(ROOT / "src"),
                                         "PATH": "/usr/bin:/bin"},
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("module,names", [
    ("obs", None), ("obs.metrics", ("atomic_write_json", "StepMetrics",
                                    "from_diag", "MetricsStream",
                                    "validate_record", "read_jsonl",
                                    "validate_stream")),
    ("obs.tracing", ("capture_scopes", "phase_scope", "trace_session")),
    ("obs.autotune", ("TunerPolicy", "decide", "AutoTuner")),
    ("ckpt.checkpoint", ("Checkpointer", "roundtrip_bytes")),
    ("runtime.fault_tolerance", ("SimulatedFailure", "FailureInjector",
                                 "run_training", "resume_training")),
    ("runtime.resilience", ("save_engine", "resume_engine", "run_engine")),
    ("serve", None),
    ("serve.ensemble", ("EnsembleState", "init_ensemble",
                        "make_member_init", "make_member_insert",
                        "make_member_release", "member_view",
                        "make_ensemble_step")),
    ("serve.service", ("Session", "SimService",
                       "enable_compilation_cache")),
    ("core.params", ("RUNTIME_FIELDS", "RuntimeParams", "runtime_params",
                     "b_active")),
    ("models.moe", ("route_topk", "moe_ffn")),
    ("models.rglru", ("RG_C", "CONV_W", "rg_lru", "rg_lru_step",
                      "causal_conv")),
    ("models.mamba2", ("CONV_W", "_depthwise_conv", "ssd_chunked",
                       "ssd_decode_step")),
    ("models.whisper", ("init_params", "encode", "_cross_apply", "forward",
                        "init_cache", "prefill_cross", "decode_step")),
    ("models.lm", ("init_params", "forward", "logits_fn", "init_cache",
                   "decode_step", "_init_moe_ffn", "_init_ssm", "_init_rg",
                   "_ffn_apply", "_ssm_apply", "_ssm_decode", "_rg_apply",
                   "_sinusoid_row")),
    ("models.registry", ("Model", "build")),
    ("train.serve_step", ("make_serve_step", "make_prefill")),
    ("train.optimizer", ("OptConfig", "quantize_int8", "dequantize_int8",
                         "compress_with_feedback", "init_adamw",
                         "_global_norm", "adamw_update", "init_adafactor",
                         "adafactor_update", "init", "update", "_schedule")),
    ("train.train_step", ("TrainConfig", "chunked_ce_loss", "loss_fn",
                          "make_train_step")),
    ("data.pipeline", ("DataConfig", "shard_batch_size", "synthetic_shard",
                       "synthetic_batch")),
    ("runtime.elastic", ("reshard_state", "reshard_via_checkpoint")),
    ("models.attention", ("repeat_kv", "chunked_attention",
                          "decode_attention", "update_cache")),
    ("launch.train", ("main",)),
    ("sharding.rules", ("FSDP_ARCHS", "batch_axes", "param_specs",
                        "param_shardings", "opt_state_spec_from_param_spec",
                        "opt_state_specs", "enforce_divisible", "batch_spec",
                        "activation_spec", "logits_spec", "kv_cache_spec",
                        "ssm_cache_specs", "cache_specs")),
    ("launch.mesh", ("make_production_mesh", "make_debug_mesh",
                     "domain_axes")),
    ("launch.dryrun", ("SHAPES", "HBM_PER_CHIP", "opt_config_for",
                       "skip_reason", "input_specs", "model_flops",
                       "lower_cell", "optimize_cfg", "run_cell",
                       "run_pic_dryrun", "main")),
    ("roofline.analysis", ("PEAK_FLOPS", "HBM_BW", "LINK_BW", "Roofline",
                           "analyze")),
    ("roofline.report", ("fmt_row", "HEADER", "render")),
])
def test_ported_modules_have_the_reference_names(module, names):
    """Each ported module has the reference's public names; ``obs`` has the
    reference's ``__all__`` with ``trace_scope_names`` in place of
    ``jaxpr_scope_names`` and without ``host_span`` (the port's host
    ranges are ``phase_scope``s)."""
    import importlib
    ref = importlib.import_module(f"repro.{module}")
    port = importlib.import_module(f"repro_torch.{module}")
    if names is None:
        want = [n if n != "jaxpr_scope_names" else "trace_scope_names"
                for n in ref.__all__ if n != "host_span"]
        assert port.__all__ == want
        names = want
    for name in names:
        assert hasattr(ref, name) or name == "trace_scope_names", name
        assert hasattr(port, name), name


def test_training_modules_import_with_jax_blocked():
    """The training slice (optimizers, train step, data, elastic, the
    launcher and the differentiable attention) imports with JAX and the
    reference blocked."""
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['jaxlib'] = None; sys.modules['repro'] = None\n"
            "from repro_torch.train import optimizer, train_step\n"
            "from repro_torch.data import pipeline\n"
            "import repro_torch.data\n"
            "from repro_torch.runtime import elastic\n"
            "from repro_torch.models.attention import attention, "
            "chunked_attention\n"
            "import repro_torch.launch.train\n"
            "from repro_torch.sharding import rules\n"
            "from repro_torch.launch import dryrun, mesh\n"
            "from repro_torch.roofline import analysis, report\n"
            "print('ok')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={"PYTHONPATH": str(ROOT / "src"),
                                         "PATH": "/usr/bin:/bin"},
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_every_reference_module_has_a_counterpart():
    """Each module of ``src/repro`` has one at the same path in
    ``src/repro_torch``, but two: ``kernels/ref.py``, whose oracles are
    the ``*_plain`` functions beside each kernel of the port, and
    ``roofline/hlo_parser.py``: the port counts a program as it runs and
    has no HLO to parse (ROADMAP, queue 3)."""
    ref = {p.relative_to(ROOT / "src" / "repro")
           for p in (ROOT / "src" / "repro").rglob("*.py")}
    port = {p.relative_to(ROOT / "src" / "repro_torch")
            for p in (ROOT / "src" / "repro_torch").rglob("*.py")}
    missing = sorted(str(p) for p in ref - port
                     if p.name != "__init__.py")
    assert missing == ["kernels/ref.py", "roofline/hlo_parser.py"]


def test_no_module_of_the_port_says_not_ported():
    for path in sorted((ROOT / "src" / "repro_torch").rglob("*.py")):
        assert "not ported" not in path.read_text().lower(), path
