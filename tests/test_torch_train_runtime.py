"""The port's training runtime: the checkpoint/restart loop with its train
step (bit for bit, as ``tests/test_substrate.py`` holds the reference),
``runtime.elastic``, training checkpoints that cross between the two
packages, and ``launch.train``."""

import os
import re

import numpy as np
import pytest
import torch

from _torch_lm import leaves, pair
from repro.ckpt.checkpoint import Checkpointer as RefCheckpointer
from repro.train import optimizer as ref_opt
from repro_torch.ckpt.checkpoint import Checkpointer
from repro_torch.configs import get_smoke_config
from repro_torch.data.pipeline import DataConfig, synthetic_batch
from repro_torch.launch import train as train_launcher
from repro_torch.models import lm
from repro_torch.runtime import elastic
from repro_torch.runtime.fault_tolerance import (FailureInjector,
                                                 SimulatedFailure,
                                                 resume_training,
                                                 run_training)
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import TrainConfig, make_train_step

LINE = re.compile(r"^3 steps in [0-9.]+s; loss ([0-9.]+) -> ([0-9.]+)$")


def _setup():
    cfg = get_smoke_config("qwen2-0.5b")
    params = lm.init_params(cfg, torch.Generator().manual_seed(0))
    tcfg = TrainConfig(opt=opt.OptConfig(lr=1e-3, warmup_steps=2),
                       loss_chunk=16, remat=True)
    dcfg = DataConfig(seed=7, global_batch=4, seq_len=32)
    return (params, opt.init(params, tcfg.opt), make_train_step(cfg, tcfg),
            lambda step: synthetic_batch(dcfg, cfg, step, "cpu"))


def _equal_trees(a, b):
    la, lb = opt.tree_leaves(a), opt.tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def test_failure_restart_is_bit_exact(tmp_path):
    """Fail at step 7, resume from step 4's checkpoint: params and
    optimizer state equal the uninterrupted run's bit for bit (the params
    given to both runs are not changed by either)."""
    params0, state0, step, batch_fn = _setup()
    kw = dict(num_steps=10, ckpt_every=4)
    p_ref, s_ref, log_ref = run_training(
        step, batch_fn, params0, state0,
        ckpt=Checkpointer(str(tmp_path / "ref")), **kw)
    ck = Checkpointer(str(tmp_path / "crash"))
    with pytest.raises(SimulatedFailure):
        run_training(step, batch_fn, params0, state0, ckpt=ck,
                     injector=FailureInjector(fail_at_step=7), **kw)
    assert ck.latest_step() == 4
    p_res, s_res, log_res = resume_training(
        step, batch_fn, ckpt=ck, like={"params": params0, "opt": state0},
        device="cpu", **kw)
    assert _equal_trees(p_ref, p_res) and _equal_trees(s_ref, s_res)
    assert [m["loss"] for m in log_res] == [m["loss"] for m in log_ref[4:]]


def test_reshard_via_checkpoint_keeps_values_and_dtypes(tmp_path):
    state = {"w": torch.arange(64.0).reshape(8, 8),
             "b": {"c": torch.randn(2, 3).bfloat16(),
                   "step": torch.tensor(5, dtype=torch.int32)}}
    for out in (elastic.reshard_via_checkpoint(state, "cpu"),
                elastic.reshard_via_checkpoint(state, torch.device("cpu"),
                                               str(tmp_path)),
                elastic.reshard_state(state, "cpu")):
        assert _equal_trees(out, state)
        assert out["b"]["c"].dtype == torch.bfloat16
        assert out["w"].device.type == "cpu"
    assert (tmp_path / "step_00000000" / "manifest.json").exists()


def test_reshard_to_a_missing_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        elastic.reshard_state({"w": torch.ones(2)}, "cuda")


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_training_checkpoint_crosses_packages(kind, tmp_path):
    """A ``{"params", "opt"}`` checkpoint of the reference restores in the
    port, and the port's in the reference, leaf for leaf and dtype for
    dtype (bf16 params, f32 moments, the int32 step)."""
    rm, rp, pm, pp = pair("qwen2-0.5b", "bf16")
    r_state = {"params": rp,
               "opt": ref_opt.init(rp, ref_opt.OptConfig(kind=kind))}
    p_like = {"params": pp, "opt": opt.init(pp, opt.OptConfig(kind=kind))}
    RefCheckpointer(str(tmp_path / "ref")).save(3, r_state, blocking=True)
    step, got = Checkpointer(str(tmp_path / "ref")).restore(
        like=p_like, device="cpu")
    assert step == 3
    want = {k: np.asarray(v, np.float32) for k, v in leaves(r_state).items()}
    for k, v in leaves(got).items():
        np.testing.assert_array_equal(v.float().numpy(), want[k])
        assert str(v.dtype).removeprefix("torch.") == str(
            leaves(r_state)[k].dtype), k

    # the port's state after a step, read back by the reference
    g = opt.tree_map(lambda p: torch.full_like(p, 0.01), pp)
    p1, s1 = opt.update(pp, g, p_like["opt"], opt.OptConfig(kind=kind))
    Checkpointer(str(tmp_path / "port")).save(
        1, {"params": p1, "opt": s1}, blocking=True)
    step, back = RefCheckpointer(str(tmp_path / "port")).restore(
        like=r_state)
    assert step == 1
    mine = leaves({"params": p1, "opt": s1})
    for k, v in leaves(back).items():
        np.testing.assert_array_equal(np.asarray(v, np.float32),
                                      mine[k].float().numpy())
        assert str(v.dtype) == str(mine[k].dtype).removeprefix("torch.")


def test_launcher_prints_the_reference_line(capsys, tmp_path):
    train_launcher.main(["--device", "cpu", "--steps", "3", "--batch", "2",
                         "--seq", "32", "--ckpt-every", "2", "--ckpt-dir",
                         str(tmp_path)])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    m = LINE.match(last)
    assert m, last
    assert all(np.isfinite(float(x)) for x in m.groups())
    assert os.path.exists(tmp_path / "step_00000002" / "manifest.json")


def test_launcher_refuses_a_mesh():
    """The production meshes need 256 and 512 ranks; a single process has
    one, and the launcher names the ranks it needs (and leaves no group)."""
    for mesh, need in (("pod", 256), ("multipod", 512)):
        with pytest.raises(RuntimeError, match=f"needs {need} ranks; the "
                           f"process group has 1"):
            train_launcher.main(["--device", "cpu", "--mesh", mesh])
        assert not torch.distributed.is_initialized()


def test_launcher_never_falls_back_to_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_launcher.main(["--steps", "1", "--ckpt-dir", str(tmp_path)])
