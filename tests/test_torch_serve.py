"""The port's session layer (``repro_torch.serve.service``), mirroring
``tests/test_serve.py``: sessions queue and reuse slots, every session runs
at its own parameter point, ``poll`` reports running and done, submits are
validated, and nothing is built after the first step (the port's
``compiles`` counts kernel builds; on the CPU there are none). The
launcher's ``--ensemble`` prints the reference launcher's lines.
"""

import dataclasses
import re
import sys
from pathlib import Path

import numpy as np
import pytest

import _torch_parity  # noqa: F401  (one torch thread a test process)
from repro_torch.configs import pic_bit1
from repro_torch.core.params import runtime_params
from repro_torch.kernels import _build
from repro_torch.launch import pic_run
from repro_torch.serve import SimService, enable_compilation_cache


def _cfg(n=128):
    cfg = pic_bit1.make_resilience_config(nc=64, n=n)
    return dataclasses.replace(cfg, b_field=(0.0, 0.0, 0.02))


def test_sessions_queue_and_reuse_slots():
    svc = SimService(_cfg(), width=2, device="cpu")
    a = svc.submit({"dt": 0.3, "ionization_rate": 4e-3}, seed=1, steps=2)
    b = svc.submit({"dt": 0.5, "emission_yield": 0.2}, seed=2, steps=3)
    c = svc.submit({"dt": 0.7, "collision_rates": (1e-3, 2e-3, 5e-4)},
                   seed=3, steps=2)
    # two slots, three sessions: c waits for a freed slot
    assert svc.poll(c)["status"] == "queued"
    assert svc.stats()["running"] == 2 and svc.stats()["queued"] == 1
    svc.step(1)
    built = svc.stats()["compiles"]
    svc.run_until_drained()
    polls = {s: svc.poll(s) for s in (a, b, c)}
    assert all(p["status"] == "done" for p in polls.values())
    assert [polls[s]["steps_done"] for s in (a, b, c)] == [2, 3, 2]
    # c ran in the slot a freed (reuse, not growth)
    assert polls[c]["slot"] == polls[a]["slot"] == 0
    # distinct parameter points -> distinct physics
    kes = {s: float(np.asarray(polls[s]["diag"]["e/ke"]).sum())
           for s in (a, b, c)}
    assert len({round(v, 9) for v in kes.values()}) == 3
    st = svc.stats()
    assert st["compiles"] == built == 0
    assert st["running"] == 0 and st["queued"] == 0 and st["free"] == 2
    assert st["sessions"] == 3 and st["width"] == 2


def test_poll_reports_running_then_done():
    svc = SimService(_cfg(), width=2, device="cpu")
    sid = svc.submit({"dt": 0.4}, seed=0, steps=5)
    p = svc.poll(sid)
    assert p["status"] == "running" and "diag" not in p
    svc.step(2)
    p = svc.poll(sid)
    assert p["status"] == "running" and p["steps_done"] == 2
    assert "e/ke" in p["diag"] and p["diag"]["e/ke"].shape == ()
    assert svc.step(3) == 3
    p = svc.poll(sid)
    assert p["status"] == "done" and p["steps_done"] == 5
    assert isinstance(p["diag"]["e/count"], np.ndarray)
    # nothing left to run: a step takes none
    assert svc.step(1) == 0


def test_session_diag_is_the_members_solo_run():
    """A session's final diagnostics are its member's solo run's."""
    from repro_torch.core import pic

    cfg = _cfg()
    svc = SimService(cfg, width=2, device="cpu")
    sid = svc.submit({"dt": 0.35}, seed=6, steps=3)
    svc.submit({"dt": 0.55}, seed=7, steps=2)
    svc.run_until_drained()
    rp = runtime_params(cfg, dt=0.35, device="cpu")
    state = pic.init_state(cfg, 6, device="cpu")
    for _ in range(3):
        state, d = pic.step_fn(state, cfg, rp)
    got = svc.poll(sid)["diag"]
    assert set(got) == set(d)
    for k, v in d.items():
        assert np.array_equal(got[k], v.numpy()), k


@pytest.mark.parametrize("bad,match", [
    (({}, {"steps": 0}), "steps"),
    (({"nc": 128}, {}), "fresh compile"),
    (({"collision_rates": (1e-3,)}, {}), "3-entry menu"),
])
def test_submit_validation(bad, match):
    svc = SimService(_cfg(), width=1, device="cpu")
    over, kw = bad
    with pytest.raises(ValueError, match=match):
        svc.submit(over, **kw)
    assert svc.stats()["sessions"] == 0


def test_prebuilt_params_and_cache_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_ROOT", _build.BUILD_ROOT)
    cfg = _cfg()
    enable_compilation_cache(str(tmp_path))
    assert _build.BUILD_ROOT == Path(tmp_path)
    assert _build.build_dir().parent == Path(tmp_path)
    svc = SimService(cfg, width=1, cache_dir=str(tmp_path / "c"),
                     device="cpu")
    assert _build.BUILD_ROOT == tmp_path / "c"
    sid = svc.submit(params=runtime_params(cfg, dt=0.25, device="cpu"),
                     steps=1)
    svc.run_until_drained()
    assert svc.poll(sid)["status"] == "done"
    # the plain versions serve the CPU: nothing was built
    assert svc.stats()["compiles"] == 0
    assert not (tmp_path / "c").exists()


def test_service_runs_on_the_card_by_default():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        SimService(_cfg(), width=1)


LINE = re.compile(r"session s(\d+): slot=(\d+) steps=(\d+) "
                  r"ke=\{'D\+/ke': [-\d.e+]+, 'D/ke': [-\d.e+]+, "
                  r"'e/ke': [-\d.e+]+\}")
LAST = re.compile(r"(\d+) sessions x (\d+) steps, width=(\d+): [\d.]+s — "
                  r"stats (\{.*\})")
ARGV = ["--ensemble", "2", "--steps", "2", "--nc", "256", "--particles",
        "2048", "--strategy", "fused"]


def _fields(out):
    lines = out.strip().splitlines()
    sessions = [LINE.fullmatch(ln).groups() for ln in lines[:-1]]
    last = LAST.fullmatch(lines[-1])
    assert last, lines[-1]
    stats = eval(last.group(4))
    return sessions, last.groups()[:3], stats


def test_pic_run_ensemble_prints_the_reference_lines(capsys, monkeypatch):
    from repro.launch import pic_run as ref_pic_run

    pic_run.main(["--device", "cpu"] + ARGV)
    got = _fields(capsys.readouterr().out)
    monkeypatch.setattr(sys, "argv", ["pic_run"] + ARGV)
    ref_pic_run.main()
    want = _fields(capsys.readouterr().out)
    assert got[0] == want[0] and got[1] == want[1]
    assert set(got[2]) == set(want[2])
    assert {k: v for k, v in got[2].items() if k != "compiles"} == \
        {k: v for k, v in want[2].items() if k != "compiles"}


@pytest.mark.parametrize("extra", [["--domains", "2"], ["--async-n", "2"],
                                   ["--autotune"], ["--ckpt-dir", "x"]])
def test_pic_run_ensemble_exclusions(extra):
    with pytest.raises(SystemExit):
        pic_run.main(["--device", "cpu"] + ARGV + extra)
