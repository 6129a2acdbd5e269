"""The port's checkpoint and resilience layer (``repro_torch.ckpt``,
``repro_torch.runtime``, the engine's restore hooks) against the
reference's.

* **cross-restore, both ways** — a checkpoint the reference writes (D 2,
  async_n 2, emulated host devices, ``tests/_torch_resilience_ref.py`` in
  one subprocess) restores in the port equal, leaf for leaf, to the
  reference's state and to ``state_from_numpy`` of its arrays; a port
  checkpoint passes the reference's ``_stored_matches`` and restores on
  its typed path with every leaf bit-equal;
* **bitwise restart** — checkpoint at step k, ``SimulatedFailure``,
  restore, run to k + m: every leaf, each domain's generator state and
  every diagnostic of the resumed steps equal the uninterrupted run's, at
  D x async_n in {1, 2, 4}^2 with ionization, SEE, collisions and the
  carried rho;
* **elastic restore** — save at D, restore at D' != D: exact count and
  charge, the rings consistent, the collision invariants over the
  continued run, and no full-capacity scan in the rebuild;
* **torn writes**, the asynchronous save, SIGTERM, the serialization
  round trip (bfloat16 included), strict ``restore(like=)``, the
  fire-once ``FailureInjector`` and the generic ``run_training`` loop.
"""

import dataclasses
import os
import signal
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (one torch thread a test process)
import _torch_resilience_ref as ref_run
from repro_torch.ckpt import checkpoint
from repro_torch.ckpt.checkpoint import Checkpointer
from repro_torch.configs import pic_bit1 as configs
from repro_torch.configs.pic_bit1 import (make_collision_config,
                                          make_engine_config,
                                          make_resilience_config)
from repro_torch.core.particles import FreeSlotRing
from repro_torch.distributed import engine
from repro_torch.runtime import fault_tolerance, resilience
from repro_torch.runtime.fault_tolerance import (FailureInjector,
                                                 SimulatedFailure)

try:                                   # gated like the other property suites
    from hypothesis import given, settings, strategies as hyp_st
    HAVE_HYPOTHESIS = True
except ImportError:                    # pragma: no cover - optional dep
    HAVE_HYPOTHESIS = False

    def given(*a, **k):                # no-op decorators keep collection sane
        return lambda f: f

    settings = given

    class hyp_st:                      # type: ignore[no-redef]
        @staticmethod
        def integers(*a, **k):
            return None

needs_hypothesis = pytest.mark.skipif(
    not HAVE_HYPOTHESIS, reason="hypothesis not installed")

HERE = os.path.dirname(__file__)
SRC = os.path.join(HERE, "..", "src")
CPU = "cpu"


def _ecfg(async_n=2, nc=32, n=256, domains=1, **kw):
    cfg = make_resilience_config(nc=nc, n=n)
    return make_engine_config(cfg, domains=domains, async_n=async_n,
                              max_migration=64, max_births=64, **kw)


def _flat(state):
    return checkpoint._flatten(engine.state_tree(state))


def _assert_flat_bitwise(a: dict, b: dict, ctx=""):
    assert sorted(a) == sorted(b), ctx
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, (ctx, k)
        assert np.array_equal(x, y), f"{ctx} leaf {k}"


def _assert_states_bitwise(a, b, ctx=""):
    """Every leaf, and each domain's generator state."""
    _assert_flat_bitwise(_flat(a), _flat(b), ctx)
    assert len(a.gens) == len(b.gens), ctx
    for ga, gb in zip(a.gens, b.gens):
        assert torch.equal(ga.get_state(), gb.get_state()), ctx


def _assert_diags_bitwise(a, b, ctx=""):
    assert len(a) == len(b), ctx
    for i, (da, db) in enumerate(zip(a, b)):
        assert set(da) == set(db), (ctx, i)
        for k in da:
            assert np.array_equal(da[k], db[k]), f"{ctx} step+{i} diag {k}"


# ------------------------------------------------- cross-restore, both ways


def _cross_ecfg():
    kw = ref_run.engine_config(configs)
    return make_engine_config(kw.pop("pic_cfg"), domains=ref_run.D, **kw)


@pytest.fixture(scope="module")
def cross(tmp_path_factory):
    """The port's checkpoint of a churned state at D 2 x async_n 2, then
    the reference's side in one subprocess. Returns (root, port state)."""
    root = tmp_path_factory.mktemp("cross")
    ecfg = _cross_ecfg()
    state, _ = resilience.run_engine(
        ecfg, engine.init_engine_state(ecfg, 0, device=CPU), num_steps=2)
    assert any(bool(p.alive.any()) for p in state.pending)
    resilience.save_engine(Checkpointer(str(root / "port")), ecfg, 2, state,
                           blocking=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.abspath(SRC) + os.pathsep + HERE
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={ref_run.D}"
    env["JAX_PLATFORMS"] = "cpu"
    res = subprocess.run([sys.executable,
                          os.path.join(HERE, "_torch_resilience_ref.py"),
                          str(root)], env=env, capture_output=True,
                         text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    return root, state


def test_port_checkpoint_restores_on_the_reference_typed_path(cross):
    """The reference's ``resume_engine`` takes its typed path on the port's
    file (the script checks ``_stored_matches``) and gives back every leaf
    bit-equal: particles, rings, pending, rho, step and the key."""
    root, state = cross
    with np.load(root / "port_restored.npz") as z:
        restored = {k: z[k] for k in z.files}
    _assert_flat_bitwise(restored, _flat(state), "port -> reference")


def test_reference_checkpoint_restores_in_the_port(cross):
    """The reference's checkpoint restores in the port on the typed path:
    every leaf bit-equal to the reference's state, and the state equal to
    ``state_from_numpy`` of the same arrays (the generators seeded from
    the reference's key rows)."""
    root, _ = cross
    ecfg = _cross_ecfg()
    ck = Checkpointer(str(root / "ref"))
    assert resilience._stored_matches(ck.restore_flat()[1],
                                      engine.state_shape(ecfg))
    step, state = resilience.resume_engine(ecfg, ck, device=CPU)
    assert step == ref_run.STEPS == state.step
    with np.load(root / "ref_state.npz") as z:
        want = {k: z[k] for k in z.files}
    _assert_flat_bitwise(_flat(state), want, "reference -> port")
    groups = engine._capacity_groups(ecfg)
    arrays = {
        "step": int(want["pic/step"]), "key": want["pic/key"],
        "rho": want["pic/rho"],
        "species": [{f: want[f"pic/species/{i}/{f}"]
                     for f in ("x", "v", "w", "alive")}
                    for i in range(len(ecfg.pic.species))],
        "rings": [{f: want[f"rings/{g}/{f}"]
                   for f in ("slots", "head", "count")}
                  for g in range(len(groups))],
        "pending": [{f: want[f"pending/{g}/{f}"]
                     for f in ("x", "v", "w", "alive", "dest")}
                    for g in range(len(groups))]}
    _assert_states_bitwise(engine.state_from_numpy(ecfg, arrays,
                                                   device=CPU), state)
    # the restored state steps on, conserving the pairs
    diag = resilience.run_engine(ecfg, state,
                                 num_steps=ref_run.STEPS + 2)[1][-1]
    assert all(int(diag[f"{sc.name}/count"]) > 0
               for sc in ecfg.pic.species)


def test_state_shape_and_shardings_describe_the_state():
    """``state_shape`` holds every leaf of ``state_tree`` with its shape and
    dtype (the reference's layout), with and without carried rho and in
    the legacy mode; ``state_shardings`` puts the buffers on the device and
    the key and step on the host."""
    for ecfg in (_ecfg(domains=2), _ecfg(async_n=1, domains=4),
                 _ecfg(use_ring=False),
                 make_engine_config(make_collision_config(nc=32, n=256),
                                    domains=2, max_migration=64)):
        state = engine.init_engine_state(ecfg, 0, device=CPU)
        have = _flat(state)
        like = dict(checkpoint._leaves(engine.state_shape(ecfg)))
        want = {checkpoint._path_str(p): a for p, a in like.items()}
        assert sorted(have) == sorted(want)
        for k, a in want.items():
            assert (have[k].shape, have[k].dtype) == (a.shape, a.dtype), k
        devices = dict(checkpoint._leaves_devices(
            engine.state_shardings(ecfg, CPU)))
        assert {checkpoint._path_str(p) for p in devices} == set(want)
    assert "pic/key" in want and want["pic/key"].dtype == np.uint32


# ------------------------------------------------------- bitwise restart


@pytest.mark.parametrize("async_n", [1, 2, 4])
@pytest.mark.parametrize("d", [1, 2, 4])
def test_bitwise_restart(d, async_n, k_ckpt=2, k_fail=4, k_end=6):
    """checkpoint-at-k -> SimulatedFailure -> restore -> run-to-k+m equals
    the uninterrupted run: every leaf, each domain's generator state, and
    every diag of the resumed steps. Full-churn workload (ionization + SEE
    + collisions + carried rho)."""
    ecfg = _ecfg(async_n=async_n, domains=d)
    step = engine.make_engine_step(ecfg)
    ref, ref_diags = resilience.run_engine(
        ecfg, engine.init_engine_state(ecfg, 0, device=CPU),
        num_steps=k_end, step_fn=step)
    with tempfile.TemporaryDirectory() as tmp:
        ck = Checkpointer(tmp)
        inj = FailureInjector(fail_at_step=k_fail)
        with pytest.raises(SimulatedFailure):
            resilience.run_engine(
                ecfg, engine.init_engine_state(ecfg, 0, device=CPU),
                num_steps=k_end, ckpt=ck, ckpt_every=k_ckpt, injector=inj,
                step_fn=step)
        step_r, state = resilience.resume_engine(ecfg, ck, device=CPU)
        assert step_r == k_fail  # newest complete ckpt before the fence
        fin, diags = resilience.run_engine(
            ecfg, state, num_steps=k_end, ckpt=ck, ckpt_every=k_ckpt,
            injector=inj, step_fn=step)
    ctx = f"D={d} async_n={async_n}"
    _assert_states_bitwise(ref, fin, ctx)
    _assert_diags_bitwise(ref_diags[step_r:], diags, ctx)
    assert sum(int(dg["n_ionized"]) for dg in ref_diags) > 0


# ------------------------------------------------------- elastic restore


def _totals(ecfg, state):
    """Per-species (count, charge) of everything resident: buffer rows plus
    in-flight pending rows."""
    out = {}
    for i, sc in enumerate(ecfg.pic.species):
        b = state.species[i]
        out[i] = [int(b.alive.sum()),
                  float((b.w.double() * b.alive).sum()) * sc.charge]
    for g, idxs in enumerate(engine._capacity_groups(ecfg)):
        for j, i in enumerate(idxs):
            p = state.pending[g]
            pa, pw = p.alive[:, j], p.w[:, j].double()
            out[i][0] += int(pa.sum())
            out[i][1] += float((pw * pa).sum()) * ecfg.pic.species[i].charge
    return out


def _moments(diag):
    return {k: float(diag[k]) for k in diag
            if k.endswith(("/count", "/ke"))}


@pytest.mark.parametrize("d_save,d_new", [(1, 2), (1, 4), (2, 1), (2, 4),
                                          (4, 1), (4, 2)])
def test_elastic_restore_matrix(d_save, d_new):
    """Save at D, restore at D' != D on the collisions-only workload
    (periodic walls, constant populations): count and charge exact across
    the boundary, pending empty, the rings holding every dead slot, the
    counts constant over the continued run, the electron KE kept by
    elastic and Coulomb scattering and the D+/D sum by charge exchange."""
    cfg = make_collision_config(nc=32, n=256, strategy="fused")
    ecfg = {d: make_engine_config(cfg, domains=d, async_n=2,
                                  max_migration=64, max_births=64)
            for d in (d_save, d_new)}
    with tempfile.TemporaryDirectory() as tmp:
        ck = Checkpointer(tmp)
        state, diags = resilience.run_engine(
            ecfg[d_save], engine.init_engine_state(ecfg[d_save], 0,
                                                   device=CPU), num_steps=3)
        resilience.save_engine(ck, ecfg[d_save], 3, state, blocking=True)
        m0, t0 = _moments(diags[-1]), _totals(ecfg[d_save], state)
        step_r, state = resilience.resume_engine(ecfg[d_new], ck,
                                                 device=CPU)
    ctx = f"{d_save}->{d_new}"
    assert step_r == 3 == state.step, ctx
    assert state.species[0].x.shape[0] == d_new
    for p in state.pending:
        assert not bool(p.alive.any()), ctx
    for rg, st in zip(state.rings, state.groups):
        assert torch.equal(rg.count, (~st.alive).sum(-1, dtype=torch.int32))
    t1 = _totals(ecfg[d_new], state)
    for i in t0:
        assert t1[i][0] == t0[i][0], (ctx, i, t0[i], t1[i])
        np.testing.assert_allclose(t1[i][1], t0[i][1], rtol=1e-12,
                                   err_msg=f"{ctx} species {i} charge")
    state, diags = resilience.run_engine(ecfg[d_new], state, num_steps=5)
    m1 = _moments(diags[-1])
    for k in m0:
        if k.endswith("/count"):
            assert m1[k] == m0[k], (ctx, k, m0[k], m1[k])
    assert np.isclose(m1["e/ke"], m0["e/ke"], rtol=2e-4), (ctx, m0, m1)
    assert np.isclose(m1["D+/ke"] + m1["D/ke"], m0["D+/ke"] + m0["D/ke"],
                      rtol=2e-4), (ctx, m0, m1)


@pytest.mark.parametrize("d_new", [1, 2])
def test_elastic_restore_conserves_churn_workload(d_new):
    """Elastic restore of the full-churn MC workload with in-flight pending
    rows: the restored population and charge equal the checkpointed
    buffers plus the pending rows, exactly, and the re-deposited rho holds
    the whole charge."""
    ecfg = _ecfg(async_n=2, domains=4)
    state, _ = resilience.run_engine(
        ecfg, engine.init_engine_state(ecfg, 0, device=CPU), num_steps=4)
    charges = {i: sc.charge for i, sc in enumerate(ecfg.pic.species)}
    with tempfile.TemporaryDirectory() as tmp:
        ck = Checkpointer(tmp)
        resilience.save_engine(ck, ecfg, 4, state, blocking=True)
        _, flat, _ = ck.restore_flat()
        groups = engine._capacity_groups(ecfg)
        n0, q0 = {}, {}
        for g, idxs in enumerate(groups):
            for j, i in enumerate(idxs):
                a = flat[f"pic/species/{i}/alive"]
                w = flat[f"pic/species/{i}/w"].astype(np.float64)
                pa = flat[f"pending/{g}/alive"][:, j]
                pw = flat[f"pending/{g}/w"][:, j].astype(np.float64)
                n0[i] = int(a.sum()) + int(pa.sum())
                q0[i] = ((w * a).sum() + (pw * pa).sum()) * charges[i]
        assert any(flat[f"pending/{g}/alive"].any()
                   for g in range(len(groups))), \
            "churn produced no in-flight rows; the flush is untested"
        _, st = resilience.resume_engine(
            dataclasses.replace(ecfg, domains=d_new), ck, device=CPU)
    for i in n0:
        b = st.species[i]
        assert int(b.alive.sum()) == n0[i], (d_new, i)
        np.testing.assert_allclose(
            float((b.w.double() * b.alive).sum()) * charges[i], q0[i],
            rtol=1e-12, err_msg=f"{d_new}:{i}")
    np.testing.assert_allclose(float(st.rho.double().sum()),
                               sum(q0.values()), rtol=1e-5)


def test_elastic_restore_rejects_overfull_domain():
    """Re-split cannot invent headroom: a new domain whose population
    exceeds its local capacity makes the restore refuse."""
    ecfg = _ecfg(async_n=1)
    state = engine.init_engine_state(ecfg, 0, device=CPU)
    flat = {k: np.array(v) for k, v in _flat(state).items()}
    cap = flat["pic/species/0/x"].shape[1]
    flat["pic/species/0/x"][:] = 1.0
    flat["pic/species/0/alive"][:] = True
    ecfg2 = dataclasses.replace(ecfg, domains=2)
    assert ecfg2.local_cap(ecfg.pic.species[0]) == cap // 2
    with pytest.raises(ValueError, match="local capacity"):
        engine.resplit_host(ecfg2, flat, d_old=1)


class _CumsumShapes(torch.overrides.TorchFunctionMode):
    """Records the input shape of every cumsum called in the block."""

    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if getattr(func, "__name__", "") == "cumsum":
            self.shapes.append(tuple(args[0].shape))
        return func(*args, **(kwargs or {}))


def test_elastic_restore_does_no_full_capacity_scan():
    """The rebuild uses the closed-form ``ring_from_counts`` (free set =
    the compacted tail), never the init-only full scan: no cumsum runs
    over a full-capacity axis. The contrast pin: ``attach_engine_state``,
    which is allowed the scan, shows one."""
    ecfg = _ecfg(async_n=2)
    cap = ecfg.local_cap(ecfg.pic.species[0])
    species = [dict(x=np.zeros((1, cap), np.float32),
                    v=np.zeros((1, cap, 3), np.float32),
                    w=np.zeros((1, cap), np.float32),
                    alive=np.zeros((1, cap), bool))
               for _ in ecfg.pic.species]
    counts = np.zeros((1, len(species)), np.int32)
    with _CumsumShapes() as rec:
        st = engine.elastic_state(ecfg, species, counts,
                                  np.zeros(2, np.uint32), 0, device=CPU)
    full = [s for s in rec.shapes if s and s[-1] >= cap]
    assert not full, (
        f"elastic restore cumsums over a full-capacity axis {full}: the "
        f"free-slot rebuild regressed to a scan")
    assert int(st.rings[0].count.sum()) == len(species) * cap
    pstate = engine.init_engine_state(ecfg, 0, device=CPU)
    with _CumsumShapes() as rec:
        engine.retarget_state(ecfg, dataclasses.replace(ecfg,
                                                        max_births=128),
                              pstate)
    assert any(s and s[-1] >= cap for s in rec.shapes), (
        "contrast pin lost its teeth: the ring rebuild no longer scans")


# ----------------------------------------------------------- torn writes


def test_restart_scans_past_torn_checkpoints():
    """A step directory without a manifest (writer died mid-write) and one
    with a corrupt manifest are both invisible to latest_step/restore."""
    tree = {"a": torch.arange(4.0)}
    with tempfile.TemporaryDirectory() as tmp:
        ck = Checkpointer(tmp)
        ck.save(2, tree, blocking=True)
        torn = os.path.join(tmp, "step_00000004")
        os.makedirs(torn)
        np.savez(os.path.join(torn, "arrays.npz"), a=np.arange(4.0))
        garbled = os.path.join(tmp, "step_00000006")
        os.makedirs(garbled)
        np.savez(os.path.join(garbled, "arrays.npz"), a=np.arange(4.0))
        with open(os.path.join(garbled, "manifest.json"), "w") as fh:
            fh.write('{"step": 6, "comp')     # truncated mid-write
        assert ck.latest_step() == 2
        step, out = ck.restore(like=tree)
        assert step == 2
        assert torch.equal(out["a"], torch.arange(4.0))


def test_writer_killed_between_arrays_and_manifest(monkeypatch):
    """Kill the writer between ``arrays.npz`` and ``manifest.json``: the
    torn step is skipped and the next save lands cleanly."""
    tree = {"a": torch.arange(3.0), "b": torch.ones(2, dtype=torch.bool)}
    with tempfile.TemporaryDirectory() as tmp:
        ck = Checkpointer(tmp)
        ck.save(1, tree, blocking=True)
        real_replace = os.replace

        def boom(src, dst):
            if dst.endswith("manifest.json"):
                raise OSError("simulated writer kill")
            return real_replace(src, dst)

        monkeypatch.setattr(checkpoint.os, "replace", boom)
        with pytest.raises(OSError, match="writer kill"):
            ck.save(3, tree, blocking=True)
        monkeypatch.undo()
        assert os.path.exists(
            os.path.join(tmp, "step_00000003", "arrays.npz"))
        assert not os.path.exists(
            os.path.join(tmp, "step_00000003", "manifest.json"))
        assert ck.latest_step() == 1
        ck.save(5, tree, blocking=True)
        assert ck.latest_step() == 5
        step, out = ck.restore(like=tree)
        assert step == 5 and torch.equal(out["b"], torch.ones(2,
                                                              dtype=bool))


def test_save_is_asynchronous_by_default():
    """The step loop pays the host copy only: save() returns with the
    writer thread still attached, and wait() completes the manifest."""
    with tempfile.TemporaryDirectory() as tmp:
        ck = Checkpointer(tmp)
        info = ck.save(7, {"a": torch.zeros(256, 256)})
        assert ck._thread is not None          # write still in flight
        assert info["bytes"] == 256 * 256 * 4
        assert info["fetch_us"] >= 0
        ck.wait()
        assert ck.latest_step() == 7
        assert ck.last_write_us > 0


def test_save_copies_before_the_caller_writes_in_place():
    """The engine step writes its input's buffers in place; the save's
    host copy is taken before it returns, so the file holds the state as
    it was at the save, also on the CPU (where ``.cpu()`` is no copy)."""
    t = torch.zeros(1024)
    with tempfile.TemporaryDirectory() as tmp:
        ck = Checkpointer(tmp)
        ck.save(1, {"t": t})
        t += 1.0
        ck.wait()
        _, out = ck.restore(like={"t": t})
    assert torch.equal(out["t"], torch.zeros(1024))


# -------------------------------------------------- serialization roundtrip


def _random_engine_tree(seed: int, cap: int, m: int):
    """An engine-shaped tree (dataclasses, tuples, dict) with every leaf
    dtype the checkpoint must round-trip: f32, bf16, bool, i32, u32."""
    rng = np.random.RandomState(seed)

    def tt(a, dtype):
        return torch.tensor(a).to(dtype)

    ring = FreeSlotRing(
        slots=tt(rng.randint(0, cap + 1, cap), torch.int32),
        head=tt(rng.randint(0, cap), torch.int32),
        count=tt(rng.randint(0, cap), torch.int32))
    pend = engine.PendingArrivals(
        x=tt(rng.randn(2, m), torch.float32),
        v=tt(rng.randn(2, m, 3), torch.float32),
        w=tt(rng.rand(2, m), torch.float32),
        alive=tt(rng.rand(2, m) < 0.5, torch.bool),
        dest=tt(rng.randint(0, cap + 1, (2, m)), torch.int32))
    return {"rings": (ring,), "pending": (pend,),
            "key": rng.randint(0, 2**32, 2, np.int64).astype(np.uint32),
            "halfp": tt(rng.randn(cap), torch.bfloat16)}


def _assert_tree_bitwise(a, b):
    la, lb = list(checkpoint._leaves(a)), list(checkpoint._leaves(b))
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (_, x), (_, y) in zip(la, lb):
        assert type(x) is type(y)
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y)
        else:
            assert x.dtype == y.dtype and np.array_equal(x, y)
    assert type(a["rings"][0]) is type(b["rings"][0])


@needs_hypothesis
@settings(max_examples=25, deadline=None)
@given(hyp_st.integers(0, 2**31 - 1), hyp_st.integers(1, 64),
       hyp_st.integers(1, 16))
def test_flatten_roundtrips_engine_pytree(seed, cap, m):
    tree = _random_engine_tree(seed, cap, m)
    _assert_tree_bitwise(tree, checkpoint.roundtrip_bytes(tree))


def test_roundtrip_engine_pytree_fixed_seed():
    """The non-hypothesis fallback, through the file-based Checkpointer
    (npz + manifest dtypes): bfloat16 stored as float32 and cast back."""
    tree = _random_engine_tree(1234, 32, 8)
    with tempfile.TemporaryDirectory() as tmp:
        ck = Checkpointer(tmp)
        ck.save(1, tree, blocking=True)
        assert ck._manifest(1)["dtypes"] == {"halfp": "bfloat16"}
        _, out = ck.restore(like=tree, device=CPU)
    out["key"] = out["key"].numpy()       # restore gives tensors
    _assert_tree_bitwise(tree, out)


def test_roundtrip_full_engine_state():
    """A live EngineState (after churn steps, nonempty rings and pending)
    restores bitwise through save/resume, generator states included, and
    the manifest's meta carries the reference's keys."""
    ecfg = _ecfg(async_n=2, domains=2)
    state, _ = resilience.run_engine(
        ecfg, engine.init_engine_state(ecfg, 0, device=CPU), num_steps=2)
    with tempfile.TemporaryDirectory() as tmp:
        ck = Checkpointer(tmp)
        resilience.save_engine(ck, ecfg, 2, state, blocking=True)
        meta = ck._manifest(2)["meta"]
        step, out = resilience.resume_engine(ecfg, ck, device=CPU)
    assert {k: meta[k] for k in ("kind", "domains", "async_n", "nc",
                                 "use_ring", "step")} == {
        "kind": "engine", "domains": 2, "async_n": 2, "nc": 32,
        "use_ring": True, "step": 2}
    assert step == 2
    _assert_states_bitwise(state, out)
    assert isinstance(out, engine.EngineState)
    assert isinstance(out.rings[0], FreeSlotRing)


def test_resume_rejects_a_checkpoint_that_is_no_engine_state():
    with tempfile.TemporaryDirectory() as tmp:
        ck = Checkpointer(tmp)
        ck.save(1, {"a": torch.zeros(3)}, blocking=True)
        with pytest.raises(ValueError, match="not an engine checkpoint"):
            resilience.resume_engine(_ecfg(), ck, device=CPU)


# ------------------------------------------------------- strictness, injector


def test_restore_rejects_keys_absent_from_like():
    """restore(like=...) raises on stored leaves missing from ``like`` and
    on ``like`` leaves missing from the file."""
    with tempfile.TemporaryDirectory() as tmp:
        ck = Checkpointer(tmp)
        ck.save(1, {"a": torch.zeros(3), "b": {"c": torch.ones(2)}},
                blocking=True)
        with pytest.raises(ValueError, match="extra keys"):
            ck.restore(like={"a": torch.zeros(3)})
        with pytest.raises(ValueError, match="missing keys"):
            ck.restore(like={"a": torch.zeros(3),
                             "b": {"c": torch.ones(2), "d": torch.ones(1)}})


def test_restore_shape_mismatch_points_at_elastic_path():
    with tempfile.TemporaryDirectory() as tmp:
        ck = Checkpointer(tmp)
        ck.save(1, {"a": torch.zeros(4)}, blocking=True)
        with pytest.raises(ValueError, match="elastic"):
            ck.restore(like={"a": torch.zeros(2)})


def test_failure_injector_fires_once():
    inj = FailureInjector(fail_at_step=3)
    inj.check(2)
    with pytest.raises(SimulatedFailure):
        inj.check(3)
    inj.check(3)                        # the resumed pass sails through
    inj.check(4)
    always = FailureInjector(fail_at_step=3, once=False)
    with pytest.raises(SimulatedFailure):
        always.check(3)
    with pytest.raises(SimulatedFailure):
        always.check(3)


def test_run_training_restart_is_bitwise():
    """The generic loop: a toy optimizer on tensors, failed at step 5 with
    checkpoints every 2 and resumed, ends bit-equal to the uninterrupted
    run, with the same per-step metrics."""
    target = torch.linspace(-1.0, 1.0, 16)

    def step_fn(params, opt, batch):
        grad = params["w"] - target * batch
        opt = {"m": 0.9 * opt["m"] + grad}
        return {"w": params["w"] - 0.1 * opt["m"]}, opt, {
            "loss": (grad * grad).sum()}

    def batch_fn(step):
        return torch.tensor(1.0 + 0.01 * step)

    p0, o0 = {"w": torch.zeros(16)}, {"m": torch.zeros(16)}
    with tempfile.TemporaryDirectory() as tmp:
        ref_p, ref_o, ref_log = fault_tolerance.run_training(
            step_fn, batch_fn, p0, o0, num_steps=8, ckpt=Checkpointer(tmp),
            ckpt_every=100)
    with tempfile.TemporaryDirectory() as tmp:
        ck = Checkpointer(tmp)
        with pytest.raises(SimulatedFailure):
            fault_tolerance.run_training(
                step_fn, batch_fn, p0, o0, num_steps=8, ckpt=ck,
                ckpt_every=2, injector=FailureInjector(fail_at_step=5))
        ck.wait()                     # the write of step 4 was in flight
        assert ck.latest_step() == 4
        p, o, log = fault_tolerance.resume_training(
            step_fn, batch_fn, num_steps=8, ckpt=ck, ckpt_every=2,
            like={"params": p0, "opt": o0})
    assert torch.equal(p["w"], ref_p["w"]) and torch.equal(o["m"],
                                                           ref_o["m"])
    assert log == ref_log[4:]


def test_restore_places_leaves_where_like_lies_else_on_the_card(
        monkeypatch):
    """A leaf whose ``like`` leaf is a tensor restores on that tensor's
    device; any other leaf on ``device``, which defaults to the card and
    raises when there is none (the port never falls back to the CPU)."""
    tree = {"t": torch.arange(3.0), "a": np.arange(4, dtype=np.int32)}
    with tempfile.TemporaryDirectory() as tmp:
        ck = Checkpointer(tmp)
        ck.save(1, tree, blocking=True)
        _, out = ck.restore(like=tree, device=CPU)
        assert out["t"].device.type == CPU and out["a"].device.type == CPU
        assert torch.equal(out["a"], torch.arange(4, dtype=torch.int32))
        _, out = ck.restore(like={"t": tree["t"], "a": torch.zeros(
            4, dtype=torch.int32)})
        assert out["a"].device.type == CPU
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ck.restore(like=tree)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ck.restore()


# --------------------------------------------------- metrics + overhead


def test_ckpt_overhead_lands_in_metrics_stream():
    from repro.obs.metrics import validate_stream as ref_validate_stream
    from repro_torch.obs.metrics import (MetricsStream, read_jsonl,
                                         validate_stream)
    ecfg = _ecfg(async_n=1)
    with tempfile.TemporaryDirectory() as tmp:
        jsonl = os.path.join(tmp, "m.jsonl")
        ck = Checkpointer(os.path.join(tmp, "ck"))
        with MetricsStream(jsonl_path=jsonl, config={"test": True}) as st:
            resilience.run_engine(
                ecfg, engine.init_engine_state(ecfg, 0, device=CPU),
                num_steps=4, ckpt=ck, ckpt_every=2, stream=st)
        header, steps = read_jsonl(jsonl)
    assert validate_stream([header] + steps) == []
    assert ref_validate_stream([header] + steps) == []
    with_ckpt = [s for s in steps if "ckpt/bytes" in s["counters"]]
    assert [s["step"] for s in with_ckpt] == [1, 3]
    for s in with_ckpt:
        assert s["counters"]["ckpt/bytes"] > 0
        assert s["counters"]["ckpt/fetch_us"] >= 0
        assert "ckpt/write_us" in s["counters"]
    assert all("ckpt/bytes" not in s["counters"]
               for s in steps if s["step"] in (0, 2))


# ------------------------------------------------------ SIGTERM handling


def test_sigterm_stops_loop_and_writes_final_checkpoint():
    """SIGTERM mid-run stops the loop at the next step boundary and leaves
    one final checkpoint labeled with the next step to run; the resumed
    run matches an uninterrupted one bitwise. The previous handler is
    reinstalled afterwards."""
    ecfg = _ecfg(async_n=2)
    step = engine.make_engine_step(ecfg)
    calls = {"n": 0}

    def wrapped(s):
        calls["n"] += 1
        if calls["n"] == 3:       # delivered mid-step-3; loop stops before 4
            signal.raise_signal(signal.SIGTERM)
        return step(s)

    before = signal.getsignal(signal.SIGTERM)
    with tempfile.TemporaryDirectory() as tmp:
        ck = Checkpointer(tmp)
        fin, diags = resilience.run_engine(
            ecfg, engine.init_engine_state(ecfg, 0, device=CPU),
            num_steps=8, ckpt=ck, step_fn=wrapped)
        assert len(diags) == 3          # steps 0..2 ran, 3.. preempted
        assert signal.getsignal(signal.SIGTERM) is before
        step_r, restored = resilience.resume_engine(ecfg, ck, device=CPU)
    assert step_r == 3                  # labeled with the next step to run
    _assert_states_bitwise(restored, fin, "sigterm final ckpt")
    fin_r, diags_r = resilience.run_engine(ecfg, restored, num_steps=5,
                                           step_fn=step)
    ref, ref_diags = resilience.run_engine(
        ecfg, engine.init_engine_state(ecfg, 0, device=CPU), num_steps=5,
        step_fn=step)
    _assert_states_bitwise(fin_r, ref, "sigterm resume")
    _assert_diags_bitwise(diags_r, ref_diags[3:], "sigterm resume")


def test_sigterm_no_duplicate_checkpoint_when_boundary_already_saved():
    """A SIGTERM right after a periodic checkpoint writes no second copy of
    the same step."""
    ecfg = _ecfg(async_n=1)
    step = engine.make_engine_step(ecfg)
    calls = {"n": 0}

    def wrapped(s):
        calls["n"] += 1
        if calls["n"] == 2:
            signal.raise_signal(signal.SIGTERM)
        return step(s)

    with tempfile.TemporaryDirectory() as tmp:
        ck = Checkpointer(tmp)
        resilience.run_engine(
            ecfg, engine.init_engine_state(ecfg, 0, device=CPU),
            num_steps=8, ckpt=ck, ckpt_every=2, step_fn=wrapped)
        steps = sorted(int(d.name.split("_")[-1])
                       for d in os.scandir(tmp) if d.is_dir())
    assert steps == [2]


# ---------------------------------------------------------- on the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py phase 10 (f) runs the "
                    "cross-device restore on the card")
    return torch.device("cuda")


@pytest.mark.card
def test_resume_training_stays_on_the_card(card):
    """``resume_training`` with parameters on the card resumes on the card,
    bit-equal to the uninterrupted run there."""
    def step_fn(params, opt, batch):
        grad = params["w"] - batch
        opt = {"m": 0.9 * opt["m"] + grad}
        return {"w": params["w"] - 0.1 * opt["m"]}, opt, {
            "loss": (grad * grad).sum()}

    def batch_fn(step):
        return torch.full((16,), 1.0 + 0.01 * step, device=card)

    p0 = {"w": torch.zeros(16, device=card)}
    o0 = {"m": torch.zeros(16, device=card)}
    with tempfile.TemporaryDirectory() as tmp:
        ref_p, _, _ = fault_tolerance.run_training(
            step_fn, batch_fn, p0, o0, num_steps=6, ckpt=Checkpointer(tmp),
            ckpt_every=100)
    with tempfile.TemporaryDirectory() as tmp:
        ck = Checkpointer(tmp)
        with pytest.raises(SimulatedFailure):
            fault_tolerance.run_training(
                step_fn, batch_fn, p0, o0, num_steps=6, ckpt=ck,
                ckpt_every=2, injector=FailureInjector(fail_at_step=3))
        ck.wait()
        p, o, _ = fault_tolerance.resume_training(
            step_fn, batch_fn, num_steps=6, ckpt=ck, ckpt_every=2,
            like={"params": p0, "opt": o0})
    assert p["w"].device.type == "cuda" and o["m"].device.type == "cuda"
    assert torch.equal(p["w"], ref_p["w"])


@pytest.mark.card
def test_cross_device_restore(card):
    """A checkpoint written on the card restores on the CPU and one written
    on the CPU restores on the card, with equal leaves (the generators are
    seeded from the key across device kinds)."""
    ecfg = _ecfg(async_n=2, domains=2)
    for src, dst in ((card, CPU), (CPU, card)):
        state, _ = resilience.run_engine(
            ecfg, engine.init_engine_state(ecfg, 0, device=src),
            num_steps=2)
        with tempfile.TemporaryDirectory() as tmp:
            ck = Checkpointer(tmp)
            resilience.save_engine(ck, ecfg, 2, state, blocking=True)
            _, out = resilience.resume_engine(ecfg, ck, device=dst)
        assert out.groups[0].x.device.type == torch.device(dst).type
        _assert_flat_bitwise(_flat(out), _flat(state), f"{src}->{dst}")
