"""The port's asynchronous multi-domain engine
(``repro_torch.distributed.engine``) against the reference's.

(a) State parity. The reference engine runs in a subprocess on 4 emulated
    host devices (``tests/_torch_engine_ref.py``) and writes its states
    step by step; the port starts from its initial state
    (``state_from_numpy``) and takes the same 3 steps on the draws the
    reference derives from its keys (``_torch_parity.engine_draws``), at
    (D, async_n) in {(1, 1), (2, 2), (4, 1), (4, 4)}, on periodic walls
    with the field solve and carried rho, and on absorbing walls with SEE
    and ionization. Alive masks, counts, ring slots/head/count, pending
    dest/alive and the diagnostics' counters: exact. x, v, w: rtol = atol
    = 2e-5, the push band of ``tests/test_kernels.py`` (x modulo the
    period). rho: rtol = atol = 1e-3 plus the total charge.
(b) The contracts of the reference's engine tests, on the port's own
    generators: D-parity (count exact, charge exact: the port sums it in
    float64; a float32 sum over another domain split rounds differently,
    which is why the reference's ``test_domain_parity`` fails), queue
    parity, absorb conservation with and without rebalance, MC pair
    accounting and the birth budget, ring against legacy merge on the same
    draws, collisions on the engine and the cross-group rejection, a skew
    of at most 1 after the ingest phase that follows a maximal skew, and
    the ``async_n`` validation.
(c) ``core.decomposition``'s shim at D in {1, 4}.
(d) ``pic_run --device cpu --domains 4 --async-n 2 --field-solve --phases``
    prints the reference launcher's lines, then its spans.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_engine_ref as ref_run
from _torch_parity import engine_draws, n, periodic_dist
from repro_torch.core import pic
from repro_torch.distributed import engine, halo, perf

HERE = os.path.dirname(__file__)
SRC = os.path.join(HERE, "..", "src")
TOL = dict(rtol=2e-5, atol=2e-5)
COUNTERS = ("count", "migrated_left", "migrated_right", "migration_overflow",
            "wall_absorbed", "merge_dropped", "emitted", "emission_overflow",
            "n_ionized", "birth_overflow", "queue_occ", "queue_skew",
            "absorbed_left", "absorbed_right")


@pytest.fixture(scope="module")
def reference_runs(tmp_path_factory):
    """The reference engine's states and diagnostics, all cases at once."""
    out = tmp_path_factory.mktemp("engine_ref") / "ref.npz"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.abspath(SRC) + os.pathsep + HERE
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    res = subprocess.run([sys.executable, os.path.join(HERE,
                                                       "_torch_engine_ref.py"),
                          str(out)], env=env, capture_output=True, text=True,
                         timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    with np.load(out) as z:
        return dict(z)


def _arrays(z, tag, t, ecfg):
    """The reference state ``tag`` at step t as ``state_from_numpy``
    takes it."""
    pre = f"{tag}/s{t}/"
    groups = engine._capacity_groups(ecfg)
    out = {"step": int(z[pre + "step"]), "rho": z.get(pre + "rho"),
           "species": [{f: z[f"{pre}species/{i}/{f}"]
                        for f in ("x", "v", "w", "alive")}
                       for i in range(len(ecfg.pic.species))],
           "rings": [{f: z[f"{pre}rings/{g}/{f}"]
                      for f in ("slots", "head", "count")}
                     for g in range(len(groups))],
           "pending": [{f: z[f"{pre}pending/{g}/{f}"]
                        for f in ("x", "v", "w", "alive", "dest")}
                       for g in range(len(groups))]}
    return out


def _ecfg(case, d, an):
    cfg = ref_run.case_config(pic, case)
    return engine.EngineConfig(pic=cfg, domains=d, async_n=an,
                               max_migration=ref_run.MAX_MIGRATION,
                               max_births=ref_run.MAX_BIRTHS)


def _draws(ecfg, keys):
    groups = engine._capacity_groups(ecfg)
    loc = engine._species_location(groups)
    caps_q = [ecfg.local_cap(sc) // ecfg.async_n for sc in ecfg.pic.species]
    return engine_draws(ecfg.pic, keys, ecfg.async_n, ecfg.queue_migration,
                        caps_q, {i: g for i, (g, _) in loc.items()})


@pytest.mark.parametrize("d,an", ref_run.SAMPLES)
@pytest.mark.parametrize("case", ref_run.CASES)
def test_state_parity_with_reference(reference_runs, case, d, an):
    z = reference_runs
    tag = f"{case}/{d}x{an}"
    ecfg = _ecfg(case, d, an)
    length = ecfg.local_nc() * ecfg.pic.dx
    state = engine.state_from_numpy(ecfg, _arrays(z, tag, 0, ecfg),
                                    device="cpu")
    step = engine.make_engine_step(ecfg)
    keys = z[f"{tag}/s0/key"]
    for t in range(ref_run.STEPS):
        draws, keys = _draws(ecfg, keys)
        np.testing.assert_array_equal(keys, z[f"{tag}/s{t + 1}/key"])
        state, diag = step(state, draws)
        want = _arrays(z, tag, t + 1, ecfg)
        where = (tag, t)
        for key, v in diag.items():
            if key.rsplit("/", 1)[-1] in COUNTERS:
                np.testing.assert_array_equal(
                    n(v), z[f"{tag}/d{t}/{key}"], err_msg=str((where, key)))
        for sc, got, w in zip(ecfg.pic.species, state.species,
                              want["species"]):
            np.testing.assert_array_equal(n(got.alive), w["alive"],
                                          err_msg=str((where, sc.name)))
            assert np.max(periodic_dist(n(got.x), w["x"], length)) <= \
                TOL["atol"] + TOL["rtol"] * length, (where, sc.name)
            np.testing.assert_allclose(n(got.v), w["v"], **TOL,
                                       err_msg=str((where, sc.name)))
            np.testing.assert_allclose(n(got.w), w["w"], **TOL)
        for rg, w in zip(state.rings, want["rings"]):
            for f in ("slots", "head", "count"):
                np.testing.assert_array_equal(n(getattr(rg, f)), w[f],
                                              err_msg=str((where, f)))
        for p, w in zip(state.pending, want["pending"]):
            for f in ("dest", "alive"):
                np.testing.assert_array_equal(n(getattr(p, f)), w[f],
                                              err_msg=str((where, f)))
            np.testing.assert_allclose(n(p.x), w["x"], **TOL)
            np.testing.assert_allclose(n(p.v), w["v"], **TOL)
            np.testing.assert_allclose(n(p.w), w["w"], **TOL)
        if want["rho"] is not None:
            np.testing.assert_allclose(n(state.rho), want["rho"], rtol=1e-3,
                                       atol=1e-3)
            np.testing.assert_allclose(n(state.rho).sum(dtype=np.float64),
                                       want["rho"].sum(dtype=np.float64),
                                       rtol=1e-5, atol=1e-4)
        for sc in ecfg.pic.species:
            np.testing.assert_allclose(
                n(diag[f"{sc.name}/charge"]),
                z[f"{tag}/d{t}/{sc.name}/charge"], rtol=1e-6)
            np.testing.assert_allclose(n(diag[f"{sc.name}/ke"]),
                                       z[f"{tag}/d{t}/{sc.name}/ke"],
                                       rtol=1e-4)


# ----------------------------------------------- (b) the reference contracts

def _cfg(nc=64, *, field_solve=True, boundary="periodic", strategy="fused",
         n=1024, cap=2048, dt=0.2):
    """``tests/test_async_engine.py``'s plasma at a smaller size."""
    sp = (pic.SpeciesConfig("e", -1.0, 1.0, cap, n, vth=1.0, weight=0.02),
          pic.SpeciesConfig("D+", 1.0, 3672.0, cap, n, vth=0.02,
                            weight=0.02))
    return pic.PICConfig(nc=nc, dx=1.0, dt=dt, species=sp,
                         field_solve=field_solve, boundary=boundary,
                         strategy=strategy)


N0, CAP = 512, 2048


def _ion_cfg(*, field_solve=False, rate=5e-3, see=False, boundary="periodic"):
    """``tests/test_mc_sources_engine.py``'s (e-, D+, D) triple, weight 1.0
    (every charge total an exact integer), optionally with SEE."""
    sp = (pic.SpeciesConfig("e", -1.0, 1.0, CAP, N0, vth=1.0),
          pic.SpeciesConfig("D+", 1.0, 3672.0, CAP, N0, vth=0.02),
          pic.SpeciesConfig("D", 0.0, 3672.0, CAP, N0, vth=0.05))
    kw = {}
    if see:
        boundary = "absorb"
        kw = dict(wall_emission=((0, 0),), emission_yield=0.7,
                  emission_vth=0.5)
    return pic.PICConfig(
        nc=64, dx=1.0, dt=0.1 if field_solve else 0.4, species=sp,
        field_solve=field_solve, boundary=boundary, strategy="fused",
        ionization=(2, 0, 1), ionization_rate=rate, ionization_vth_e=1.0,
        **kw)


def _see_cfg():
    sp = (pic.SpeciesConfig("e", -1.0, 1.0, CAP, N0, vth=1.5),
          pic.SpeciesConfig("D+", 1.0, 3672.0, CAP, N0, vth=0.02))
    return pic.PICConfig(nc=64, dx=1.0, dt=0.4, species=sp,
                         field_solve=False, boundary="absorb",
                         strategy="unified", wall_emission=((0, 0),),
                         emission_yield=0.8, emission_vth=0.5)


_SUMMED = ("n_ionized", "birth_overflow", "migration_overflow",
           "merge_dropped", "wall_absorbed", "emitted", "emission_overflow",
           "migrated_left", "migrated_right", "coll_elastic", "coll_cx",
           "coll_coulomb")


def _run(cfg, d, an, steps, *, seed=3, **kw):
    """Run the port's engine on the CPU; returns (last diag as numpy,
    per-key sums of the event counters)."""
    ecfg = engine.EngineConfig(pic=cfg, domains=d, async_n=an,
                               **{"max_migration": 256, "max_births": 256,
                                  **kw})
    state = engine.init_engine_state(ecfg, seed, device="cpu")
    step = engine.make_engine_step(ecfg)
    sums: dict = {}
    diag = {}
    for _ in range(steps):
        state, diag = step(state)
        for k, v in diag.items():
            if k.rsplit("/", 1)[-1] in _SUMMED:
                sums[k] = sums.get(k, 0) + int(v)
    return {k: n(v) for k, v in diag.items()}, sums


@pytest.fixture(scope="module")
def domain_reference():
    return _run(_cfg(), 1, 1, 10)


@pytest.mark.parametrize("d,an,reb", [
    (1, 2, 0), (1, 4, 0), (2, 1, 0), (2, 2, 0), (2, 4, 0), (4, 1, 0),
    (4, 2, 0), (4, 4, 0), (1, 2, 3), (2, 2, 3), (4, 4, 3)])
def test_domain_parity(domain_reference, d, an, reb):
    """Count and total charge equal the D = 1, async_n = 1 run exactly
    (charge summed in float64), KE statistically (each domain draws its own
    particles)."""
    ref, _ = domain_reference
    diag, sums = _run(_cfg(), d, an, 10, rebalance_every=reb)
    for sc in _cfg().species:
        name = sc.name
        assert diag[f"{name}/count"] == ref[f"{name}/count"], (d, an, reb)
        assert diag[f"{name}/charge"] == ref[f"{name}/charge"], (d, an, reb)
        np.testing.assert_allclose(diag[f"{name}/ke"], ref[f"{name}/ke"],
                                   rtol=0.15)
        assert sums[f"{name}/migration_overflow"] == 0
        assert sums[f"{name}/merge_dropped"] == 0
        assert diag[f"{name}/queue_occ"].shape == (an,)
    if d > 1:
        assert sums["e/migrated_left"] + sums["e/migrated_right"] > 0


def test_float32_charge_sums_differ_across_domain_splits():
    """Why the charge is summed in float64: the same weights summed in
    float32 over another split into domains round differently."""
    w = np.full(4096, np.float32(0.02))
    one = np.float32(0)
    for a in w:
        one += a
    four = np.float32(0)
    for part in np.split(w, 4):
        s = np.float32(0)
        for a in part:
            s += a
        four += s
    assert one != four
    assert w.astype(np.float64).sum() == np.split(w, 4)[0].astype(
        np.float64).sum() * 4


def test_async_queue_parity():
    """At D = 4 the queue split is scheduling only: async_n 1 and 4 see the
    same particles, so counts and charge agree exactly, KE to 1e-5."""
    a1, s1 = _run(_cfg(), 4, 1, 10)
    a4, s4 = _run(_cfg(), 4, 4, 10)
    for sc in _cfg().species:
        for k in ("count", "charge"):
            assert a1[f"{sc.name}/{k}"] == a4[f"{sc.name}/{k}"]
        np.testing.assert_allclose(a1[f"{sc.name}/ke"], a4[f"{sc.name}/ke"],
                                   rtol=1e-5)
    assert (s1["e/migrated_left"] + s1["e/migrated_right"]
            == s4["e/migrated_left"] + s4["e/migrated_right"])


@pytest.mark.parametrize("reb", [0, 4])
def test_absorb_conservation(reb):
    """Every particle is alive or was absorbed at a wall."""
    cfg = _cfg(boundary="absorb", field_solve=False, strategy="unified",
               dt=0.4)
    diag, sums = _run(cfg, 4, 2, 15, rebalance_every=reb)
    for sc in cfg.species:
        assert (int(diag[f"{sc.name}/count"])
                + sums[f"{sc.name}/wall_absorbed"] == sc.n_init), sc.name
        assert sums[f"{sc.name}/merge_dropped"] == 0
    assert sums["e/wall_absorbed"] > 0


def _assert_ionization_conserved(diag, sums, tag):
    """Exact pair accounting and exact integer charge totals."""
    ion = sums["n_ionized"]
    absorbed = {s: sums.get(f"{s}/wall_absorbed", 0) for s in ("e", "D+",
                                                                "D")}
    emitted = sums.get("e/emitted", 0)
    assert ion > 0, (tag, "MC source inactive")
    assert int(diag["e/count"]) == N0 + ion + emitted - absorbed["e"], tag
    assert int(diag["D+/count"]) == N0 + ion - absorbed["D+"], tag
    assert int(diag["D/count"]) == N0 - ion - absorbed["D"], tag
    assert diag["e/charge"] == -float(N0 + ion + emitted - absorbed["e"])
    assert diag["D+/charge"] == float(N0 + ion - absorbed["D+"]), tag
    assert diag["D/charge"] == 0.0, tag
    assert sums.get("e/migration_overflow", 0) == 0, tag
    assert sums.get("e/merge_dropped", 0) == 0, tag


@pytest.mark.parametrize("d,an,reb,skew,field", [
    (1, 2, 0, 0, False), (1, 4, 3, 0, True), (1, 2, 0, 8, False),
    (2, 2, 0, 0, True), (2, 4, 2, 0, False), (4, 1, 0, 4, False),
    (4, 4, 3, 0, True)])
def test_ionization_conservation(d, an, reb, skew, field):
    diag, sums = _run(_ion_cfg(field_solve=field), d, an, 8,
                      rebalance_every=reb, rebalance_skew=skew)
    _assert_ionization_conserved(diag, sums, (d, an, reb, skew, field))
    assert sums["birth_overflow"] == 0


def test_birth_budget_overflow_conserves():
    """A tiny max_births clamps the events; refused neutrals retry."""
    diag, sums = _run(_ion_cfg(rate=2e-2), 1, 2, 6, max_births=8)
    assert sums["birth_overflow"] > 0
    _assert_ionization_conserved(diag, sums, "budget")


def test_combined_sources_multidomain():
    """Ionization + SEE + absorbing walls together at D = 4."""
    diag, sums = _run(_ion_cfg(see=True), 4, 2, 8)
    _assert_ionization_conserved(diag, sums, "combined")
    assert sums["e/emitted"] > 0 and sums["e/wall_absorbed"] > 0


@pytest.mark.parametrize("cfg", [_ion_cfg(), _ion_cfg(field_solve=True),
                                 _see_cfg(), _ion_cfg(see=True)],
                         ids=["ion", "ion_field", "see", "ion_see"])
def test_ring_vs_legacy_merge_parity(cfg):
    """The ring and the legacy full-scan merge on the same generator
    streams draw the same events: counts, charge and event counts exact,
    KE to 1e-5 without wall emission. With it, the KE is not compared: the
    two merges put births in different slots, the absorbed rows of a later
    step are then packed in another order, and a secondary takes another
    row's velocity draw (the reference behaves the same; its own test
    passes on its seed)."""
    ring_d, ring_s = _run(cfg, 1, 2, 8, use_ring=True)
    leg_d, leg_s = _run(cfg, 1, 2, 8, use_ring=False)
    for sc in cfg.species:
        assert leg_s.get(f"{sc.name}/merge_dropped", 0) == 0
    for k in ("n_ionized", "birth_overflow", "e/emitted"):
        assert ring_s.get(k, 0) == leg_s.get(k, 0), k
    for sc in cfg.species:
        name = sc.name
        assert ring_d[f"{name}/count"] == leg_d[f"{name}/count"], name
        assert ring_d[f"{name}/charge"] == leg_d[f"{name}/charge"], name
        if not cfg.wall_emission:
            np.testing.assert_allclose(ring_d[f"{name}/ke"],
                                       leg_d[f"{name}/ke"], rtol=1e-5)


def _coll_cfg(kernel=False):
    """``tests/test_collisions_engine.py``'s menu on (e-, D+, D)."""
    from repro_torch.configs.pic_bit1 import make_collision_menu
    sp = (pic.SpeciesConfig("e", -1.0, 1.0, CAP, N0, vth=1.0),
          pic.SpeciesConfig("D+", 1.0, 3672.0, CAP, N0, vth=0.02),
          pic.SpeciesConfig("D", 0.0, 3672.0, CAP, N0, vth=0.05))
    return pic.PICConfig(
        nc=64, dx=1.0, dt=0.4, species=sp, field_solve=False,
        boundary="periodic", strategy="fused",
        collisions=make_collision_menu(rate_elastic=5e-2, rate_cx=5e-2,
                                       rate_coulomb=5e-2),
        collide_kernel=kernel)


@pytest.mark.parametrize("kernel,cell_order", [(False, False), (True, True)])
def test_collisions_on_the_engine(kernel, cell_order):
    """The menu runs per queue: counts constant, every counter > 0, the
    electron KE kept by elastic and e-e Coulomb scattering (field off)."""
    cfg = _coll_cfg(kernel)
    ecfg = engine.EngineConfig(pic=cfg, domains=4, async_n=2,
                               max_migration=256, rebalance_every=2,
                               cell_order=cell_order)
    state = engine.init_engine_state(ecfg, 3, device="cpu")
    step = engine.make_engine_step(ecfg)
    kes = []
    for _ in range(4):
        state, diag = step(state)
        kes.append(float(diag["e/ke"]))
        for k in ("coll_elastic", "coll_cx", "coll_coulomb"):
            assert int(diag[k]) > 0, k
        for sc in cfg.species:
            assert int(diag[f"{sc.name}/count"]) == N0
    np.testing.assert_allclose(kes[-1], kes[0], rtol=2e-4)


def test_engine_rejects_cross_group_collision_partners():
    cfg = _coll_cfg()
    sp = list(cfg.species)
    sp[2] = dataclasses.replace(sp[2], capacity=2 * CAP)
    cfg = dataclasses.replace(cfg, species=tuple(sp))
    ecfg = engine.EngineConfig(pic=cfg, domains=1, async_n=2,
                               max_migration=256)
    with pytest.raises(ValueError, match="capacity groups"):
        engine.make_engine_step(ecfg)


def _skewed_state(ecfg, cap, nlive, seed=0):
    """Every live slot in an even position: all particles in queue 0 of
    two."""
    rng = np.random.default_rng(seed)
    arrays = []
    for sc in ecfg.pic.species:
        alive = (np.arange(cap) % 2 == 0) & (np.arange(cap) < 2 * nlive)
        arrays.append({
            "x": rng.uniform(0, ecfg.pic.nc * ecfg.pic.dx, cap).astype(
                np.float32)[None],
            "v": (sc.vth * rng.normal(0, 1, (cap, 3))).astype(
                np.float32)[None],
            "w": np.where(alive, sc.weight, 0.0).astype(np.float32)[None],
            "alive": alive[None]})
    return arrays


def test_rebalance_bounds_skew_at_ingest():
    """One rebalance after a maximal skew: the ingest phase (``_ingest``,
    on a copy of the state) leaves every domain's per-queue occupancy
    skew at most 1 (the bound the compaction guarantees; churn after the
    ingest may move the full-step diag, which
    ``test_rebalance_full_step_diag_matches_reference`` holds to the
    reference's)."""
    cap, nlive = 1024, 256
    cfg = _cfg(nc=64, n=nlive, cap=cap, dt=0.1)
    ecfg = engine.EngineConfig(pic=cfg, domains=1, async_n=2,
                               max_migration=256, rebalance_every=1)
    arrays = {"species": _skewed_state(ecfg, cap, nlive), "step": 1,
              "rho": None}
    pstate = pic.PICState(species=tuple(
        pic.SpeciesBuffer(*(torch.from_numpy(a[f])
                            for f in ("x", "v", "w", "alive")))
        for a in arrays["species"]), gen=None, step=1)
    state = engine.attach_engine_state(ecfg, pstate)
    before = engine._queue_occupancy(state.groups[0].alive, 2)
    assert int((before.max(-1).values - before.min(-1).values).max()) == nlive
    plan = engine._plan(ecfg)
    work = engine._Work(plan, {}, perf._copy_state(state), None, None,
                        donate=True)
    engine._ingest(plan, work)
    occ = engine._queue_occupancy(work.sts[0].alive, 2)
    assert int((occ.max(-1).values - occ.min(-1).values).max()) <= 1
    aux = sum(st.alive.sum((1, 2)).float() for st in work.sts)
    assert int(aux.sum()) == 2 * nlive
    # the ingest on the copy left the input state as it was
    assert torch.equal(engine._queue_occupancy(state.groups[0].alive, 2),
                       before)


def test_rebalance_full_step_diag_matches_reference():
    """The same maximal skew through one full step of both engines (D = 1,
    the reference in this process): the diagnostics' counts, per-queue
    occupancy and skew are equal."""
    import jax
    from repro.core import pic as ref_pic
    from repro.core.particles import SpeciesBuffer as RefBuffer
    from repro.distributed import engine as ref_engine
    from repro.launch.mesh import make_debug_mesh

    cap, nlive = 1024, 256
    cfg = _cfg(nc=64, n=nlive, cap=cap, dt=0.1)
    rcfg = ref_run.case_config(ref_pic, "periodic_field")
    rcfg = ref_pic.PICConfig(
        nc=64, dx=1.0, dt=0.1, species=tuple(
            ref_pic.SpeciesConfig(sc.name, sc.charge, sc.mass, cap, nlive,
                                  vth=sc.vth, weight=sc.weight)
            for sc in cfg.species),
        field_solve=True, boundary="periodic", strategy="fused")
    ecfg = engine.EngineConfig(pic=cfg, domains=1, async_n=2,
                               max_migration=256, rebalance_every=1)
    arrays = _skewed_state(ecfg, cap, nlive)
    mesh = make_debug_mesh(data=1, model=1)
    recfg = ref_engine.EngineConfig(pic=rcfg, axis_names=("data",),
                                    async_n=2, max_migration=256,
                                    rebalance_every=1)
    bufs = [RefBuffer(*(jax.numpy.asarray(a[f])
                        for f in ("x", "v", "w", "alive"))) for a in arrays]
    rho = ref_pic.compute_rho(rcfg, tuple(jax.tree.map(lambda x: x[0], b)
                                          for b in bufs))
    jstate = ref_pic.PICState(species=tuple(bufs),
                              key=jax.random.PRNGKey(9)[None],
                              step=jax.numpy.ones((), jax.numpy.int32),
                              rho=rho[None])
    jstate = ref_engine.attach_engine_state(recfg, mesh, jstate)
    exported = ref_run.export(jstate)
    groups = engine._capacity_groups(ecfg)
    state = engine.state_from_numpy(ecfg, {
        "step": 1, "rho": exported["rho"],
        "species": [{f: exported[f"species/{i}/{f}"]
                     for f in ("x", "v", "w", "alive")}
                    for i in range(len(cfg.species))],
        "rings": [{f: exported[f"rings/{g}/{f}"]
                   for f in ("slots", "head", "count")}
                  for g in range(len(groups))],
        "pending": [{f: exported[f"pending/{g}/{f}"]
                     for f in ("x", "v", "w", "alive", "dest")}
                    for g in range(len(groups))]}, device="cpu")
    _, jdiag = ref_engine.make_engine_step(recfg, mesh)(jstate)
    _, diag = engine.make_engine_step(ecfg)(state)
    for sc in cfg.species:
        for k in ("count", "queue_occ", "queue_skew"):
            np.testing.assert_array_equal(
                n(diag[f"{sc.name}/{k}"]),
                np.asarray(jdiag[f"{sc.name}/{k}"]), err_msg=k)


@pytest.mark.parametrize("n_q", [1, 2, 4])
def test_queue_split_is_the_reference_interleave(n_q):
    """Queue k holds slots k, k + n_q, ... (so queue row j is slot
    j * n_q + k, the ring's slot arithmetic), and the merge inverts it."""
    from repro_torch.core.particles import StackedSpecies
    s, cap = 3, 16
    a = torch.arange(s * cap, dtype=torch.float32).reshape(s, cap)
    st = StackedSpecies(x=a, v=torch.stack([a, -a, 2 * a], -1), w=a + 0.5,
                        alive=a.long() % 3 == 0)
    qs = engine._split_queues(st, n_q)
    for k, q in enumerate(qs):
        assert torch.equal(q.x, a[:, k::n_q]) and q.x.is_contiguous()
    back = engine._merge_queues(qs, n_q)
    for f in ("x", "v", "w", "alive"):
        assert torch.equal(getattr(back, f), getattr(st, f))


@pytest.mark.parametrize("d,an", [(1, 1), (4, 2)])
def test_step_moves_edges_scalars_and_packs_only(d, an):
    """The engine's "no full-rho all_gather" pin, on the copy count: a
    step with the field solve and ionization moves between domains the
    field phase's edge nodes and scalars, the electron density's edge
    nodes, and the fixed-size migration packs, nothing more."""
    cfg = _ion_cfg(field_solve=True)
    ecfg = engine.EngineConfig(pic=cfg, domains=d, async_n=an,
                               max_migration=256, max_births=256)
    state = engine.init_engine_state(ecfg, 0, device="cpu")
    step = engine.make_engine_step(ecfg)
    halo.ppermute.moved = 0
    step(state)
    passes, s, m_q = cfg.smoothing_passes, len(cfg.species), 256 // an
    field = d * (2 + 2 * passes + 3 + 2)
    density = 2 * d
    packs = d * an * 2 * s * m_q * (1 + 3 + 1 + 1)   # x, v, w, alive
    assert halo.ppermute.moved == field + density + packs
    assert field + density < (ecfg.local_nc() + 1) * d


def test_async_n_must_divide_budget_and_capacity():
    with pytest.raises(ValueError):
        engine.EngineConfig(pic=_cfg(), async_n=3, max_migration=1024)
    ecfg = engine.EngineConfig(pic=_cfg(cap=8192, n=4096), async_n=5,
                               max_migration=1000)
    with pytest.raises(ValueError):
        engine.make_engine_step(ecfg)
    with pytest.raises(ValueError):
        engine.EngineConfig(pic=_ion_cfg(), async_n=2, max_migration=256,
                            max_births=7)


def test_unported_entry_points_name_their_roadmap_item():
    """The engine has no unported entry point left: the runtime parameters
    (item 5, once a stub) build a step that runs, and nothing in the
    engine raises ``NotImplementedError``. The restore and retune entry
    points of items 3 and 4 are held in ``test_torch_resilience`` and
    ``test_torch_autotune``, the params path in ``test_torch_params``."""
    from repro_torch.core.params import runtime_params

    ecfg = engine.EngineConfig(pic=_cfg())
    step = engine.make_engine_step(ecfg, with_params=True)
    state = engine.init_engine_state(ecfg, 0, device="cpu")
    state, diag = step(state, runtime_params(ecfg.pic, device="cpu"))
    assert int(diag["e/count"]) == 1024 and state.step == 1
    with open(engine.__file__) as f:
        assert "NotImplementedError" not in f.read()


def test_phase_breakdown_and_queue_stats():
    ecfg = engine.EngineConfig(pic=_ion_cfg(field_solve=True), domains=2,
                               async_n=2, max_migration=256,
                               max_births=256)
    state = engine.init_engine_state(ecfg, 1, device="cpu")
    before = n(state.groups[0].x).copy()
    probe = perf.phase_breakdown(ecfg, iters=1, warmup=0, state=state)
    assert set(probe["phases"]) == set(perf.PHASE_LABELS)
    assert abs(sum(probe["phases"].values()) - probe["total"]) < 1e-6 * max(
        probe["total"], 1.0)
    qs = perf.queue_stats(ecfg, steps=2, state=state)
    assert len(qs["queue_occ"]["e"]) == 2
    np.testing.assert_array_equal(n(state.groups[0].x), before)


def test_no_host_sync_inside_a_step():
    """Inside a step, no ``.item()``, ``torch.nonzero`` or
    ``torch.cuda.synchronize`` (the skew trigger's one read is ``tolist``
    on the ingest's skews)."""
    import ast
    import inspect
    src = inspect.getsource(engine)
    calls = [node for node in ast.walk(ast.parse(src))
             if isinstance(node, ast.Attribute)
             and node.attr in ("item", "nonzero", "synchronize")]
    assert not calls
    assert src.count(".tolist()") == 1


# ------------------------------------------------------ (c) the shim, (d) CLI

@pytest.mark.parametrize("d,boundary", [(1, "periodic"), (4, "periodic"),
                                        (4, "absorb")])
def test_decomposition_shim(d, boundary):
    """``tests/test_decomposition.py``'s contract through the shim."""
    from repro_torch.core import decomposition
    sp = (pic.SpeciesConfig("e", -1.0, 1.0, 4096, 2048, vth=1.0,
                            weight=0.02),
          pic.SpeciesConfig("D+", 1.0, 3672.0, 4096, 2048, vth=0.02,
                            weight=0.02),
          pic.SpeciesConfig("D", 0.0, 3672.0, 4096, 2048, vth=0.5))
    cfg = pic.PICConfig(nc=128, dx=1.0, dt=0.5, species=sp,
                        field_solve=True, boundary=boundary,
                        ionization=(2, 0, 1), ionization_rate=5e-4,
                        ionization_vth_e=1.0)
    dcfg = decomposition.DomainConfig(pic=cfg, domains=d, max_migration=512)
    state = decomposition.init_distributed_state(dcfg, 0, device="cpu")
    step = decomposition.make_distributed_step(dcfg)
    overflow = migrated = absorbed = 0
    for _ in range(8):
        state, diag = step(state)
        overflow += int(diag["e/migration_overflow"])
        migrated += int(diag["e/migrated_left"] + diag["e/migrated_right"])
        absorbed += int(diag["e/wall_absorbed"])
    assert overflow == 0
    e, i, nn = (int(diag[f"{s}/count"]) for s in ("e", "D+", "D"))
    if boundary == "periodic":
        assert e + nn == 2048 + 2048 and i - 2048 == 2048 - nn
    else:
        assert absorbed > 0 and e + absorbed >= 2048
    if d > 1:
        assert migrated > 0


def test_pic_run_engine_lines(capsys):
    """``pic_run --domains 4 --async-n 2 --field-solve --phases`` prints
    the reference launcher's lines, in its order, then one line a span
    name (host self ms and device ms a step; no device time on the
    CPU)."""
    import re
    from repro_torch.launch import pic_run
    pic_run.main(["--device", "cpu", "--domains", "4", "--async-n", "2",
                  "--field-solve", "--phases", "--steps", "2", "--nc", "128",
                  "--particles", "2048", "--strategy", "fused"])
    lines = capsys.readouterr().out.strip().splitlines()
    pats = [r"mc sources \(last step\): \{'n_ionized': \d+, "
            r"'birth_overflow': \d+\}",
            r"2 steps, 4 domain\(s\), async_n=2, rebalance_every=0, "
            r"strategy=fused: \d+\.\d\ds \(\d+\.\d ms/step\)",
            r"final populations: \{'e/count': \d+, 'D\+/count': \d+, "
            r"'D/count': \d+\}",
            r"queue balance: \{'e/queue_occ': \[\d+, \d+\], 'e/queue_skew': "
            r"\d+, .*\}",
            r"spans \(ms/step over 2 steps\): host self, device"]
    for pat, line in zip(pats, lines):
        assert re.fullmatch(pat, line), (pat, line)
    spans = [re.fullmatch(r"  ([\w/]+): [\d.]+, -", line).group(1)
             for line in lines[len(pats):]]
    assert spans[:2] == ["engine/step", "engine/ingest"]
    assert {"engine/queue/q1", "engine/ring/q1", "engine/merge",
            "halo/poisson"} <= set(spans)
    counts = [int(c) for c in re.findall(r"\d+", lines[2].split(":", 1)[1])]
    born = counts[0] - 2048
    assert born == counts[1] - 2048 == 2048 - counts[2] >= 0
