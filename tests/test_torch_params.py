"""Runtime parameters in the port (``repro_torch.core.params``, the params
path of ``core.pic``, ``core.collisions.apply_menu(rates=)`` and
``distributed.engine.make_engine_step(with_params=True)``) against the
reference's ``repro.core.params`` and its params paths.

* ``RuntimeParams`` equal to the reference's bit for bit, and the same
  ``ValueError``s;
* a step with params equal to the step with the config's values bit for
  bit (the reference's contract), single-domain and on the engine;
* 'explicit' and 'async_batched' refuse params, naming the strategy;
* at a parameter point other than the config's, the port's step on the
  reference's draws within ``tests/test_torch_pic.py``'s bands (counts,
  masks and event counters exact; x, v, w rtol = atol = 2e-5; with the
  field on, v within 1e-4 of max|v| and each step restarted from the
  reference's state), and the engine within ``tests/test_torch_engine.py``'s.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_engine_ref as ref_run
from _torch_parity import menu_draws, n, periodic_dist, port_state, \
    step_draws, t
from repro.configs import pic_bit1 as ref_cfgs
from repro.core import collisions as ref_coll
from repro.core import params as ref_params
from repro.core import pic as ref_pic
from repro_torch.configs import pic_bit1 as port_cfgs
from repro_torch.core import collisions as C
from repro_torch.core import params as P
from repro_torch.core import pic
from repro_torch.distributed import engine
from test_torch_engine import COUNTERS, TOL, _arrays, _draws

HERE = os.path.dirname(__file__)
SRC = os.path.join(HERE, "..", "src")
B = (0.0, 0.01, 0.05)
# a parameter point that moves every runtime scalar off the config's
POINT = dict(dt=0.3, ionization_rate=3e-2, emission_yield=0.4,
             b_field=(0.0, 0.0, 0.1))
RATES = (4e-2, 3e-2, 2e-2)


def _pair(name, nc=64, n=512, strategy="fused", field=True):
    """(reference config, port config) of one scenario."""
    out = []
    for cfgs in (ref_cfgs, port_cfgs):
        if name == "bench":
            cfg = cfgs.make_bench_config(nc=nc, n=n, strategy=strategy)
        elif name == "see":
            cfg = cfgs.make_see_config(nc=nc, n=n, strategy=strategy)
        elif name == "collision":
            cfg = cfgs.make_collision_config(nc=nc, n=n, strategy=strategy)
        else:
            cfg = dataclasses.replace(cfgs.make_resilience_config(
                nc=nc, n=n, strategy=strategy, field_solve=field),
                b_field=B)
        out.append(cfg)
    return out


def _split(kw):
    kw = dict(kw)
    return kw.pop("collision_rates", None), kw


# ------------------------------------------------ the params themselves

@pytest.mark.parametrize("name,over", [
    ("bench", {}),
    ("bench", {"dt": 0.37, "ionization_rate": 1.3e-3}),
    ("see", {"emission_yield": 0.31}),
    ("collision", {"collision_rates": (1e-3, 2.5e-3, 7e-4)}),
    ("resilience", dict(POINT, collision_rates=RATES)),
])
def test_runtime_params_equal_the_reference(name, over):
    rcfg, cfg = _pair(name)
    rates, kw = _split(over)
    want = ref_params.runtime_params(rcfg, collision_rates=rates, **kw)
    got = P.runtime_params(cfg, collision_rates=rates, device="cpu", **kw)
    assert [f.name for f in dataclasses.fields(P.RuntimeParams)] == \
        [f.name for f in dataclasses.fields(ref_params.RuntimeParams)]
    for f in ("dt", "dts", "qm_dts", "b_field", "ionization_rate",
              "emission_yield"):
        a, b = n(getattr(got, f)), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert len(got.collision_rates) == len(want.collision_rates)
    for a, b in zip(got.collision_rates, want.collision_rates):
        np.testing.assert_array_equal(n(a), np.asarray(b))
    # the kernels' host copy of b: the tensor's values, as floats
    assert got.b_host == tuple(float(c) for c in np.asarray(want.b_field))
    assert P.b_active(cfg) == ref_params.b_active(rcfg)
    frm = P.RuntimeParams.from_config(cfg, device="cpu")
    rfrm = ref_params.RuntimeParams.from_config(rcfg)
    np.testing.assert_array_equal(n(frm.qm_dts), np.asarray(rfrm.qm_dts))


@pytest.mark.parametrize("kw", [{"nc": 128}, {"strategy": "unified"},
                                {"collision_rates": (1e-3,)}])
def test_runtime_params_errors_equal_the_reference(kw):
    rcfg, cfg = _pair("resilience")
    rates, kw = _split(kw)
    with pytest.raises(ValueError) as want:
        ref_params.runtime_params(rcfg, collision_rates=rates, **kw)
    with pytest.raises(ValueError) as got:
        P.runtime_params(cfg, collision_rates=rates, device="cpu", **kw)
    assert str(got.value) == str(want.value)


def test_runtime_fields_and_b_gate():
    assert P.RUNTIME_FIELDS == ref_params.RUNTIME_FIELDS
    _, cfg = _pair("resilience")
    assert P.b_active(cfg)
    assert not P.b_active(dataclasses.replace(cfg, b_field=(0.0, 0.0, 0.0)))


# --------------------------------------- params against static, bitwise

def _same_state(a, b, ctx):
    for i, (x, y) in enumerate(zip(a.species, b.species)):
        for f in ("x", "v", "w", "alive"):
            assert torch.equal(getattr(x, f), getattr(y, f)), (ctx, i, f)
    assert (a.rho is None) == (b.rho is None), ctx
    assert a.rho is None or torch.equal(a.rho, b.rho), ctx
    assert a.step == b.step, ctx
    assert torch.equal(a.gen.get_state(), b.gen.get_state()), ctx


@pytest.mark.parametrize("name,strategy,field", [
    ("resilience", "unified", True), ("resilience", "unified", False),
    ("resilience", "fused", True), ("resilience", "fused", False),
    ("see", "fused", False), ("bench", "fused", False),
])
def test_params_step_equals_static_step_bitwise(name, strategy, field):
    """SEE, the full menu, ionization and b on (the resilience config),
    field on and off: 4 steps with params equal the static steps bit for
    bit, state, generator and diagnostics."""
    _, cfg = _pair(name, strategy=strategy)
    if name != "resilience":
        cfg = dataclasses.replace(cfg, field_solve=field)
    rp = P.runtime_params(cfg, device="cpu")
    a = pic.init_state(cfg, 3, device="cpu")
    b = pic.init_state(cfg, 3, device="cpu")
    step = pic.make_step(cfg)
    for k in range(4):
        a, da = step(a)
        b, db = step(b, rp)
        assert list(da) == list(db)
        for key in da:
            assert torch.equal(da[key], db[key]), (k, key)
    _same_state(a, b, name)


def test_params_run_equals_static_run():
    _, cfg = _pair("resilience")
    rp = P.runtime_params(cfg, device="cpu")
    a, da = pic.run(cfg, 3, seed=2, device="cpu")
    b, db = pic.run(cfg, 3, seed=2, params=rp, device="cpu")
    _same_state(a, b, "run")
    assert all(torch.equal(da[k], db[k]) for k in da)


def test_zero_config_b_ignores_the_params_b():
    """The structural gate: with the config's b all zero the step keeps
    its no-rotation program, whatever b the params carry."""
    _, cfg = _pair("resilience", field=False)
    cfg = dataclasses.replace(cfg, b_field=(0.0, 0.0, 0.0))
    rp = P.runtime_params(cfg, device="cpu", b_field=(0.0, 0.3, 0.0))
    rp0 = P.runtime_params(cfg, device="cpu")
    a = pic.init_state(cfg, 1, device="cpu")
    b = pic.init_state(cfg, 1, device="cpu")
    a, _ = pic.step_fn(a, cfg, rp)
    b, _ = pic.step_fn(b, cfg, rp0)
    _same_state(a, b, "zero b")


@pytest.mark.parametrize("strategy", ["explicit", "async_batched"])
def test_params_refused_where_the_reference_refuses(strategy):
    _, cfg = _pair("resilience", strategy=strategy)
    rp = P.runtime_params(cfg, device="cpu")
    state = pic.init_state(cfg, 3, device="cpu")
    with pytest.raises(NotImplementedError, match=strategy):
        pic.make_step(cfg)(state, rp)


# ----------------------------- a parameter point against the reference

@pytest.mark.parametrize("strategy,field", [("unified", False),
                                            ("fused", False),
                                            ("fused", True)])
def test_params_step_matches_reference(strategy, field):
    """4 steps at ``POINT`` with the menu's rates moved: the port on the
    reference's draws against the reference's params step. With the field
    on, each port step starts from the reference's state (its float32
    field solve and the port's float64 one drift apart, as in
    ``tests/test_torch_pic.py``)."""
    rcfg, cfg = _pair("resilience", strategy=strategy, field=field)
    rcfg = dataclasses.replace(rcfg, ionization_rate=5e-2)
    cfg = dataclasses.replace(cfg, ionization_rate=5e-2)
    rrp = ref_params.runtime_params(rcfg, collision_rates=RATES, **POINT)
    prp = P.runtime_params(cfg, collision_rates=RATES, device="cpu",
                           **POINT)
    jstate = ref_pic.init_state(rcfg, 4)
    pstate = port_state(cfg, jstate)
    jstep = jax.jit(lambda s, p: ref_pic.step_fn(s, rcfg, p))
    totals = {}
    for k in range(4):
        draws = step_draws(cfg, jstate.key)
        if field:
            pstate = port_state(cfg, jstate)
        jstate, jd = jstep(jstate, rrp)
        pstate, pd = pic.step_fn(pstate, cfg, prp, draws)
        assert set(pd) == set(jd)
        for key in jd:
            if np.asarray(jd[key]).dtype.kind in "iu":
                assert int(n(pd[key])) == int(jd[key]), (k, key)
                totals[key] = totals.get(key, 0) + int(jd[key])
        for jb, pb in zip(jstate.species, pstate.species):
            np.testing.assert_array_equal(n(pb.alive), n(jb.alive))
            np.testing.assert_allclose(n(pb.x), n(jb.x), rtol=2e-5,
                                       atol=2e-5)
            jv = n(jb.v)
            band = (1e-4 * np.abs(jv).max() if field
                    else 2e-5 * (1.0 + np.abs(jv)))
            assert (np.abs(n(pb.v) - jv) <= band).all(), (k, strategy)
            np.testing.assert_allclose(n(pb.w), n(jb.w), rtol=2e-5,
                                       atol=2e-5)
        if pic._carries_rho(cfg):
            np.testing.assert_allclose(n(pstate.rho), n(jstate.rho),
                                       rtol=1e-3, atol=1e-3)
    # every source fired at this point: the test exercises each param
    for key in ("n_ionized", "e/emitted", "coll_elastic", "coll_cx",
                "coll_coulomb"):
        assert totals[key] > 0, (key, totals)


def test_apply_menu_rates_match_reference():
    rg = ref_pic.PICConfig(nc=32).grid
    pg = pic.PICConfig(nc=32).grid
    rng = np.random.default_rng(8)
    bufs = []
    for vth, holes in ((1.0, 9), (0.05, 7), (0.02, 4)):
        x = rng.uniform(0, rg.length, 2048).astype(np.float32)
        v = (vth * rng.normal(size=(2048, 3))).astype(np.float32)
        alive = np.arange(2048) < 1600
        alive[::holes] = False
        w = np.ones(2048, np.float32) * alive
        bufs.append((x, v, w, alive))
    menu = ref_cfgs.make_collision_menu()
    pmenu = port_cfgs.make_collision_menu()
    rbufs = {i: ref_pic.SpeciesBuffer(*(jnp.asarray(a) for a in b))
             for i, b in enumerate(bufs)}
    pbufs = {i: pic.SpeciesBuffer(*(t(a) for a in b))
             for i, b in enumerate(bufs)}
    rdens = {i: ref_coll.cell_density(rg, rbufs[i])
             for i in ref_coll.density_species(menu)}
    key = jax.random.PRNGKey(41)
    rates = (3e-2, 2e-2, 1.5e-2)
    want, wd = ref_coll.apply_menu(
        key, dict(rbufs), menu, rdens, rg, jnp.float32(0.8),
        rates=tuple(jnp.float32(r) for r in rates))
    got, gd = C.apply_menu(
        torch.Generator(), pbufs, pmenu,
        {i: t(n(d)) for i, d in rdens.items()}, pg,
        torch.tensor(0.8), draws=menu_draws(menu, key, [2048] * 3),
        rates=[torch.tensor(r) for r in rates])
    assert {k: int(v) for k, v in gd.items()} == \
        {k: int(v) for k, v in wd.items()}
    assert min(int(v) for v in gd.values()) > 0
    # other rates, other events: the rates were read
    _, sd = C.apply_menu(
        torch.Generator(), pbufs, pmenu,
        {i: t(n(d)) for i, d in rdens.items()}, pg, 0.8,
        draws=menu_draws(menu, key, [2048] * 3))
    assert {k: int(v) for k, v in sd.items()} != \
        {k: int(v) for k, v in gd.items()}
    for i in range(3):
        np.testing.assert_array_equal(n(got[i].alive), n(want[i].alive))
        np.testing.assert_allclose(n(got[i].v), n(want[i].v), rtol=1e-6,
                                   atol=1e-6)


# ------------------------------------------------------------ the engine

def _engine_cfg(d, an, cfg=None):
    cfg = cfg or ref_run.params_config(pic, port_cfgs)
    return engine.EngineConfig(pic=cfg, domains=d, async_n=an,
                               max_migration=ref_run.MAX_MIGRATION,
                               max_births=ref_run.MAX_BIRTHS)


def _point(cfg):
    point = dict(ref_run.PARAMS_POINT)
    rates = point.pop("collision_rates")
    return P.runtime_params(cfg, collision_rates=rates, device="cpu",
                            **point)


@pytest.mark.parametrize("d,an", [(1, 1), (2, 2)])
def test_engine_params_step_equals_static_step_bitwise(d, an):
    _, cfg = _pair("resilience", n=512)
    ecfg = port_cfgs.make_engine_config(cfg, domains=d, async_n=an,
                                        max_migration=256, max_births=256)
    rp = P.runtime_params(cfg, device="cpu")
    sa = engine.init_engine_state(ecfg, 5, device="cpu")
    sb = engine.init_engine_state(ecfg, 5, device="cpu")
    step_a = engine.make_engine_step(ecfg)
    step_b = engine.make_engine_step(ecfg, with_params=True)
    for k in range(4):
        sa, da = step_a(sa)
        sb, db = step_b(sb, rp)
        assert list(da) == list(db)
        for key in da:
            assert torch.equal(da[key], db[key]), (d, an, k, key)
    ta, tb = _flat(engine.state_tree(sa)), _flat(engine.state_tree(sb))
    assert list(ta) == list(tb)
    for key in ta:
        assert np.array_equal(_np(ta[key]), _np(tb[key])), key
    for ga, gb in zip(sa.gens, sb.gens):
        assert torch.equal(ga.get_state(), gb.get_state())


def _flat(tree, pre=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat(v, f"{pre}/{k}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{pre}/{i}"))
    else:
        out[pre] = tree
    return out


def _np(a):
    return n(a) if isinstance(a, torch.Tensor) else np.asarray(a)


@pytest.fixture(scope="module")
def reference_params_runs(tmp_path_factory):
    """The reference's ``with_params`` engine at ``PARAMS_POINT``."""
    out = tmp_path_factory.mktemp("params_ref") / "ref.npz"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.abspath(SRC) + os.pathsep + HERE
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    env["JAX_PLATFORMS"] = "cpu"
    res = subprocess.run([sys.executable,
                          os.path.join(HERE, "_torch_engine_ref.py"),
                          str(out), "--params"], env=env,
                         capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    with np.load(out) as z:
        return dict(z)


@pytest.mark.parametrize("d,an", ref_run.PARAMS_SAMPLES)
def test_engine_params_step_matches_reference(reference_params_runs, d, an):
    """The port's ``with_params`` engine on the reference's draws against
    the reference's, state by state: counters, masks, rings and pending
    exact, floats within ``tests/test_torch_engine.py``'s bands."""
    z = reference_params_runs
    tag = f"{ref_run.PARAMS_CASE}/{d}x{an}"
    ecfg = _engine_cfg(d, an)
    rp = _point(ecfg.pic)
    length = ecfg.local_nc() * ecfg.pic.dx
    state = engine.state_from_numpy(ecfg, _arrays(z, tag, 0, ecfg),
                                    device="cpu")
    step = engine.make_engine_step(ecfg, with_params=True)
    keys = z[f"{tag}/s0/key"]
    fired = dict.fromkeys(("n_ionized", "e/emitted", "coll_elastic",
                           "coll_cx", "coll_coulomb"), 0)
    for k in range(ref_run.STEPS):
        draws, keys = _draws(ecfg, keys)
        state, diag = step(state, rp, draws)
        want = _arrays(z, tag, k + 1, ecfg)
        for key, v in diag.items():
            tail = key.rsplit("/", 1)[-1]
            if tail in COUNTERS or key.startswith("coll_"):
                np.testing.assert_array_equal(
                    n(v), z[f"{tag}/d{k}/{key}"], err_msg=str((k, key)))
            if key in fired:
                fired[key] += int(v)
        for got, w in zip(state.species, want["species"]):
            np.testing.assert_array_equal(n(got.alive), w["alive"])
            assert np.max(periodic_dist(n(got.x), w["x"], length)) <= \
                TOL["atol"] + TOL["rtol"] * length, k
            np.testing.assert_allclose(n(got.v), w["v"], **TOL)
            np.testing.assert_allclose(n(got.w), w["w"], **TOL)
        for rg, w in zip(state.rings, want["rings"]):
            for f in ("slots", "head", "count"):
                np.testing.assert_array_equal(n(getattr(rg, f)), w[f])
        for p, w in zip(state.pending, want["pending"]):
            for f in ("dest", "alive"):
                np.testing.assert_array_equal(n(getattr(p, f)), w[f])
            np.testing.assert_allclose(n(p.v), w["v"], **TOL)
    assert min(fired.values()) > 0, fired
