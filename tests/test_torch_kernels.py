"""The plain versions of the port's kernels against the reference's Pallas
kernels (``repro.kernels.ops``, interpret mode off-TPU) and oracles
(``repro.kernels.ref``), over the sweep of ``tests/test_kernels.py``.

Tolerances are those of ``tests/test_kernels.py``: x/v/w rtol = atol = 2e-5
(the reference bakes q/m*dt and the rotation scalars in float64, the port
forms them in float32), masks exact, rho rtol = atol = 1e-3 plus the
total-charge check (scatter-add order differs). The CUDA kernels themselves
run only on the card; ``chip_smoke.py`` holds them against these plain
versions there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import n, t
from repro.kernels import ops as ref_ops
from repro.kernels import ref
from repro_torch.kernels import deposit as port_deposit
from repro_torch.kernels import fused_cycle as port_fused
from repro_torch.kernels import mover as port_mover
from repro_torch.kernels import ops

LANES = 128
TOL = dict(rtol=2e-5, atol=2e-5)
BS = [(0.05, -0.1, 0.2), (0.0, 0.0, 0.0)]


def _mk(cap, ng, seed=0):
    rng = np.random.default_rng(seed)
    L = 10.0
    dx = L / (ng - 1)
    x = rng.uniform(0, L, cap).astype(np.float32)
    v = rng.normal(0, 1, (cap, 3)).astype(np.float32)
    alive = rng.random(cap) < 0.9
    e = rng.normal(0, 1, ng).astype(np.float32)
    return x, v, alive, e, L, dx


def _planes(a, block=8 * LANES):
    a = jnp.asarray(a)
    pad = (-a.shape[0]) % block
    return jnp.concatenate([a, jnp.zeros((pad,), a.dtype)]).reshape(-1, LANES)


def _unplane(p, cap):
    return np.asarray(p).reshape(-1)[:cap]


@pytest.mark.parametrize("cap,ng", [(1024, 129), (5000, 257)])
@pytest.mark.parametrize("boundary", ["periodic", "absorb", "open"])
@pytest.mark.parametrize("b", BS, ids=["b", "b0"])
def test_mover_plain_matches_reference(cap, ng, boundary, b):
    x, v, alive, e, L, dx = _mk(cap, ng)
    kw = dict(x0=0.0, dx=dx, length=L, qm=-1.0, dt=0.05, b=b,
              boundary=boundary)
    got = ops.mover_push(t(x), t(v), t(alive), t(e), nc=ng - 1, **kw)
    want_ops = ref_ops.mover_push(jnp.asarray(x), jnp.asarray(v),
                                  jnp.asarray(alive), jnp.asarray(e), **kw)
    ep = jnp.pad(jnp.asarray(e), (0, (-ng) % LANES))[None, :]
    rx, rvx, rvy, rvz, ra, rhl, rhr = ref.mover_push_ref(
        _planes(x), _planes(v[:, 0]), _planes(v[:, 1]), _planes(v[:, 2]),
        _planes(alive.astype(np.float32)), ep, nc=ng - 1, **kw)
    want_ref = (_unplane(rx, cap),
                np.stack([_unplane(p, cap) for p in (rvx, rvy, rvz)], -1),
                _unplane(ra, cap) > 0.5, _unplane(rhl, cap) > 0.5,
                _unplane(rhr, cap) > 0.5)
    for want in (want_ops, want_ref):
        np.testing.assert_allclose(n(got[0]), n(want[0]), **TOL)
        np.testing.assert_allclose(n(got[1]), n(want[1]), **TOL)
        for g, w in zip(got[2:], want[2:]):
            np.testing.assert_array_equal(n(g), n(w))


@pytest.mark.parametrize("cap,ng", [(1024, 129), (4096, 257), (3000, 513)])
def test_deposit_plain_matches_reference(cap, ng):
    x, _, alive, _, L, dx = _mk(cap, ng, seed=3)
    q = np.random.default_rng(4).random(cap).astype(np.float32) * alive
    got = n(ops.deposit(t(x), t(q), x0=0.0, dx=dx, nc=ng - 1))
    want_ops = n(ref_ops.deposit(jnp.asarray(x), jnp.asarray(q), x0=0.0,
                                 dx=dx, nc=ng - 1, ng=ng))
    ng_pad = ng + (-ng) % LANES
    want_ref = n(ref.deposit_ref(_planes(x, LANES), _planes(q, LANES),
                                 x0=0.0, dx=dx, nc=ng - 1,
                                 ng_pad=ng_pad))[0, :ng] / dx
    for want in (want_ops, want_ref):
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(got.sum() * dx, q.sum(), rtol=1e-5)


def _fused_ref(x, v, alive, w, e, L, dx, ng, qm, dt, charge, b, boundary):
    ep = jnp.pad(jnp.asarray(e), (0, (-ng) % LANES))[None, :]
    outs = ref.fused_push_deposit_ref(
        _planes(x), _planes(v[:, 0]), _planes(v[:, 1]), _planes(v[:, 2]),
        _planes(alive.astype(np.float32)), _planes(w), ep, x0=0.0, dx=dx,
        nc=ng - 1, length=L, qm=qm, dt=dt, charge=charge, b=b,
        boundary=boundary, ng_pad=ep.shape[1])
    cap = x.shape[0]
    rx, rvx, rvy, rvz, ra, rhl, rhr, rwn, rrho = outs
    return (_unplane(rx, cap),
            np.stack([_unplane(p, cap) for p in (rvx, rvy, rvz)], -1),
            _unplane(ra, cap) > 0.5, _unplane(rhl, cap) > 0.5,
            _unplane(rhr, cap) > 0.5, _unplane(rwn, cap),
            n(rrho)[0, :ng] / dx)


def _check_fused(got, want, rho_tol=1e-3):
    xg, vg, ag, hlg, hrg, wg, rhog = (n(a) for a in got)
    xw, vw, aw, hlw, hrw, ww, rhow = (n(a) for a in want)
    np.testing.assert_allclose(xg, xw, **TOL)
    np.testing.assert_allclose(vg, vw, **TOL)
    np.testing.assert_allclose(wg, ww, **TOL)
    np.testing.assert_array_equal(ag, aw)
    np.testing.assert_array_equal(hlg, hlw)
    np.testing.assert_array_equal(hrg, hrw)
    np.testing.assert_allclose(rhog, rhow, rtol=rho_tol, atol=rho_tol)


@pytest.mark.parametrize("cap,ng", [(1024, 129), (5000, 257)])
@pytest.mark.parametrize("boundary", ["periodic", "absorb", "open"])
@pytest.mark.parametrize("b", BS, ids=["b", "b0"])
def test_fused_plain_matches_reference(cap, ng, boundary, b):
    x, v, alive, e, L, dx = _mk(cap, ng, seed=7)
    w = np.random.default_rng(8).random(cap).astype(np.float32) * alive
    kw = dict(x0=0.0, dx=dx, length=L, b=b, boundary=boundary)
    f32 = torch.float32
    got = ops.fused_push_deposit(
        t(x)[None], t(v)[None], t(w)[None], t(alive)[None], t(e),
        torch.tensor([-0.05], dtype=f32), torch.tensor([0.05], dtype=f32),
        torch.tensor([-1.0], dtype=f32), nc=ng - 1, deposit=True, **kw)
    got = [a[0] for a in got[:6]] + [got[6]]
    jx = [jnp.asarray(a) for a in (x, v, alive, w, e)]
    want_ops = ref_ops.fused_push_deposit(*jx, qm=-1.0, dt=0.05,
                                          charge=-1.0, **kw)
    want_ref = _fused_ref(x, v, alive, w, e, L, dx, ng, -1.0, 0.05, -1.0, b,
                          boundary)
    for want in (want_ops, want_ref):
        _check_fused(got, want)
    np.testing.assert_allclose(n(got[6]).sum() * dx, -n(got[5]).sum(),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("boundary", ["periodic", "absorb"])
def test_fused_plain_stacked_matches_per_species_reference(boundary):
    """One (3, cap) plain call against three reference calls with their own
    q/m, dt and charge; rho is the sum of the three deposits."""
    cap, ng = 2000, 257
    params = [(-1.0, 0.05, -1.0), (1 / 3672.0, 0.1, 1.0), (0.0, 0.2, 0.0)]
    data = [_mk(cap, ng, seed=20 + s) for s in range(3)]
    e = data[0][3]
    L, dx = data[0][4], data[0][5]
    ws = [np.random.default_rng(30 + s).random(cap).astype(np.float32)
          * data[s][2] for s in range(3)]
    f32 = torch.float32
    qm = torch.tensor([p[0] for p in params], dtype=f32)
    dts = torch.tensor([p[1] for p in params], dtype=f32)
    b = (0.05, -0.1, 0.2)
    got = ops.fused_push_deposit(
        t(np.stack([d[0] for d in data])), t(np.stack([d[1] for d in data])),
        t(np.stack(ws)), t(np.stack([d[2] for d in data])), t(e), qm * dts,
        dts, torch.tensor([p[2] for p in params], dtype=f32), x0=0.0, dx=dx,
        nc=ng - 1, length=L, b=b, boundary=boundary, deposit=True)
    rho_want = np.zeros(ng, np.float32)
    for s, (qm_s, dt_s, q_s) in enumerate(params):
        x, v, alive = data[s][0], data[s][1], data[s][2]
        want = _fused_ref(x, v, alive, ws[s], e, L, dx, ng, qm_s, dt_s, q_s,
                          b, boundary)
        _check_fused([a[s] for a in got[:6]] + [want[6]], want)
        rho_want += want[6]
    np.testing.assert_allclose(n(got[6]), rho_want, rtol=1e-3, atol=1e-3)


def test_fused_without_deposit_returns_no_rho_and_keeps_input_w():
    x, v, alive, e, L, dx = _mk(512, 65, seed=11)
    w = np.ones(512, np.float32) * alive
    tw = t(w)[None]
    f32 = torch.float32
    out = ops.fused_push_deposit(
        t(x)[None], t(v)[None], tw, t(alive)[None], t(e),
        torch.tensor([-0.05], dtype=f32), torch.tensor([0.05], dtype=f32),
        torch.tensor([-1.0], dtype=f32), x0=0.0, dx=dx, nc=64, length=L,
        boundary="absorb", deposit=False)
    assert out[6] is None
    np.testing.assert_array_equal(n(tw[0]), w)           # input untouched
    np.testing.assert_array_equal(n(out[5][0]), w * n(out[2][0]))


def test_plain_versions_mirror_each_other():
    """The fused plain version is the mover plain version plus a deposit."""
    x, v, alive, e, L, dx = _mk(3000, 129, seed=12)
    w = np.ones(3000, np.float32) * alive
    kw = dict(x0=0.0, dx=dx, nc=128, length=L, b=(0.0, 0.3, 0.0),
              boundary="absorb")
    qm_dt = np.float32(-1.0) * np.float32(0.05)
    mv = port_mover.mover_push_plain(t(x), t(v), t(alive), t(e),
                                     qm_dt=float(qm_dt), dt=0.05, **kw)
    f32 = torch.float32
    fu = port_fused.fused_push_deposit_plain(
        t(x)[None], t(v)[None], t(w)[None], t(alive)[None], t(e),
        torch.tensor([qm_dt]), torch.tensor([0.05], dtype=f32),
        torch.tensor([2.0], dtype=f32), deposit=True, **kw)
    for a, b in zip(mv, fu[:5]):
        assert torch.equal(a, b[0])
    dep = port_deposit.deposit_plain(fu[0][0], 2.0 * fu[5][0], x0=0.0,
                                     dx=dx, nc=128)
    assert torch.equal(dep, fu[6])


@pytest.mark.parametrize("fn,args", [
    (port_fused.fused_push_deposit, "fused"),
    (port_mover.mover_push, "mover"),
    (port_deposit.deposit, "deposit"),
], ids=["fused", "mover", "deposit"])
def test_cuda_wrappers_refuse_cpu_tensors(fn, args):
    """A kernel wrapper never computes on the CPU: it raises before any
    build or launch, and its launch count stays put."""
    x = torch.zeros(4)
    before = fn.launches
    with pytest.raises(ValueError, match="CUDA kernel"):
        if args == "fused":
            fn(x[None], torch.zeros(1, 4, 3), x[None], x[None] > 0,
               torch.zeros(9), x[:1], x[:1], x[:1], x0=0.0, dx=1.0, nc=8,
               length=8.0, b=(0.0, 0.0, 0.0), boundary="periodic",
               deposit=True)
        elif args == "mover":
            fn(x, torch.zeros(4, 3), x > 0, torch.zeros(9), x0=0.0, dx=1.0,
               nc=8, length=8.0, qm_dt=0.1, dt=0.1, b=(0.0, 0.0, 0.0),
               boundary="periodic")
        else:
            fn(x, x, x0=0.0, dx=1.0, nc=8)
    assert fn.launches == before


def test_ops_refuse_other_devices():
    x = torch.zeros(4, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ops.deposit(x, x, x0=0.0, dx=1.0, nc=8)
