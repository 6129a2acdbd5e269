"""How the port's two deposit kernels (``repro_torch.kernels.deposit`` and
``fused_cycle``) pick their form, their host-side bookkeeping, and models of
the order in which each form sums, held against the reference's Pallas
kernels (``repro.kernels.ops``, interpret mode off-TPU).

The CUDA kernels run only on the card: their correctness rests on
``chip_smoke.py``, which holds each form against its plain version there, at
ragged shapes and at the main path's. What the CPU can check is the rule
that picks the form by grid size, the constants the host shares with the
device code, the launch counts and scratch buffers of the wrappers, and that
each form's way of summing gives the reference's rho: the pair form (node
pairs P[i] += (q(1-f), q f), then rho[j] = P[j].x + P[j-1].y) and the block
form (each persistent block deposits its grid-stride share of the slots into
its own copy of the nodes, then the blocks' rows are added in block order).
The models are test-side code; at rtol = atol = 1e-3, as
``tests/test_kernels.py`` holds rho, they check the order's arithmetic, not
a kernel. The total charge is held to 1e-5.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from _torch_parity import n, t
from repro.kernels import ops as ref_ops
from repro_torch.kernels import deposit as dep
from repro_torch.kernels import fused_cycle
from repro_torch.kernels.mover import cic

CSRC = Path(dep.__file__).resolve().parent.parent / "csrc"


@settings(max_examples=300, deadline=None)
@given(ng=st.integers(2, 2_000_000))
def test_deposit_form_by_grid_size(ng):
    """The block form exactly where the ng floats fit one block's shared
    memory, the pair form above; the threshold is one grid size."""
    form = dep.deposit_form(ng)
    assert form in dep.FORMS
    assert (form == "block") == (4 * ng <= dep.BLOCK_SMEM)
    if form == "block":
        assert dep.deposit_form(max(2, ng - 1)) == "block"
    else:
        assert dep.deposit_form(ng + 1) == "pair"


@pytest.mark.parametrize("ng,form", [
    (257, "block"),
    (4_097, "block"),           # the bench configuration
    (25_601, "block"),          # an engine domain at D = 4
    (58_112, "block"),          # the largest single block
    (58_113, "pair"),
    (102_401, "pair"),          # §3.3
    (600_001, "pair"),
])
def test_forms_at_the_grids_of_the_port(ng, form):
    assert dep.deposit_form(ng) == form


def test_constants_mirror_the_device_code():
    """BLOCK_THREADS is pic_common.cuh's kBlockThreads (the block model's
    stride depends on it), and BLOCK_SMEM is sm_90's 227 KB a block."""
    src = (CSRC / "pic_common.cuh").read_text()
    m = re.search(r"constexpr int kBlockThreads = (\d+);", src)
    assert m and int(m.group(1)) == dep.BLOCK_THREADS
    assert dep.BLOCK_SMEM == 227 * 1024


@pytest.mark.parametrize("wrapper", [dep.deposit,
                                     fused_cycle.fused_push_deposit],
                         ids=["deposit", "fused"])
def test_launch_counts_by_form(wrapper):
    """count_launch adds to the total and to its form's count (none for a
    fused launch without a deposit); reset_launches zeroes them all."""
    dep.reset_launches(wrapper)
    dep.count_launch(wrapper, "pair")
    dep.count_launch(wrapper, "block")
    dep.count_launch(wrapper, "block")
    dep.count_launch(wrapper, None)
    assert (wrapper.launches, wrapper.launches_block,
            wrapper.launches_pair) == (4, 2, 1)
    dep.reset_launches(wrapper)
    assert (wrapper.launches, wrapper.launches_block,
            wrapper.launches_pair) == (0, 0, 0)


def test_accumulators_by_form():
    """The block form's rows are one per block, the pair form's node pairs
    start at zero; rho is left for the kernel to write whole."""
    rho, rows = dep.accumulators("block", 5, 33, "cpu")
    assert rho.shape == (33,) and rows.shape == (5, 33)
    rho, pair = dep.accumulators("pair", 0, 33, "cpu")
    assert rho.shape == (33,) and pair.shape == (33, 2)
    assert not pair.any()


def _pair_model(x, q, *, x0, dx, nc):
    """rho as the pair form sums it: node pairs P[i] += (q(1-f), q f),
    then rho[j] = P[j].x + P[j-1].y (pic_common.cuh pair_finish_kernel)."""
    i, f = cic(x, x0, dx, nc)
    pair = torch.zeros(nc + 1, 2)
    pair[:, 0].index_add_(0, i, q * (1.0 - f))
    pair[:, 1].index_add_(0, i, q * f)
    rho = pair[:, 0].clone()
    rho[1:] += pair[:-1, 1]
    return rho


def _block_model(x, q, n_blocks, *, x0, dx, nc, species=1):
    """rho as the block kernels sum it: slot j of each species belongs to
    block (j mod stride) // threads, stride = n_blocks * threads; each block
    adds its share into its own row of nc+1 nodes, and rho is the rows
    added in block order."""
    stride = n_blocks * dep.BLOCK_THREADS
    cap = x.shape[0] // species
    j = torch.arange(x.shape[0]) % cap
    member = (j % stride) // dep.BLOCK_THREADS
    i, f = cic(x, x0, dx, nc)
    rows = []
    for b in range(n_blocks):
        sel = (member == b) & (q != 0)
        row = torch.zeros(nc + 1)
        row.index_add_(0, i[sel], q[sel] * (1.0 - f[sel]))
        row.index_add_(0, i[sel] + 1, q[sel] * f[sel])
        rows.append(row)
    rho = rows[0].clone()
    for row in rows[1:]:
        rho = rho + row
    return rho


def _model(form, x, q, n_blocks, *, x0, dx, nc, species=1):
    if form == "pair":
        return _pair_model(x, q, x0=x0, dx=dx, nc=nc)
    return _block_model(x, q, n_blocks, x0=x0, dx=dx, nc=nc, species=species)


RAGGED = [  # (cap, ng, n_blocks): cap no multiple of a block, several
    # blocks with slots and some without
    (5000, 257, 3), (5000, 257, 2), (7001, 513, 2), (9000, 1001, 1),
    (3000, 130, 5),
]


@pytest.mark.parametrize("form", dep.FORMS)
@pytest.mark.parametrize("cap,ng,n_blocks", RAGGED)
def test_deposit_order_matches_reference(cap, ng, n_blocks, form):
    rng = np.random.default_rng(cap + ng)
    L = 10.0
    dx = L / (ng - 1)
    x = rng.uniform(0, L, cap).astype(np.float32)
    q = (rng.random(cap) * (rng.random(cap) < 0.6)).astype(np.float32)
    got = _model(form, t(x), t(q), n_blocks, x0=0.0, dx=dx, nc=ng - 1)
    want = n(ref_ops.deposit(jnp.asarray(x), jnp.asarray(q), x0=0.0, dx=dx,
                             nc=ng - 1, ng=ng)) * dx
    np.testing.assert_allclose(n(got), want, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(float(got.double().sum()),
                               float(q.astype(np.float64).sum()), rtol=1e-5)
    np.testing.assert_allclose(
        n(got), n(dep.deposit_plain(t(x), t(q), x0=0.0, dx=dx, nc=ng - 1)),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("form", dep.FORMS)
@pytest.mark.parametrize("cap,ng,n_blocks", RAGGED[1:4])
def test_fused_deposit_order_matches_reference(cap, ng, n_blocks, form):
    """The stacked (3, cap) fused kernel's deposit in each form's order,
    against three reference fused kernels, one per species, with their own
    q/m, dt and charge."""
    rng = np.random.default_rng(cap)
    L = 10.0
    dx = L / (ng - 1)
    params = [(-1.0, 0.05, -1.0), (1 / 3672.0, 0.1, 1.0), (0.0, 0.2, 0.0)]
    x = rng.uniform(0, L, (3, cap)).astype(np.float32)
    v = rng.normal(0, 1, (3, cap, 3)).astype(np.float32)
    alive = rng.random((3, cap)) < 0.9
    w = (rng.random((3, cap)) * alive).astype(np.float32)
    e = rng.normal(0, 1, ng).astype(np.float32)
    f32 = torch.float32
    qm = torch.tensor([p[0] for p in params], dtype=f32)
    dts = torch.tensor([p[1] for p in params], dtype=f32)
    charge = torch.tensor([p[2] for p in params], dtype=f32)
    kw = dict(x0=0.0, dx=dx, nc=ng - 1, length=L, b=(0.0, 0.0, 0.0),
              boundary="periodic")
    xn, _, _, _, _, wn, _ = fused_cycle.fused_push_deposit_plain(
        t(x), t(v), t(w), t(alive), t(e), qm * dts, dts, charge,
        deposit=False, **kw)
    got = _model(form, xn.reshape(-1), (charge[:, None] * wn).reshape(-1),
                 n_blocks, x0=0.0, dx=dx, nc=ng - 1, species=3)
    want = np.zeros(ng)
    ref_kw = {k: a for k, a in kw.items() if k != "nc"}
    for s, (qm_s, dt_s, q_s) in enumerate(params):
        out = ref_ops.fused_push_deposit(
            *(jnp.asarray(a[s]) for a in (x, v, alive, w)), jnp.asarray(e),
            qm=qm_s, dt=dt_s, charge=q_s, **ref_kw)
        want += n(out[6]).astype(np.float64) * dx
    np.testing.assert_allclose(n(got), want, rtol=1e-3, atol=1e-3)
    total = float((charge[:, None].double() * wn.double()).sum())
    np.testing.assert_allclose(float(got.double().sum()), total, rtol=1e-5,
                               atol=1e-6)
