"""The births of the MC sources written in place (``kernels.ops
.place_births_``, ``particles.inject_masked(donate=True)``,
``collisions.ionize(donate=True)``) on the CPU, where ``ops`` takes the
plain version: the rule against a statement of it in numpy, the donating
forms against the functional ones and the reference's draws, and
``pic.step_fn``, which donates its own buffers to the sources, leaving its
input state unchanged.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import n, t
from repro.core import collisions as ref_coll
from repro.core import grid as ref_grid
from repro.core import particles as ref_particles
from repro_torch.core import collisions, grid, particles, pic
from repro_torch.kernels import ops

CAP, M = 1000, 700


def _buffer(rng, cap, alive):
    return particles.SpeciesBuffer(
        x=t(rng.uniform(0, 64, cap).astype(np.float32)),
        v=t(rng.normal(size=(cap, 3)).astype(np.float32)),
        w=t((rng.random(cap).astype(np.float32) + 0.5) * alive),
        alive=t(alive))


def _case(name, seed=0):
    """(mask (M,), alive of two targets (CAP,)) of one edge case."""
    rng = np.random.default_rng(seed)
    mask = rng.random(M) < 0.02
    alive = [rng.random(CAP) < 0.9, rng.random(CAP) < 0.8]
    if name == "no_hit":
        mask[:] = False
    elif name == "overflow":
        mask = rng.random(M) < 0.5                 # ~350 hits, ~100 free
    elif name == "full":
        alive[1][:] = True
    elif name == "last":
        mask[:] = False
        mask[-1] = True
        for a in alive:
            a[:] = True
            a[-1] = False
    return mask, alive


def _rule(mask, alive):
    """The landing rule in numpy: (landed candidates, each target's
    slots)."""
    n_land = min([int(mask.sum())] + [int((~a).sum()) for a in alive])
    src = np.flatnonzero(mask)[:n_land]
    return src, [np.flatnonzero(~a)[:n_land] for a in alive]


CASES = ["no_hit", "sparse", "overflow", "full", "last"]


@pytest.mark.parametrize("case", CASES)
def test_place_births_follows_the_rule(case):
    mask, alive = _case(case)
    rng = np.random.default_rng(1)
    dests = [_buffer(rng, CAP, a) for a in alive]
    before = [particles.copy_species(b) for b in dests]
    src_x = t(rng.uniform(0, 64, M).astype(np.float32))
    src_v = [t(rng.normal(size=(M, 3)).astype(np.float32)) for _ in dests]
    src_w = t(rng.random(M).astype(np.float32) + 0.5)
    kill_alive = t(np.ones(M, bool))
    kill_w = src_w.clone()
    ok, n_land, dropped = ops.place_births_(
        t(mask), [particles.as_target(b) for b in dests],
        [(src_x, v, kill_w) for v in src_v], kill=(kill_alive, kill_w))
    src, slots = _rule(mask, alive)
    assert int(n_land) == len(src) and int(dropped) == mask.sum() - len(src)
    assert n_land.dtype == dropped.dtype == torch.int32
    want_ok = np.zeros(M, bool)
    want_ok[src] = True
    np.testing.assert_array_equal(n(ok), want_ok)
    for b, b0, v, slot in zip(dests, before, src_v, slots):
        want = particles.copy_species(b0)
        want.x[slot] = src_x[src]
        want.v[slot] = v[src]
        want.w[slot] = src_w[src]
        want.alive[slot] = True
        for f in ("x", "v", "w", "alive"):
            np.testing.assert_array_equal(n(getattr(b, f)),
                                          n(getattr(want, f)))
    np.testing.assert_array_equal(n(kill_alive), ~want_ok)
    np.testing.assert_array_equal(n(kill_w), n(src_w) * ~want_ok)


@pytest.mark.parametrize("case", CASES)
def test_inject_masked_donating_agrees_with_functional_and_reference(case):
    mask, alive = _case(case, 2)
    rng = np.random.default_rng(3)
    buf = _buffer(rng, CAP, alive[0])
    x = t(rng.uniform(0, 64, M).astype(np.float32))
    v = t(rng.normal(size=(M, 3)).astype(np.float32))
    w = t(rng.random(M).astype(np.float32))
    keep = particles.copy_species(buf)
    got = particles.inject_masked(buf, x, v, w, t(mask))
    for f in ("x", "v", "w", "alive"):        # the functional form copies
        assert torch.equal(getattr(buf, f), getattr(keep, f))
    mine = particles.copy_species(buf)
    don = particles.inject_masked(mine, x, v, w, t(mask), donate=True)
    assert don[0] is mine
    ref = ref_particles.inject_masked(
        ref_particles.SpeciesBuffer(*(jnp.asarray(n(getattr(keep, f)))
                                      for f in ("x", "v", "w", "alive"))),
        jnp.asarray(n(x)), jnp.asarray(n(v)), jnp.asarray(n(w)),
        jnp.asarray(mask))
    for out in (got, don):
        for f in ("x", "v", "w", "alive"):
            np.testing.assert_array_equal(n(getattr(out[0], f)),
                                          n(getattr(ref[0], f)))
        assert int(out[1]) == int(ref[1])
        np.testing.assert_array_equal(n(out[2]), n(ref[2]))


@pytest.mark.parametrize("rate,n_e,n_i", [(0.05, 3000, 3000),
                                          (0.5, 3900, 3950)])
def test_ionize_donating_agrees_with_functional_and_reference(rate, n_e,
                                                              n_i):
    cap = 4000
    rng = np.random.default_rng(4)
    bufs = [_buffer(rng, cap, a) for a in (
        rng.permutation(np.arange(cap) < 3000), np.arange(cap) < n_e,
        np.arange(cap) < n_i)]
    key = jax.random.PRNGKey(6)
    ku, kv = jax.random.split(key)
    draws = {"uniform": n(jax.random.uniform(ku, (cap,), jnp.float32)),
             "normal": n(jax.random.normal(kv, (cap, 3), jnp.float32))}
    params = collisions.IonizationParams(rate=rate, vth_electron=1.0)
    g = grid.Grid1D(64, 1.0)
    keep = [particles.copy_species(b) for b in bufs]
    got = collisions.ionize(None, *bufs, g, params, 0.2, draws=draws)
    for b, k in zip(bufs, keep):
        for f in ("x", "v", "w", "alive"):
            assert torch.equal(getattr(b, f), getattr(k, f))
    mine = [particles.copy_species(b) for b in bufs]
    don = collisions.ionize(None, *mine, g, params, 0.2, draws=draws,
                            donate=True)
    assert all(a is b for a, b in zip(don[:3], mine))
    want = ref_coll.ionize(
        key, *(ref_particles.SpeciesBuffer(
            *(jnp.asarray(n(getattr(b, f))) for f in ("x", "v", "w",
                                                       "alive")))
            for b in keep),
        ref_grid.Grid1D(64, 1.0),
        ref_coll.IonizationParams(rate=rate, vth_electron=1.0), 0.2)
    assert int(want[3]["n_ionized"]) > 0
    for out in (got, don):
        for g_, w_ in zip(out[:3], want[:3]):
            for f in ("x", "v", "w", "alive"):
                np.testing.assert_array_equal(n(getattr(g_, f)),
                                              n(getattr(w_, f)))
        assert {k: int(v) for k, v in out[3].items()} == \
            {k: int(v) for k, v in want[3].items()}
        for f in collisions.IonizationBirths._fields:
            np.testing.assert_array_equal(n(getattr(out[4], f)),
                                          n(getattr(want[4], f)))


def _species(cap, n0, e_stride=1):
    return (pic.SpeciesConfig("e", -1.0, 1.0, cap, n0, vth=1.0,
                              stride=e_stride),
            pic.SpeciesConfig("D+", 1.0, 3672.0, cap, n0, vth=0.02),
            pic.SpeciesConfig("D", 0.0, 3672.0, cap, n0, vth=0.02))


def _config(name):
    """A small §3.3-like configuration whose ionization ionizes every
    step; ``name`` picks the push path and the sources."""
    base = dict(nc=64, dx=1.0, dt=0.1, species=_species(4096, 2048),
                field_solve=False, strategy="fused", ionization=(2, 0, 1),
                ionization_rate=0.02)
    if name == "fused_field":          # the births' charge carried in rho
        base.update(field_solve=True, eps0=100.0)
    elif name == "fused_subcycled":
        base.update(species=_species(4096, 2048, e_stride=2))
    elif name == "explicit_subcycled":     # per-species loop
        base.update(species=_species(4096, 2048, e_stride=2),
                    strategy="explicit")
    elif name == "unified_unequal":        # per-species loop, periodic
        sp = _species(4096, 2048)
        base.update(species=(dataclasses.replace(sp[0], capacity=5000),)
                    + sp[1:], strategy="unified")
    elif name == "wall":                   # SEE, then ionization
        base.update(boundary="absorb", wall_emission=((0, 0),),
                    emission_yield=0.5)
    return pic.PICConfig(**base)


@pytest.mark.parametrize("name", ["fused", "fused_field", "fused_subcycled",
                                  "explicit_subcycled", "unified_unequal",
                                  "wall"])
def test_step_leaves_its_input_state_unchanged(name):
    """Three steps; with a sub-cycled electron species, step 1 lands births
    in the electrons while they sit out their push (the per-species loop
    hands back the input's own buffer there)."""
    cfg = _config(name)
    state = pic.init_state(cfg, 5, device="cpu")
    born, emitted = [], 0
    for k in range(3):
        keep = [particles.copy_species(b) for b in state.species]
        rho = None if state.rho is None else state.rho.clone()
        nxt, diag = pic.step_fn(state, cfg)
        for b, b0 in zip(state.species, keep):
            for f in ("x", "v", "w", "alive"):
                assert torch.equal(getattr(b, f), getattr(b0, f)), (k, f)
        assert (rho is None) == (state.rho is None)
        assert rho is None or torch.equal(state.rho, rho)
        ion = int(diag["n_ionized"])
        born.append(ion)
        emitted += int(diag.get("e/emitted", 0))
        gone = {sc.name: sum(int(diag[f"{sc.name}/absorbed_{side}"])
                             for side in ("left", "right"))
                for sc in cfg.species}
        d = [int(b1.count()) - int(b0.count())
             for b0, b1 in zip(state.species, nxt.species)]
        assert d == [ion + int(diag.get("e/emitted", 0)) - gone["e"],
                     ion - gone["D+"], -ion - gone["D"]], (k, d, diag)
        state = nxt
    assert min(born) > 0, born
    assert name != "wall" or emitted > 0
