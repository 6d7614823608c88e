"""nbx_torch.collisions_binned against nbx.collisions_binned on the CPU: the
same numpy scenes (and the same radii, from the JAX package's cbrt) go
through both resolvers and both granular loops.

Deltas to 1e-5 of the JAX package's largest |delta| (dtemp 1e-4): the port
sums each target's pairs in the same order but with torch's reductions;
n_bounces, n_overflow, cell_too_small and the scan's flags exactly. Each
JAX call is jitted once for the module (its fixture)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbx.collisions_binned import granular_kdk_scan as jax_scan
from nbx.collisions_binned import resolve_bounces_binned as jax_resolve
from nbx.config import body_radius as jax_body_radius
from nbx.config import default_materials as jax_materials
from nbx_torch import collisions
from nbx_torch.collisions_binned import granular_kdk_scan, resolve_bounces_binned
from nbx_torch.config import ROCK, SimConfig
from nbx_torch.state import add_bodies, empty_state

torch.set_num_threads(1)

BOX = 100.0
DELTA_TOL = 1e-5
HEAT_TOL = 1e-4
SCAN_TOL = 1e-5
COUNTERS = ("n_bounces", "n_overflow", "cell_too_small")


def _granular_scene(n=96, seed=0):
    """tests/test_collisions_binned.py's scene: random balls in [20, 50)^3,
    dense enough that several pairs overlap."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(20, 50, (n, 3)).astype(np.float32)
    vel = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    mass = rng.uniform(5.0, 20.0, n).astype(np.float32)
    return pos, vel, mass


def _escape_scene():
    """Seed 0's scene with 12 bodies pushed out of the box in two huddles,
    below x = 0 and past y = box, that the binner clips into face cells."""
    pos, vel, mass = _granular_scene()
    rng = np.random.default_rng(5)
    pos[:6] = np.array([-4.0, 30.0, 30.0], np.float32) + rng.uniform(-1.0, 1.0, (6, 3)).astype(np.float32)
    pos[6:12] = np.array([40.0, BOX + 3.0, 60.0], np.float32) + rng.uniform(-1.0, 1.0, (6, 3)).astype(np.float32)
    return pos, vel, mass


def _radius(mass):
    """Rock radii as the JAX package computes them (cbrt), for both sides."""
    return np.asarray(jax_body_radius(jnp.asarray(mass), jnp.zeros(mass.shape, jnp.int32), jax_materials()))


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _np(xs):
    return [x.numpy() for x in xs]


# name -> (scene, n_cells, max_per_cell)
CASES = {
    "seed0": (_granular_scene(seed=0), 8, 64),
    "seed1": (_granular_scene(seed=1), 8, 64),
    "seed2": (_granular_scene(seed=2), 8, 64),
    "seed0_k4": (_granular_scene(seed=0), 8, 4),
    "seed2_k4": (_granular_scene(seed=2), 8, 4),
    "escape": (_escape_scene(), 8, 16),
}


@pytest.fixture(scope="module")
def jax_results():
    """Every case through nbx's resolver, once."""
    out = {}
    for name, ((pos, vel, mass), g, k) in CASES.items():
        out[name] = [np.asarray(x) for x in jax_resolve(pos, vel, mass, _radius(mass), BOX, n_cells=g,
                                                          max_per_cell=k)]
    return out


def _assert_deltas(got, want):
    for i, (what, tol) in enumerate((("dpos", DELTA_TOL), ("dvel", DELTA_TOL), ("dtemp", HEAT_TOL))):
        scale = max(float(np.abs(want[i]).max()), 1e-30)
        err = float(np.abs(got[i] - want[i]).max()) / scale
        assert err <= tol, f"{what}: {err:.3e} of max|nbx| > {tol:g}"
    for i, what in enumerate(COUNTERS, start=3):
        assert got[i] == want[i], f"{what}: {got[i]} != {want[i]}"


@pytest.mark.parametrize("name", list(CASES))
def test_resolver_matches_nbx(jax_results, name):
    (pos, vel, mass), g, k = CASES[name]
    got = _np(resolve_bounces_binned(*_t(pos, vel, mass, _radius(mass)), BOX, g, max_per_cell=k))
    want = jax_results[name]
    _assert_deltas(got, want)
    assert int(want[0].shape[0]) == pos.shape[0]
    if name.endswith("_k4"):
        assert int(want[4]) > 0, "the scene overflows 4 bodies a cell"
    else:
        assert int(want[3]) > 0, "the scene has contacts"


def test_escapees_are_clipped_into_face_cells(jax_results):
    """The escapees bounce off each other inside their face cells; the
    flag and counters are the JAX package's."""
    (pos, _, _), _, _ = CASES["escape"]
    assert ((pos < 0) | (pos >= BOX)).any(1).sum() == 12
    dv = jax_results["escape"][1]
    assert np.abs(dv[:12]).max() > 0, "the clipped huddles collide"


@pytest.mark.parametrize("chunk", [5, 7])
def test_chunks_agree(chunk):
    """Blocks of chunk * max_per_cell targets (here 40 and 56 of the 96
    bodies: several blocks, a ragged last one) give the one-block result."""
    pos, vel, mass = _granular_scene(seed=1)
    args = (*_t(pos, vel, mass, _radius(mass)), BOX, 8)
    whole = _np(resolve_bounces_binned(*args, max_per_cell=8, chunk=512))
    parts = _np(resolve_bounces_binned(*args, max_per_cell=8, chunk=chunk))
    assert int(whole[3]) > 0
    for a, b in zip(parts[:3], whole[:3]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6 * max(float(np.abs(b).max()), 1e-30))
    assert [int(x) for x in parts[3:]] == [int(x) for x in whole[3:]]


def test_binned_matches_dense_bounces():
    """On a bounce-only scene the binned resolver reproduces the port's dense
    resolver (tests/test_collisions_binned.py's check, in the port)."""
    pos, vel, mass = _granular_scene()
    n = mass.shape[0]
    cfg = SimConfig(capacity=n, G=0.0, merge_time=1e9, fracture_threshold=1e9)
    st = add_bodies(empty_state(cfg, "cpu", 0), *_t(mass, pos, vel), torch.full((n,), ROCK, dtype=torch.int32))
    dense, _ = collisions.resolve_collisions(st, cfg, 0.008)
    dp, dv, dt, n_b, ovf, too_small = resolve_bounces_binned(
        st.pos, st.vel, st.mass, st.radius(cfg), BOX, 8, cfg.restitution, cfg.friction, max_per_cell=64)
    assert not bool(too_small) and int(ovf) == 0 and int(n_b) > 0
    np.testing.assert_allclose((st.pos + dp).numpy(), dense.pos.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose((st.vel + dv).numpy(), dense.vel.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose((st.temp + dt).numpy(), dense.temp.numpy(), rtol=1e-4, atol=1e-6)


def test_conserves_momentum():
    pos, vel, mass = _granular_scene(seed=3)
    _, dv, _, n_b, _, _ = resolve_bounces_binned(*_t(pos, vel, mass, _radius(mass)), BOX, 8, max_per_cell=64)
    assert int(n_b) > 0
    dp = (torch.from_numpy(mass)[:, None].double() * dv.double()).sum(0).numpy()
    scale = float((mass[:, None] * np.abs(vel)).sum())
    np.testing.assert_allclose(dp, 0.0, atol=1e-5 * scale)


def test_cell_too_small_flagged():
    pos, vel, mass = _granular_scene(seed=1)
    big = np.full_like(mass, 30.0)  # 2 r = 60 > cell = 12.5
    assert bool(resolve_bounces_binned(*_t(pos, vel, mass, big), BOX, 8, max_per_cell=64)[5])
    assert not bool(resolve_bounces_binned(*_t(pos, vel, mass, _radius(mass)), BOX, 8, max_per_cell=64)[5])


SCAN_ARGS = dict(G=0.5, eps=0.5, h=0.004, n_steps=20, n_cells=8, max_per_cell=16)


def test_scan_matches_nbx():
    """20 steps of the granular loop with "blocked" gravity on 64 bodies."""
    pos, vel, mass = _granular_scene(n=64, seed=2)
    rad = _radius(mass)
    a = SCAN_ARGS
    jp, jv, jt, jnb, jovf, jflags = jax_scan(pos, vel, mass, rad, a["G"], a["eps"], a["h"], BOX, a["n_steps"],
                                             n_cells=a["n_cells"], max_per_cell=a["max_per_cell"],
                                             force_impl="blocked")
    p, v, t, nb, ovf, flags = granular_kdk_scan(*_t(pos, vel, mass, rad), a["G"], a["eps"], a["h"], BOX,
                                                a["n_steps"], n_cells=a["n_cells"], max_per_cell=a["max_per_cell"],
                                                force_impl="blocked")
    for what, got, want in (("pos", p, jp), ("vel", v, jv), ("temp", t, jt)):
        want = np.asarray(want)
        err = float(np.abs(got.numpy() - want).max()) / max(float(np.abs(want).max()), 1e-30)
        assert err <= SCAN_TOL, f"{what}: {err:.3e}"
    assert int(nb) == int(jnb) > 0
    assert int(ovf) == int(jovf) == 0
    assert bool(flags["cell_too_small"]) == bool(jflags["cell_too_small"])
    assert int(flags["max_out_of_box"]) == int(jflags["max_out_of_box"])
    assert float(t.max()) > 0, "dissipated energy became heat"


def test_scan_counts_escapees():
    """max_out_of_box counts the bodies outside the box; the loop does not
    wrap them."""
    pos, vel, mass = _escape_scene()
    out = granular_kdk_scan(*_t(pos, vel, mass, _radius(mass)), 0.0, 0.5, 0.004, BOX, 2, n_cells=8,
                            max_per_cell=16, force_impl="dense")
    assert int(out[5]["max_out_of_box"]) == 12
    assert np.isfinite(out[0].numpy()).all()
