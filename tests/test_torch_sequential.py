"""The port's strict-sequential collision sweep (`collision_impl="sequential"`,
`collisions.resolve_collisions_sequential`, `ops.sequential.sweep_reference`
on the CPU) against the JAX package's `resolve_collisions_sequential` and
against the NumPy oracle of the reference sweep (tests/oracle.py).

- the four scenes of tests/test_sequential.py at that file's bars;
- one substep against the JAX package's on the chain pile and on a fracture
  scene, the fracture uniforms rebuilt from the JAX state's key: floats to
  1e-5 of each field's largest magnitude, counts, masks and slots exactly;
- the row-scan counters (overlap tests) against a count made here;
- an unknown collision_impl raises ValueError."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle as orc
from nbx import collisions as jcoll
from nbx import scene as jscene
from nbx import sim as jsim
from nbx.config import SimConfig as JaxConfig
from nbx_torch import collisions, scene, sim
from nbx_torch.config import SimConfig, inverse_mass
from nbx_torch.ops import sequential
from nbx_torch.state import compact_arrays
from torch_parity import assert_events_match, assert_state_matches, jax_draws, port_state

torch.set_num_threads(1)

_jax_sequential = jax.jit(jcoll.resolve_collisions_sequential)


def _run_port(sc, cfg, n_frames, collision_impl, seed=0):
    st = scene.make_state(cfg, sc, "cpu", seed=seed)
    for _ in range(n_frames):
        st, ev = sim.step(st, cfg, collision_impl=collision_impl)
    return st, ev


def _run_oracle(sc, cfg, n_frames):
    sys_ = orc.from_scene(
        sc, G=cfg.G, softening=cfg.softening, max_bodies=cfg.capacity,
        fracture_threshold=cfg.fracture_threshold, min_fragment_mass=cfg.min_fragment_mass,
        merge_time=cfg.merge_time, heat_decay=cfg.heat_decay,
    )
    h = cfg.dt / cfg.sub_steps
    for _ in range(n_frames * cfg.sub_steps):
        sys_.integrate(h)
    return sys_


def chain_scene(n=5, spacing=2.5, mass=20.0):
    """The contact pile of tests/test_sequential.py: n bodies of radius
    ~1.68 on a line at `spacing` < 2 r, the outer ones converging."""
    pos = np.zeros((n, 3), np.float32)
    pos[:, 0] = (np.arange(n) - (n - 1) / 2) * spacing
    pos[:, 1] = np.linspace(0.0, 0.3, n)
    vel = np.zeros((n, 3), np.float32)
    vel[:, 0] = -np.sign(pos[:, 0]) * 1.5
    return dict(pos=pos, vel=vel, mass=np.full(n, mass, np.float32), mat=np.zeros(n, np.int32),
                temp=np.zeros(n, np.float32))


def test_sequential_matches_jacobi_on_isolated_pair():
    sc = scene.head_on_collision()
    sc["pos"][:, 0] = [-4, 4]
    sc["pos"][:, 2] = [0, 2]
    cfg = SimConfig(capacity=16, merge_time=1e9, fracture_threshold=1e9)
    got_j = compact_arrays(_run_port(sc, cfg, 100, "jacobi")[0])
    got_s = compact_arrays(_run_port(sc, cfg, 100, "sequential")[0])
    np.testing.assert_allclose(got_s["pos"], got_j["pos"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_s["vel"], got_j["vel"], rtol=1e-5, atol=1e-5)


def test_sequential_cluster_matches_oracle_where_jacobi_diverges():
    sc = chain_scene()
    cfg = SimConfig(capacity=8, merge_time=1e9, fracture_threshold=1e9, dt=0.016, sub_steps=2)
    n = 25
    st_s, _ = _run_port(sc, cfg, n, "sequential")
    st_j, _ = _run_port(sc, cfg, n, "jacobi")
    ref = _run_oracle(sc, cfg, n)
    assert ref.events["bounces"] > 0
    got_s, got_j = compact_arrays(st_s), compact_arrays(st_j)
    np.testing.assert_allclose(got_s["pos"], ref.pos_array(), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(got_s["vel"], ref.vel_array(), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(got_s["temp"], ref.temp_array(), rtol=1e-3, atol=1e-3)
    err_j = np.abs(got_j["pos"] - ref.pos_array()).max()
    err_s = np.abs(got_s["pos"] - ref.pos_array()).max()
    assert err_j > 10 * max(err_s, 1e-7), (err_j, err_s)


def test_sequential_merge_matches_oracle():
    sc = scene.head_on_collision()
    sc["pos"][:, 0] = [-4, 4]
    sc["pos"][:, 2] = [0, 0]
    cfg = SimConfig(capacity=16, fracture_threshold=1e9)
    n = 160
    st, _ = _run_port(sc, cfg, n, "sequential")
    ref = _run_oracle(sc, cfg, n)
    assert ref.events["merges"] == 1
    got = compact_arrays(st)
    assert int(st.n_alive) == len(ref.bodies) == 1
    np.testing.assert_allclose(got["mass"], ref.mass_array(), rtol=1e-5)
    np.testing.assert_allclose(got["pos"], ref.pos_array(), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(got["vel"], ref.vel_array(), rtol=1e-3, atol=1e-3)


def test_sequential_pile_events_match_oracle_counts():
    sc = chain_scene(n=6, spacing=2.2, mass=10.0)
    cfg = SimConfig(capacity=16, merge_time=0.1, fracture_threshold=1e9, dt=0.016, sub_steps=2)
    ref = _run_oracle(sc, cfg, 30)
    st, _ = _run_port(sc, cfg, 30, "sequential")
    assert ref.events["merges"] > 0
    got = compact_arrays(st)
    assert int(st.n_alive) == len(ref.bodies)
    np.testing.assert_allclose(np.sort(got["mass"]), np.sort(ref.mass_array()), rtol=1e-4)


def fracture_scene():
    """Two violent head-on pairs (fractures), a slow pair whose timer runs
    (a merge, given the timer) and a gentle pair (a bounce), all overlapping."""
    pos = [[-1.5, 0, 0], [1.5, 0, 0.5], [20, 0, 0], [22.5, 0.2, 0], [-20, 0, 0], [-18.2, 0, 0],
           [0, 20, 0], [0, 22, 0.1]]
    vel = [[30, 0, 0], [-30, 0, 0], [10, 0, 0], [-10, 0, 0], [0.1, 0, 0], [-0.1, 0, 0], [0, 1, 0], [0, -1, 0]]
    return dict(pos=np.array(pos, np.float32), vel=np.array(vel, np.float32),
                mass=np.array([100, 100, 20, 20, 5, 5, 5, 5], np.float32),
                mat=np.array([0, 2, 0, 1, 0, 0, 2, 0], np.int32),
                temp=np.array([0, 50, 0, 0, 0, 0, 0, 0], np.float32))


@pytest.mark.parametrize("case", ["chain", "fracture"])
def test_one_substep_matches_jax(case):
    if case == "chain":
        sc, kw = chain_scene(n=6, spacing=2.2, mass=10.0), dict(capacity=16, merge_time=0.1, fracture_threshold=1e9)
        sc["vel"][:, 0] = -0.5 * sc["pos"][:, 0]  # every neighbour pair approaches
    else:
        sc, kw = fracture_scene(), dict(capacity=64, merge_time=0.1, fracture_threshold=5.0)
    jcfg, cfg = JaxConfig(**kw), SimConfig(**kw)
    jst = jscene.make_state(jcfg, sc, 3)
    st = port_state(jst, cfg)
    h = sim.substep_size(cfg)
    jh = jnp.float32(jcfg.dt) / jcfg.sub_steps
    assert float(jh) == h
    # the timers of pairs (2, 3) and (4, 5) already past merge_time: those
    # merge if they approach gently, the other approaching pairs bounce
    timers = np.zeros((cfg.capacity, cfg.capacity), np.float32)
    timers[2, 3] = timers[3, 2] = timers[4, 5] = timers[5, 4] = 0.2
    jst = jst.replace(contact=jnp.asarray(timers))
    st = st.replace(contact=torch.from_numpy(timers))
    draws = jax_draws(jst.key, jcfg)
    jst2, jev = _jax_sequential(jst, jcfg, jh)
    st2, ev = collisions.resolve_collisions_sequential(st, cfg, h, draws)
    assert_state_matches(st2, jst2)
    assert_events_match(ev, jev)
    if case == "chain":
        assert int(ev.n_bounces) > 0 and int(ev.n_merges) > 0
    else:
        assert int(ev.n_fractures) > 0 and int(ev.n_merges) > 0 and int(ev.n_bounces) > 0
        assert int(ev.spawn_mask.sum()) > 0


def test_substeps_match_jax_full_physics():
    """Ten frames of the whole substep with the sequential sweep, the
    fracture draws rebuilt from the JAX key."""
    sc = fracture_scene()
    kw = dict(capacity=64, merge_time=0.02, fracture_threshold=5.0)
    jcfg, cfg = JaxConfig(**kw), SimConfig(**kw)
    jst = jscene.make_state(jcfg, sc, 5)
    st = port_state(jst, cfg)
    h = sim.substep_size(cfg)
    jh = jnp.float32(jcfg.dt) / jcfg.sub_steps
    jsub = jax.jit(jsim.substep, static_argnames=("force_impl", "collision_impl"))
    for _ in range(10 * cfg.sub_steps):
        draws = jax_draws(jst.key, jcfg)
        jst, jev = jsub(jst, jcfg, jh, collision_impl="sequential")
        st, ev = sim.substep(st, cfg, h, draws=draws, collision_impl="sequential")
        assert_state_matches(st, jst)
        assert_events_match(ev, jev)


def _inputs(sc, cfg):
    st = scene.make_state(cfg, sc, "cpu")
    return (st.pos, st.vel, st.temp, st.mass, st.radius(cfg), inverse_mass(st.mass), st.mat, st.alive,
            st.contact)


def test_sweep_counts_its_overlap_tests():
    """n_tests: each live row's live candidates up to and including each
    hit, or to the row's end. With no overlap that is every live pair."""
    cfg = SimConfig(capacity=16)
    sc = chain_scene(n=5, spacing=10.0)
    s = sequential.sweep(*_inputs(sc, cfg), sim.substep_size(cfg), cfg)
    assert int(s.count("n_tests")) == 5 * 4 // 2
    assert int(s.count("n_bounces")) == 0 and not bool(s.contact.any())
    # the pile: a row resumes after each hit, so each pair is tested once
    s = sequential.sweep(*_inputs(chain_scene(), cfg), sim.substep_size(cfg), cfg)
    assert int(s.count("n_tests")) == 5 * 4 // 2
    assert int((s.contact > 0).sum()) == 2 * 4
    # (1, 2) and (2, 3) approach; (1, 2)'s impulse, seen within the sweep,
    # makes (3, 4) approach by the time its turn comes: three bounces
    assert int(s.count("n_bounces")) == 3
    # merges remove bodies: their later pairs are not tested
    cfg = cfg.replace(merge_time=0.0)
    s = sequential.sweep(*_inputs(chain_scene(), cfg), sim.substep_size(cfg), cfg)
    assert int(s.count("m_cnt")) == 1 and s.removed.tolist()[:5] == [False, True, True, False, False]
    # row 0: 4 candidates; row 1 stops at its merge with 2; rows 2 and 1 are
    # removed, so row 3 tests only 4
    assert int(s.count("n_tests")) == 4 + 1 + 1


def test_unknown_collision_impl_raises():
    cfg = SimConfig(capacity=8)
    st = scene.make_state(cfg, chain_scene(), "cpu")
    for call in (lambda: sim.step(st, cfg, collision_impl="gauss-seidel"),
                 lambda: sim.run(st, cfg, 1, collision_impl="Sequential"),
                 lambda: sim.substep(st, cfg, 0.008, collision_impl="")):
        with pytest.raises(ValueError, match="collision_impl"):
            call()
    with pytest.raises(ValueError, match="CPU or CUDA"):
        sequential.sweep(*(t.to("meta") for t in _inputs(chain_scene(), cfg)), 0.008, cfg)
