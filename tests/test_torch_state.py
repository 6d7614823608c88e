"""nbx_torch.state, scene and convert against nbx.state and nbx.scene:
scene builders, bulk loads, the slot allocator and FIFO eviction, batched
births at and past capacity. Slots, insertion order and eviction must match
exactly; the floats only move, so they match exactly too."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbx import scene as jscene
from nbx import state as jstate
from nbx.config import SimConfig as JaxConfig
from nbx_torch import convert, scene, state
from nbx_torch.config import ROCK, SimConfig
from torch_parity import jax_state_arrays, port_state

torch.set_num_threads(1)

BUILDERS = {
    "reference_galaxy": dict(n_disk=50, seed=3),
    "head_on_collision": dict(),
    "kepler_two_body": dict(e=0.3),
    "solar_system": dict(),
    "plummer": dict(n=500, seed=1),
    "cold_collapse_disk": dict(n=777, seed=2),
    "galaxy_merger": dict(n=600, seed=4),
    "galaxy_merger_3d": dict(n=600, seed=5),
    "uniform_cube": dict(n=100, seed=6),
}


def _assert_same(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_scene_builders_identical(name):
    got = getattr(scene, name)(**BUILDERS[name])
    want = getattr(jscene, name)(**BUILDERS[name])
    if isinstance(want, tuple):  # galaxy_merger_3d returns (scene, box)
        assert got[1] == want[1]
        got, want = got[0], want[0]
    _assert_same(got, want)


def test_scenario_table_matches():
    assert sorted(scene.SCENARIOS) == sorted(jscene.SCENARIOS)
    for k, fn in scene.SCENARIOS.items():
        assert fn.__name__ == jscene.SCENARIOS[k].__name__


@pytest.mark.parametrize("collisions", [True, False])
def test_make_state_matches(collisions):
    sc = jscene.reference_galaxy(n_disk=60, seed=1)
    jcfg, cfg = JaxConfig(capacity=100, collisions=collisions), SimConfig(capacity=100, collisions=collisions)
    got = convert.state_to_arrays(scene.make_state(cfg, sc))
    _assert_same(got, jax_state_arrays(jscene.make_state(jcfg, sc)))


def test_make_state_rejects_oversize_scene():
    with pytest.raises(ValueError, match="capacity"):
        scene.make_state(SimConfig(capacity=10), scene.uniform_cube(11))


def _bodies(n, seed):
    rng = np.random.default_rng(seed)
    return (
        rng.uniform(1.0, 9.0, n).astype(np.float32),
        rng.normal(size=(n, 3)).astype(np.float32),
        rng.normal(size=(n, 3)).astype(np.float32),
        rng.integers(0, 3, n).astype(np.int32),
        rng.uniform(0.0, 5.0, n).astype(np.float32),
    )


def _partial_state(capacity, n, dead, seed=0):
    """A JAX state with n bodies, the slots in `dead` killed, and a random
    contact matrix, plus the port's copy of it."""
    jcfg, cfg = JaxConfig(capacity=capacity), SimConfig(capacity=capacity)
    m, p, v, mat, t = _bodies(n, seed)
    jst = jscene.make_state(jcfg, dict(mass=m, pos=p, vel=v, mat=mat, temp=t))
    alive = np.asarray(jst.alive).copy()
    alive[list(dead)] = False
    contact = np.random.default_rng(seed + 1).uniform(size=(capacity, capacity)).astype(np.float32)
    jst = jst.replace(alive=jnp.asarray(alive), mass=jnp.where(jnp.asarray(alive), jst.mass, 0.0),
                      contact=jnp.asarray(contact))
    return jcfg, cfg, jst, port_state(jst, cfg)


def test_add_body_at_and_past_capacity():
    """Lowest free slot first, then FIFO eviction of the smallest seq."""
    jcfg, cfg, jst, st = _partial_state(6, 5, dead=(1, 3))
    m, p, v, mat, t = _bodies(7, 9)
    for k in range(7):
        jst, jev = jstate.add_body(jst, m[k], jnp.asarray(p[k]), jnp.asarray(v[k]), int(mat[k]), t[k])
        st, ev = state.add_body(st, float(m[k]), torch.from_numpy(p[k]), torch.from_numpy(v[k]),
                                int(mat[k]), float(t[k]))
        assert bool(ev) == bool(jev)
        _assert_same(convert.state_to_arrays(st), jax_state_arrays(jst))


def test_allocate_slot_matches():
    for dead in ((), (0,), (2, 4)):
        _, _, jst, st = _partial_state(5, 5, dead)
        _, js, je = jstate.allocate_slot(jst)
        _, s, e = state.allocate_slot(st)
        assert int(s) == int(js) and bool(e) == bool(je)


@pytest.mark.parametrize(
    "n_births,mask_seed",
    [(3, None), (6, 1), (12, 2), (20, 3)],
    ids=["below_free", "evicts", "evicts_many", "past_capacity"],
)
def test_add_bodies_batch_matches(n_births, mask_seed):
    """Batched births into a state with holes: free slots first, then FIFO
    eviction, births past the capacity dropped; contact rows cleared."""
    jcfg, cfg, jst, st = _partial_state(12, 10, dead=(2, 5, 7))
    m, p, v, mat, t = _bodies(n_births, 20 + n_births)
    mask = np.ones(n_births, bool)
    if mask_seed is not None:
        mask = np.random.default_rng(mask_seed).uniform(size=n_births) < 0.8
    jst, jn = jstate.add_bodies_batch(jst, *(jnp.asarray(a) for a in (m, p, v, mat, t, mask)))
    st, n = state.add_bodies_batch(st, *(torch.from_numpy(a) for a in (m, p, v, mat, t, mask)))
    assert int(n) == int(jn)
    _assert_same(convert.state_to_arrays(st), jax_state_arrays(jst))


def test_add_bodies_matches_sequential_jax():
    """More births than the capacity: newborns evict newborns in order."""
    jcfg, cfg, jst, st = _partial_state(8, 6, dead=(0,))
    m, p, v, mat, t = _bodies(21, 30)
    jst = jstate.add_bodies(jst, *(jnp.asarray(a) for a in (m, p, v, mat, t)))
    st = state.add_bodies(st, *(torch.from_numpy(a) for a in (m, p, v, mat, t)))
    _assert_same(convert.state_to_arrays(st), jax_state_arrays(jst))


def test_compact_arrays_matches():
    jcfg, cfg, jst, st = _partial_state(6, 6, dead=(1,))
    jst, _ = jstate.add_body(jst, 4.0, jnp.zeros(3), jnp.zeros(3), ROCK)
    jst, _ = jstate.add_body(jst, 5.0, jnp.zeros(3), jnp.zeros(3), ROCK)  # evicts
    st, _ = state.add_body(st, 4.0, torch.zeros(3), torch.zeros(3), ROCK)
    st, _ = state.add_body(st, 5.0, torch.zeros(3), torch.zeros(3), ROCK)
    _assert_same(state.compact_arrays(st), jstate.compact_arrays(jst))


def test_convert_round_trip_and_config():
    jcfg, cfg, jst, st = _partial_state(6, 4, dead=(1,))
    arrays = jax_state_arrays(jst)
    _assert_same(convert.state_to_arrays(convert.state_from_arrays(arrays, cfg)), arrays)
    fields = {f: getattr(jcfg, f) for f in ("G", "dt", "capacity", "collisions", "sub_steps")}
    fields["G"] = np.float32(1.25)
    got = convert.config_from_fields(fields)
    assert (got.G, got.dt, got.capacity, got.collisions, got.sub_steps) == (1.25, 0.016, 6, True, 2)
    assert type(got.G) is float and type(got.capacity) is int and type(got.collisions) is bool
