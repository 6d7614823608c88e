"""nbx_torch.collisions.resolve_collisions against nbx.collisions on the same
states: bounce clusters, merges past the event cap, fractures and births at
capacity. The fracture uniforms are rebuilt from the JAX state's key with
the JAX package's split chain and injected through `draws=`.

Event counts, masks, slots and insertion order must match exactly; floats to
1e-5 of each field's largest magnitude (float32 sums in another order)."""

import jax
import numpy as np
import pytest
import torch

from nbx import collisions as jcoll
from nbx import scene as jscene
from nbx.config import SimConfig as JaxConfig
from nbx_torch import collisions
from nbx_torch.config import ICE, METAL, ROCK, SimConfig
from nbx_torch.sim import substep_size
from torch_parity import (
    assert_events_match, assert_state_matches, jax_draws, port_state,
)

torch.set_num_threads(1)


def _radius(m, rho=1.0):
    return (3.0 * m / (4.0 * np.pi * rho)) ** (1.0 / 3.0)


def _pair(center, m1, m2, speed, gap_frac=0.9, axis=0):
    """Two rock bodies overlapping along `axis`, approaching at `speed` each."""
    e = np.eye(3)[axis]
    d = (_radius(m1) + _radius(m2)) * gap_frac
    c = np.asarray(center, float)
    return ([c - 0.5 * d * e, c + 0.5 * d * e], [speed * e, -speed * e], [m1, m2])


def _scene(*groups, mat=None):
    pos, vel, mass = [], [], []
    for p, v, m in groups:
        pos += list(p)
        vel += list(v)
        mass += list(m)
    n = len(mass)
    return dict(
        pos=np.asarray(pos, np.float32), vel=np.asarray(vel, np.float32),
        mass=np.asarray(mass, np.float32),
        mat=np.full(n, ROCK, np.int32) if mat is None else np.asarray(mat, np.int32),
        temp=np.zeros(n, np.float32),
    )


def _bounce_cluster():
    rng = np.random.default_rng(0)
    pos = rng.uniform(-2.0, 2.0, (10, 3))
    vel = -pos / np.linalg.norm(pos, axis=1, keepdims=True)  # toward the center
    mass = rng.uniform(3.0, 8.0, 10)
    mat = rng.choice([ROCK, METAL, ICE], 10)
    sc = _scene((pos, vel, mass), mat=mat)
    return sc, dict(capacity=16, merge_time=1e9, fracture_threshold=1e9)


def _merges_past_cap():
    """Six touching slow pairs and a three-body chain; at most 4 merges per
    substep, so the rest is counted as dropped."""
    groups = [_pair((k * 30.0, 0, 0), 10.0, 10.0 + k, 0.05, gap_frac=0.6) for k in range(6)]
    chain = ([[0, 40, 0], [1.5, 40, 0], [3.0, 40, 0]], [[0.1, 0, 0], [0, 0, 0], [-0.1, 0, 0]],
             [10.0, 10.0, 10.0])
    return _scene(*groups, chain), dict(capacity=24, merge_time=0.005,
                                        fracture_threshold=1e9, max_merges=4)


def _fractures():
    """Two violent pairs that fracture, one slow pair that merges, one that
    bounces."""
    sc = _scene(
        _pair((0, 0, 0), 50.0, 30.0, 20.0, gap_frac=0.95),
        _pair((100, 0, 0), 40.0, 40.0, 15.0, gap_frac=0.95, axis=2),
        _pair((0, 100, 0), 10.0, 10.0, 0.05, gap_frac=0.6),
        _pair((0, 0, 100), 0.1, 0.1, 2.0, gap_frac=0.9),  # below min_fragment_mass
    )
    return sc, dict(capacity=64, fracture_threshold=0.5, min_fragment_mass=0.2,
                    merge_time=0.005)


def _births_at_capacity():
    """A full state: one fracturing pair and six bystanders. The fragments
    evict the oldest bodies FIFO, and births past the capacity are dropped."""
    far = ([[50.0 * k, 80, 0] for k in range(6)], np.zeros((6, 3)), [1.0] * 6)
    sc = _scene(far, _pair((0, 0, 0), 50.0, 50.0, 20.0, gap_frac=0.95))
    return sc, dict(capacity=8, fracture_threshold=0.5)


SCENES = {
    "bounce_cluster": _bounce_cluster,
    "merges_past_cap": _merges_past_cap,
    "fractures": _fractures,
    "births_at_capacity": _births_at_capacity,
}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_resolve_collisions_matches_jax(name):
    sc, kw = SCENES[name]()
    jcfg, cfg = JaxConfig(G=0.0, **kw), SimConfig(G=0.0, **kw)
    jst = jscene.make_state(jcfg, sc, 3)
    st = port_state(jst, cfg)
    h = substep_size(cfg)
    totals = dict(n_merges=0, n_fractures=0, n_bounces=0, n_evicted=0, n_dropped=0)
    for _ in range(3):  # consecutive sweeps: contact timers and births carry over
        draws = jax_draws(jst.key, jcfg)
        jst, jev = jcoll.resolve_collisions(jst, jcfg, h)
        st, ev = collisions.resolve_collisions(st, cfg, h, draws=draws)
        assert_state_matches(st, jst)
        assert_events_match(ev, jev)
        for k in totals:
            totals[k] += int(ev.__dict__[k])
    expect = {
        "bounce_cluster": ("n_bounces",),
        "merges_past_cap": ("n_merges", "n_dropped"),
        "fractures": ("n_fractures", "n_merges", "n_bounces"),
        "births_at_capacity": ("n_fractures", "n_evicted"),
    }[name]
    for k in expect:  # each scene exercises what it is named for
        assert totals[k] > 0, (k, totals)


def test_draws_default_to_the_state_generator():
    """Without draws=, the uniforms come from the state's generator: the same
    seed gives the same fragments, and the draw advances the generator."""
    sc, kw = _fractures()
    jcfg, cfg = JaxConfig(G=0.0, **kw), SimConfig(G=0.0, **kw)
    jst = jscene.make_state(jcfg, sc, 0)
    h = substep_size(cfg)
    a, ea = collisions.resolve_collisions(port_state(jst, cfg, seed=5), cfg, h)
    b, eb = collisions.resolve_collisions(port_state(jst, cfg, seed=5), cfg, h)
    assert int(ea.n_fractures) > 0
    torch.testing.assert_close(a.pos, b.pos, rtol=0, atol=0)
    torch.testing.assert_close(ea.spawn_pos, eb.spawn_pos, rtol=0, atol=0)
    assert not torch.equal(a.generator.get_state(), torch.Generator().manual_seed(5).get_state())
    g = torch.Generator().manual_seed(5)
    d = collisions.draw_fracture_uniforms(cfg, g, "cpu")
    c, ec = collisions.resolve_collisions(port_state(jst, cfg, seed=99), cfg, h, draws=d)
    torch.testing.assert_close(ec.spawn_pos, ea.spawn_pos, rtol=0, atol=0)


def test_greedy_match_and_top_pairs_match_jax():
    """Candidate matrices with shared bodies: the matching, and the pairs
    taken in sweep order with the cap, agree exactly."""
    rng = np.random.default_rng(1)
    c = 40
    cand = np.triu(rng.uniform(size=(c, c)) < 0.08, 1)
    for rounds in (1, 4):
        want = np.asarray(jcoll._greedy_match(jax.numpy.asarray(cand), rounds))
        got = collisions._greedy_match(torch.from_numpy(cand), rounds).numpy()
        np.testing.assert_array_equal(got, want)
        for k in (3, 64):
            wi, wj, wv = (np.asarray(x) for x in jcoll._top_pairs(jax.numpy.asarray(want), k))
            gi, gj, gv = (x.numpy() for x in collisions._top_pairs(torch.from_numpy(got), k))
            np.testing.assert_array_equal(gv, wv)
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gj, wj)


def test_empty_events_match_jax():
    cfg, jcfg = SimConfig(), JaxConfig()
    ev, jev = collisions.empty_events(cfg), jcoll.empty_events(jcfg)
    for k, v in ev.__dict__.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(getattr(jev, k)), err_msg=k)
        assert v.numpy().dtype == np.asarray(getattr(jev, k)).dtype, k
