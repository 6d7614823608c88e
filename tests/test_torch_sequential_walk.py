"""The sweep kernel's near-pair walk, proven on the CPU: its plain model
`ops.sequential._near_walk_reference` (the pre-pass's near set at the start
positions, the displacement bounds, the escape rule, only near or escaped
candidates tested) against the plain sweep `sweep_reference`.

- bitwise the same Sweep, n_tests included, on the scenes of
  test_torch_sequential.py, on chip_smoke's sequential scenes (its 4,096-body
  pile cut to a 512-body lattice pile), on dense random piles with deep
  overlaps and mixed masses, and on the two scenes built to escape;
- every hit of `sweep_reference`, in its order, is a hit of the walk, and
  lies in the near set or involves a body that had escaped;
- the escape scenes escape, and hit pairs outside the near set both as an
  escaped row and as an escaped partner."""

import numpy as np
import pytest
import torch

from chip_smoke import lattice_pile, sequential_scenes
from nbx_torch import scene, sim
from nbx_torch.config import SimConfig, inverse_mass
from nbx_torch.ops import sequential

torch.set_num_threads(1)

FIELDS = ("pos", "vel", "temp", "contact", "removed", "counts", "mbuf", "mmat", "fbuf", "fmat")


def _chain(n=5, spacing=2.5, mass=20.0):
    """tests/test_torch_sequential.py's chain pile."""
    pos = np.zeros((n, 3), np.float32)
    pos[:, 0] = (np.arange(n) - (n - 1) / 2) * spacing
    pos[:, 1] = np.linspace(0.0, 0.3, n)
    vel = np.zeros((n, 3), np.float32)
    vel[:, 0] = -np.sign(pos[:, 0]) * 1.5
    return dict(pos=pos, vel=vel, mass=np.full(n, mass, np.float32), mat=np.zeros(n, np.int32),
                temp=np.zeros(n, np.float32))


def _random_pile(seed, n=64):
    """n bodies of masses spread over four decades packed into a small box:
    deep overlaps, fast bodies, some dead slots."""
    rng = np.random.default_rng(seed)
    mass = (10.0 ** rng.uniform(-2, 2, n)).astype(np.float32)
    return dict(pos=rng.uniform(-6, 6, (n, 3)).astype(np.float32),
                vel=rng.normal(0, 4, (n, 3)).astype(np.float32), mass=mass,
                mat=rng.integers(0, 3, n).astype(np.int32), temp=np.zeros(n, np.float32))


def _scenes():
    out = {name: v for name, v in sequential_scenes().items() if name != "4,096-body pile"}
    pile, timers = lattice_pile(8)
    out["512-body lattice pile"] = (SimConfig(capacity=512), pile, timers)
    out["chain, no overlap"] = (SimConfig(capacity=16), _chain(spacing=10.0), None)
    out["chain, merges"] = (SimConfig(capacity=16, merge_time=0.0), _chain(), None)
    for seed in range(3):
        out[f"random pile {seed}"] = (SimConfig(capacity=80, merge_time=0.05, fracture_threshold=40.0),
                                      _random_pile(seed), None)
    return out


SCENES = _scenes()
ESCAPE_SCENES = ("gap chain", "pushed body's own row")


def _inputs(name):
    cfg, sc, timers = SCENES[name]
    st = scene.make_state(cfg, sc, "cpu")
    contact = st.contact if timers is None else torch.from_numpy(timers)
    return (st.pos, st.vel, st.temp, st.mass, st.radius(cfg), inverse_mass(st.mass), st.mat, st.alive,
            contact), sim.substep_size(cfg), cfg


def _both(name, monkeypatch):
    """(sweep_reference's Sweep, its applied pairs in order, the walk's
    Sweep, the walk's bookkeeping)."""
    args, h, cfg = _inputs(name)
    applied, apply = [], sequential._apply_pair

    def recording(i, j, *rest):
        applied.append((i, j))
        return apply(i, j, *rest)

    with monkeypatch.context() as m:
        m.setattr(sequential, "_apply_pair", recording)
        want = sequential.sweep_reference(*args, h, cfg)
    got, walk = sequential._near_walk_reference(*args, h, cfg)
    return want, applied, got, walk


@pytest.mark.parametrize("name", list(SCENES))
def test_walk_matches_plain_sweep(name, monkeypatch):
    want, applied, got, walk = _both(name, monkeypatch)
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert [(i, j) for i, j, *_ in walk.hits] == applied
    # each hit was in the near set, or one of its bodies had escaped
    assert all(near or esc_i or esc_j for _, _, near, esc_i, esc_j in walk.hits)
    assert all(walk.near[i, j] == near for i, j, near, *_ in walk.hits)
    assert int(want.count("n_tests")) > 0


@pytest.mark.parametrize("name", ESCAPE_SCENES)
def test_escape_scenes_reach_the_escape_path(name, monkeypatch):
    _, applied, _, walk = _both(name, monkeypatch)
    assert walk.escaped.sum() >= 1
    far = [h for h in walk.hits if not h[2]]  # hits outside the near set
    assert far, walk.hits
    assert any(esc_i for _, _, _, esc_i, _ in far)  # an escaped row's full scan
    if name == "gap chain":  # a row that had not escaped, testing an escaped partner
        assert any(esc_j and not esc_i for _, _, _, esc_i, esc_j in far)
    else:  # the pushed body hits in its own row a body it never neared
        i, j = far[0][:2]
        assert (0, i) in applied[:1] and not walk.near[i, j]


def test_near_set_holds_every_start_overlap():
    """The near set is the overlap test at twice the radius sum: every pair
    overlapping at the start is in it, and a pair far beyond it is not."""
    args, _, _ = _inputs("512-body lattice pile")
    pos, radius = args[0], args[4]
    near = sequential._near_set(pos, radius)
    d = (pos[None, :, :] - pos[:, None, :]).double().norm(dim=-1).numpy()
    rsum = (radius[:, None] + radius[None, :]).double().numpy()
    upper = np.triu(np.ones_like(near), 1)
    assert np.all(near[(d < rsum) & upper])
    assert not near[(d > 2.001 * rsum) & upper].any()
    assert near.sum() > (upper & (d < rsum)).sum()
