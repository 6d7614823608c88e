"""The 8 random scenes of tests/test_parity_fuzz.py through the port, against
the sequential NumPy oracle (tests/oracle.py): bounce and merge, fracture off
(its random streams differ by construction).

- collision_impl="jacobi": that file's bars (survivor count exact, total
  mass to 1e-5, positions and velocities within 0.15, the Jacobi sweep's
  contact-cluster divergence from the sequential reference);
- collision_impl="sequential": the same checks at SEQUENTIAL_ATOL. The
  sweep follows the oracle's pair order, so only float32 rounding and the
  oracle's float64 separate them: over the 8 scenes the largest error
  measured 1.10e-5 in positions and 1.8e-6 in velocities on the CPU, as did
  the Jacobi sweep's (seed 7 merges once and bounces 9 times; the others
  never touch)."""

import numpy as np
import pytest
import torch

import oracle as orc
from nbx_torch import scene, sim
from nbx_torch.config import SimConfig
from nbx_torch.state import compact_arrays

torch.set_num_threads(1)

JACOBI_ATOL = 0.15  # tests/test_parity_fuzz.py's bar
SEQUENTIAL_ATOL = 1e-4


def _random_scene(seed, n=6, spread=12.0):
    rng = np.random.default_rng(seed)
    return dict(
        pos=rng.uniform(-spread, spread, (n, 3)).astype(np.float32),
        vel=rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32),
        mass=rng.uniform(5.0, 30.0, n).astype(np.float32),
        mat=rng.integers(0, 3, n).astype(np.int32),
        temp=np.zeros(n, np.float32),
    )


@pytest.mark.parametrize("collision_impl", ["jacobi", "sequential"])
@pytest.mark.parametrize("seed", range(8))
def test_fuzz_parity_bounce_merge(seed, collision_impl):
    sc = _random_scene(seed)
    cfg = SimConfig(capacity=16, fracture_threshold=1e9, merge_time=0.08)
    st = scene.make_state(cfg, sc, "cpu", seed=seed)
    ref = orc.from_scene(sc, G=cfg.G, softening=cfg.softening, max_bodies=cfg.capacity,
                         fracture_threshold=cfg.fracture_threshold, merge_time=cfg.merge_time)
    h = cfg.dt / cfg.sub_steps
    n_frames = 60
    for _ in range(n_frames):
        st, _ = sim.step(st, cfg, collision_impl=collision_impl)
    for _ in range(n_frames * cfg.sub_steps):
        ref.integrate(h)

    got = compact_arrays(st)
    assert len(ref.bodies) == int(st.n_alive), (seed, len(ref.bodies), int(st.n_alive))
    np.testing.assert_allclose(got["mass"].sum(), ref.mass_array().sum(), rtol=1e-5)
    atol = JACOBI_ATOL if collision_impl == "jacobi" else SEQUENTIAL_ATOL
    np.testing.assert_allclose(got["pos"], ref.pos_array(), atol=atol)
    np.testing.assert_allclose(got["vel"], ref.vel_array(), atol=atol)
    assert np.isfinite((got["mass"][:, None] * got["vel"]).sum(0)).all()
