"""The port's whole frame on the reference galaxy and on an at-scale state
(`nbx_torch.render.pipeline.render_and_advance`, `render_granular`) against
the JAX package's, as tests/test_render_fx.py's pipeline tests hold
`nbx.render.pipeline`.

Inputs: the reference galaxy at capacity 300 at 160x90 with the JAX
package's starfield and synthetic merge / fracture / fragment events; a
4,096-body at-scale state (`GranularState`, one substep's `ScaledEvents`)
with trails on 64 bodies at 96x64. The same state, events, camera, stars and
particle draws go to both packages. Bars as in
tests/test_torch_render_frame.py: frames with impostors to
IMPOSTOR_FRAME_TOL, the renderer's state to FLOAT_TOL with the particle
slots exact."""

import jax.numpy as jnp
import numpy as np
import torch

from nbx import scene as jscene
from nbx.collisions import Events as JaxEvents
from nbx.collisions_scaled import ScaledEvents as JaxScaledEvents
from nbx.collisions_scaled import make_granular_state as jax_granular_state
from nbx.render import pipeline as jpipeline
from nbx.render import splat as jsplat
from nbx_torch import convert
from nbx_torch.collisions import Events
from nbx_torch.collisions_scaled import ScaledEvents
from nbx_torch.render import pipeline
from torch_parity import (
    assert_frame_close, assert_frame_state_matches, configs, jax_camera, jax_frame_arrays, jax_frame_draws,
    port_granular_state, port_state,
)

torch.set_num_threads(1)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _synthetic_events(jst, jcfg, rng):
    """Frame events of 2 substeps placed on live bodies: merges, fractures and
    fragment spawns, as numpy arrays (the galaxy fires none in 3 frames)."""
    pos = np.asarray(jst.pos)[np.asarray(jst.alive)]
    s, m, f = jcfg.sub_steps, jcfg.max_merges, jcfg.max_fractures
    k = f * jcfg.max_fragments
    d = dict(merge_pos=pos[rng.integers(0, len(pos), (s, m))], merge_mass=rng.uniform(1, 50, (s, m)),
             merge_mask=rng.uniform(size=(s, m)) < 0.2, fracture_pos=pos[rng.integers(0, len(pos), (s, f))],
             fracture_energy=rng.uniform(10, 200, (s, f)), fracture_mask=rng.uniform(size=(s, f)) < 0.3,
             spawn_pos=pos[rng.integers(0, len(pos), (s, k))], spawn_temp=np.zeros((s, k)),
             spawn_mask=rng.uniform(size=(s, k)) < 0.3)
    d = {name: (v.astype(np.float32) if v.dtype == np.float64 else v) for name, v in d.items()}
    for c in ("n_merges", "n_fractures", "n_bounces", "n_evicted", "n_dropped"):
        d[c] = np.zeros(s, np.int32)
    return d


def test_render_and_advance_galaxy_with_stars():
    """The reference galaxy at capacity 300, 160x90, the JAX package's
    starfield, synthetic merge / fracture / fragment events over 2 frames."""
    jcfg, cfg = configs()
    jst = jscene.make_state(jcfg, jscene.reference_galaxy(seed=0), key=0)
    st = port_state(jst, cfg)
    rng = np.random.default_rng(4)
    jcam = jsplat.Camera.default().orbit(0.3, 0.2, 0.55)
    cam = jax_camera(jcam)
    jstars = jpipeline.starfield_directions()
    stars = convert.starfield_from_array(jstars, "cpu")
    jfr = jpipeline.FrameState.create(jcfg.capacity, jcfg.trail_length)
    fr = convert.frame_state_from_arrays(jax_frame_arrays(jfr), "cpu")
    key = jfr.particles.key
    for k in range(2):
        d = _synthetic_events(jst, jcfg, rng)
        key, draws = jax_frame_draws(key, jcfg.capacity, jfr.particles.life.shape[0], d["spawn_mask"].size)
        jfr, want = jpipeline.render_and_advance(jfr, jst, jcfg, JaxEvents(**{n: jnp.asarray(v) for n, v in d.items()}),
                                                 jcam, width=160, height=90, stars=jstars)
        fr, img = pipeline.render_and_advance(fr, st, cfg, Events(**{n: _t(v) for n, v in d.items()}), cam,
                                              width=160, height=90, stars=stars, draws=draws)
        assert_frame_close(img.numpy(), want, f"galaxy frame {k}")
        assert_frame_state_matches(fr, jfr)


def test_render_granular_matches():
    """render_granular on an at-scale state: 4,096 bodies, trails on 64 of
    them, one substep's ScaledEvents, 96x64."""
    rng = np.random.default_rng(5)
    n = 4096
    pos = rng.uniform(30, 70, (n, 3)).astype(np.float32)
    vel = rng.normal(0, 1, (n, 3)).astype(np.float32)
    mass = rng.uniform(0.05, 0.4, n).astype(np.float32)
    mass[::97] = 0.0  # dead slots
    temp = np.where(rng.uniform(size=n) < 0.05, rng.uniform(60, 300, n), 0.0).astype(np.float32)
    jst = jax_granular_state(pos, vel, mass, temp=temp, key=0)
    st = port_granular_state(jst)
    jcfg, cfg = configs(sub_steps=1, merge_time=0.25, fracture_threshold=8.0)
    m, f = 64, 32
    ev = dict(merge_pos=pos[rng.integers(0, n, (1, m))], merge_mass=rng.uniform(0.1, 1, (1, m)).astype(np.float32),
              merge_mask=rng.uniform(size=(1, m)) < 0.3, fracture_pos=pos[rng.integers(0, n, (1, f))],
              fracture_energy=rng.uniform(10, 90, (1, f)).astype(np.float32),
              fracture_mask=rng.uniform(size=(1, f)) < 0.3, spawn_pos=pos[rng.integers(0, n, (1, 4 * f))],
              spawn_temp=np.zeros((1, 4 * f), np.float32), spawn_mask=rng.uniform(size=(1, 4 * f)) < 0.3,
              touched=np.zeros((1, 0), bool))
    for c in ("n_merges", "n_fractures", "n_bounces", "n_overflow", "n_dropped"):
        ev[c] = np.zeros(1, np.int32)
    ev["cell_too_small"] = np.zeros(1, bool)
    trail_idx = np.argsort(-mass, kind="stable")[:64].astype(np.int32)
    jcam = jsplat.Camera(eye=jnp.asarray([50.0, 110.0, 160.0]), target=jnp.full((3,), 50.0),
                         up=jnp.asarray([0.0, 1.0, 0.0]))
    jfr = jpipeline.FrameState.create(64, 40)
    fr = convert.frame_state_from_arrays(jax_frame_arrays(jfr), "cpu")
    _, draws = jax_frame_draws(jfr.particles.key, n, jfr.particles.life.shape[0], 4 * f)
    jfr2, want = jpipeline.render_granular(jfr, jst, jcfg, JaxScaledEvents(**{k: jnp.asarray(v) for k, v in ev.items()}),
                                           jcam, jnp.asarray(trail_idx), width=96, height=64)
    fr2, img = pipeline.render_granular(fr, st, cfg, ScaledEvents(**{k: _t(v) for k, v in ev.items()}),
                                        jax_camera(jcam), _t(trail_idx), width=96, height=64, draws=draws)
    assert_frame_close(img.numpy(), want, "render_granular")
    assert_frame_state_matches(fr2, jfr2)
