"""The port's whole frame (`nbx_torch.render.pipeline.render_and_advance`,
`render_granular`) against the JAX package's on the same inputs, as
tests/test_render_fx.py's pipeline tests hold `nbx.render.pipeline`.

Inputs: a 32-body collision scene stepped by `nbx.sim.step` (its real merges
and fractures) at 64x48, frame after frame. The same state, events, camera
and particle draws go to both packages (`torch_parity.jax_frame_draws`
rebuilds the JAX key splits). The galaxy's frames and `render_granular` are
in tests/test_torch_render_granular.py.

Bars: the renderer's state (trails, particles, lights) to FLOAT_TOL (1e-5) of
each field's largest magnitude, with the particle slots and the live lights
exact. A frame with sphere impostors is held to IMPOSTOR_FRAME_TOL (1e-3 of
its largest value; `torch_parity`): the impostor's normal is sqrt(1 - d^2),
ill-conditioned at a disc's rim, so one float32 rounding of d^2 moves a rim
pixel's shading (IMPOSTOR_TOL of max|HDR|, tests/test_torch_render_fx.py),
and the tonemap carries that onto [0, 1]. The same frame without impostors
is held to FLOAT_TOL with the set of lit pixels exact."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbx import scene as jscene
from nbx import sim as jsim
from nbx.render import pipeline as jpipeline
from nbx.render import splat as jsplat
from nbx_torch import convert
from nbx_torch.collisions import Events
from nbx_torch.render import pipeline
from torch_parity import (
    assert_frame_close, assert_frame_state_matches, assert_hdr_close, configs, jax_camera, jax_frame_arrays,
    jax_frame_draws, port_state,
)

torch.set_num_threads(1)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _collision_scene():
    """32 bodies: a hot cluster of 24 around the origin, a violent head-on
    pair and 6 slow bodies, fracture_threshold 5 so impacts fracture."""
    rng = np.random.default_rng(3)
    pos = np.concatenate([rng.normal(0, 4, (24, 3)), [[-2.4, 9, 0], [2.4, 9, 0.5]], rng.uniform(-30, 30, (6, 3))])
    vel = np.concatenate([rng.normal(0, 2, (24, 3)), [[25, 0, 0], [-25, 0, 0]], rng.normal(0, 0.5, (6, 3))])
    mass = np.concatenate([rng.uniform(2, 10, 24), [40, 40], rng.uniform(1, 3, 6)])
    temp = np.concatenate([rng.uniform(0, 150, 24), [0, 0], np.zeros(6)])
    mat = rng.integers(0, 3, 32)
    return dict(pos=pos.astype(np.float32), vel=vel.astype(np.float32), mass=mass.astype(np.float32),
                mat=mat.astype(np.int32), temp=temp.astype(np.float32))


def _events(ev, cls):
    return cls(**{f.name: _t(getattr(ev, f.name)) for f in dataclasses.fields(cls)})


@pytest.fixture(scope="module")
def collision_run():
    """4 frames of the 32-body scene through nbx.sim.step and nbx's
    render_and_advance: per frame the state, events, FrameState before and
    after, the draws and the frame."""
    jcfg, cfg = configs(capacity=32, fracture_threshold=5.0)
    jst = jscene.make_state(jcfg, _collision_scene(), key=1)
    jfr = jpipeline.FrameState.create(jcfg.capacity, jcfg.trail_length, pool=256)
    jcam = jsplat.Camera(eye=jnp.asarray([0.0, 25.0, 55.0]), target=jnp.zeros(3), up=jnp.asarray([0.0, 1.0, 0.0]))
    frames = []
    for _ in range(4):
        jst, jev = jsim.step(jst, jcfg)
        f = int(np.asarray(jev.spawn_mask).size)
        _, draws = jax_frame_draws(jfr.particles.key, jcfg.capacity, 256, f)
        jfr2, img = jpipeline.render_and_advance(jfr, jst, jcfg, jev, jcam, width=64, height=48)
        frames.append((jst, jev, jfr, draws, jfr2, np.asarray(img)))
        jfr = jfr2
    return jcfg, cfg, jcam, frames


def test_render_and_advance_collision_scene(collision_run):
    jcfg, cfg, jcam, frames = collision_run
    fired = 0
    for k, (jst, jev, jfr, draws, jfr2, want) in enumerate(frames):
        fr = convert.frame_state_from_arrays(jax_frame_arrays(jfr), "cpu")
        fr2, img = pipeline.render_and_advance(fr, port_state(jst, cfg), cfg, _events(jev, Events), jax_camera(jcam),
                                               width=64, height=48, draws=draws)
        assert_frame_close(img.numpy(), want, f"frame {k}")
        assert_frame_state_matches(fr2, jfr2)
        fired += int(np.asarray(jev.n_fractures).sum() + np.asarray(jev.n_merges).sum())
    assert fired > 0  # the frames carried real events
    assert int((np.asarray(frames[-1][4].particles.life) > 0).sum()) > 0  # particles live


def test_render_and_advance_without_impostors_at_float_tol(collision_run):
    jcfg, cfg, jcam, frames = collision_run
    jst, jev, jfr, draws, _, _ = frames[2]
    jfr2, want = jpipeline.render_and_advance(jfr, jst, jcfg, jev, jcam, width=64, height=48, n_impostors=0,
                                              bloom_strength=0.8, bloom_threshold=0.2, exposure=2.0)
    fr = convert.frame_state_from_arrays(jax_frame_arrays(jfr), "cpu")
    fr2, img = pipeline.render_and_advance(fr, port_state(jst, cfg), cfg, _events(jev, Events), jax_camera(jcam),
                                           width=64, height=48, n_impostors=0, bloom_strength=0.8,
                                           bloom_threshold=0.2, exposure=2.0, draws=draws)
    assert_hdr_close(img.numpy(), want, "frame, no impostors")
    assert_frame_state_matches(fr2, jfr2)
