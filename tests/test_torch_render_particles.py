"""The port's particles, trails, starfield and camera paths against the JAX
package's on the same inputs (the rest of tests/test_render_fx.py's and
test_campath.py's cases; bloom, lights and impostors are in
tests/test_torch_render_fx.py).

Bars: images, trails and particles to FLOAT_TOL (1e-5) of each array's
largest magnitude; particle slots exactly, ties included (`lax.top_k(-life)`
takes the lower index on ties, and orders -0.0 below +0.0: the port's stable
sort of order-preserving keys, `splat.top_k_indices`). The particle spawns
take the JAX package's draws (`torch_parity.jax_smoke_draws`,
`jax_explosion_draws`); camera paths to 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbx.render import campath as jcampath
from nbx.render import particles as jparticles
from nbx.render import pipeline as jpipeline
from nbx.render import trails as jtrails
from nbx.render.splat import Camera as JaxCamera
from nbx_torch import convert
from nbx_torch.render import campath, particles, pipeline, trails
from nbx_torch.render.splat import Camera
from torch_parity import assert_close, assert_hdr_close, jax_camera, jax_explosion_draws, jax_smoke_draws

torch.set_num_threads(1)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


# ---- particles -------------------------------------------------------------------

def _particles_from(jp):
    return convert.particle_state_from_arrays({k: np.asarray(getattr(jp, k)) for k in ("pos", "vel", "life", "decay")},
                                              "cpu")


def _assert_particles(p, jp, what):
    np.testing.assert_array_equal(p.life.numpy() > 0, np.asarray(jp.life) > 0, err_msg=f"{what}: live slots")
    np.testing.assert_array_equal(p.decay.numpy() > 0, np.asarray(jp.decay) > 0, err_msg=f"{what}: written slots")
    for name in ("pos", "vel", "life", "decay"):
        assert_close(getattr(p, name).numpy(), np.asarray(getattr(jp, name)), f"{what}: {name}")


def test_particle_spawns_match_with_the_jax_draws():
    """Smoke from hot bodies and explosions frame after frame into a pool of
    96: spawns overflow the pool (least-life slots first, ties lowest index
    first), particles die and their slots are reused."""
    rng = np.random.default_rng(9)
    n = 40
    body_pos = rng.normal(0, 10, (n, 3)).astype(np.float32)
    body_vel = rng.normal(0, 1, (n, 3)).astype(np.float32)
    radius = rng.uniform(0.5, 2, n).astype(np.float32)
    temp = np.where(np.arange(n) % 3 == 0, rng.uniform(60, 600, n), 10).astype(np.float32)
    alive = rng.uniform(size=n) < 0.9
    jp = jparticles.ParticleState.create(96, key=4)
    p = _particles_from(jp)
    for k in range(12):
        jp = jparticles.update(jp, 0.016)
        p = particles.update(p, 0.016)
        key, smoke = jax_smoke_draws(jp.key, n, 96)
        jp = jparticles.spawn_smoke(jp, body_pos, body_vel, radius, temp, alive)
        p = particles.spawn_smoke(p, _t(body_pos), _t(body_vel), _t(radius), _t(temp), _t(alive), draws=smoke)
        centers = rng.uniform(-20, 20, (3, 3)).astype(np.float32)
        mask = rng.uniform(size=3) < 0.5
        _, expl = jax_explosion_draws(key, 3)
        jp = jparticles.spawn_explosions(jp, centers, mask)
        p = particles.spawn_explosions(p, _t(centers), _t(mask), draws=expl)
        _assert_particles(p, jp, f"frame {k}")
        for _ in range(k % 4 * 10):  # let some die
            jp, p = jparticles.update(jp, 0.1), particles.update(p, 0.1)
    assert int(p.n_alive) > 0


def test_particle_slots_with_tied_lives():
    """Every slot dead (all lives tie at 0) and then half the pool alive with
    tied lives: the spawned particles take the slots lax.top_k picks."""
    jp = jparticles.ParticleState.create(40, key=2)
    life = np.zeros(40, np.float32)
    life[::2] = 0.5  # 20 live slots, all with the same life
    jp = dataclasses.replace(jp, life=jnp.asarray(life), decay=jnp.full(40, 0.01))
    p = _particles_from(jp)
    for k in range(3):
        key, expl = jax_explosion_draws(jp.key, 2)
        jp = jparticles.spawn_explosions(jp, jnp.zeros((2, 3)), jnp.asarray([True, k != 1]))
        p = particles.spawn_explosions(p, torch.zeros((2, 3)), torch.tensor([True, k != 1]), draws=expl)
        _assert_particles(p, jp, f"spawn {k}")
    slots, _ = particles.free_slots(_t(life), 40)
    _, want = jax.lax.top_k(-jnp.asarray(life), 40)
    np.testing.assert_array_equal(slots.numpy(), np.asarray(want))


@pytest.mark.parametrize("with_depth", [False, True])
def test_splat_particles_matches(with_depth):
    rng = np.random.default_rng(10)
    jp = jparticles.ParticleState(pos=jnp.asarray(rng.normal(0, 20, (500, 3)), jnp.float32),
                                  vel=jnp.zeros((500, 3)), life=jnp.asarray(rng.uniform(-0.2, 1, 500), jnp.float32),
                                  decay=jnp.zeros(500), key=jax.random.PRNGKey(0))
    p = _particles_from(jp)
    depth = np.where(rng.uniform(size=(48, 64)) < 0.5, rng.uniform(120, 200, (48, 64)), np.inf).astype(np.float32)
    jcam = JaxCamera.default()
    want = jparticles.splat_particles(jnp.zeros((48, 64, 3)), jp, jcam, width=64, height=48,
                                      depth=jnp.asarray(depth) if with_depth else None)
    got = particles.splat_particles(torch.zeros((48, 64, 3)), p, jax_camera(jcam), width=64, height=48,
                                    depth=_t(depth) if with_depth else None)
    assert_hdr_close(got.numpy(), want, "particles")


# ---- trails --------------------------------------------------------------------------

def test_trails_ring_buffer_and_ribbons_match():
    """update past the ring's wrap (head 30, L 12), a dead slot clearing its
    history, by_age, and splat_trails with and without a depth buffer."""
    rng = np.random.default_rng(11)
    c, length = 6, 12
    jt = jtrails.TrailState.create(c, length)
    t = convert.trail_state_from_arrays({k: np.asarray(getattr(jt, k)) for k in ("pos", "valid", "head")}, "cpu")
    pos = rng.normal(0, 10, (c, 3)).astype(np.float32)
    for k in range(30):
        pos = pos + rng.normal(0, 1.5, (c, 3)).astype(np.float32)
        alive = np.ones(c, bool)
        alive[2] = k < 20 or k > 25
        jt = jtrails.update(jt, pos, alive)
        t = trails.update(t, _t(pos), _t(alive))
    np.testing.assert_array_equal(t.valid.numpy(), np.asarray(jt.valid))
    assert int(t.head) == int(jt.head) == 30
    for g, w in zip(trails.by_age(t), jtrails.by_age(jt)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    radius = rng.uniform(1, 4, c).astype(np.float32)
    temp = rng.uniform(0, 200, c).astype(np.float32)
    mat = rng.integers(0, 3, c).astype(np.int32)
    c1 = np.asarray([[0.4, 0.3, 0.2], [0.6, 0.6, 0.7], [0.8, 0.9, 1.0]], np.float32)
    c2 = np.asarray([[0.1, 0.1, 0.1], [0.3, 0.3, 0.4], [0.1, 0.3, 0.6]], np.float32)
    jcam = JaxCamera(eye=jnp.asarray([0.0, 20.0, 70.0]), target=jnp.zeros(3), up=jnp.asarray([0.0, 1.0, 0.0]))
    depth = np.where(rng.uniform(size=(60, 80)) < 0.5, rng.uniform(50, 90, (60, 80)), np.inf).astype(np.float32)
    for d in (None, depth):
        want = jtrails.splat_trails(jnp.zeros((60, 80, 3)), jt, radius, temp, mat, c1, c2, jcam, width=80, height=60,
                                    depth=None if d is None else jnp.asarray(d))
        got = trails.splat_trails(torch.zeros((60, 80, 3)), t, _t(radius), _t(temp), _t(mat), _t(c1), _t(c2),
                                  jax_camera(jcam), width=80, height=60, depth=None if d is None else _t(d))
        assert_hdr_close(got.numpy(), want, "trails")


# ---- the starfield -------------------------------------------------------------------

def test_starfield_matches_with_the_jax_directions():
    jdirs = jpipeline.starfield_directions(n=800)
    dirs = convert.starfield_from_array(jdirs, "cpu")
    depth = np.where(np.random.default_rng(12).uniform(size=(90, 160)) < 0.3, 200.0, np.inf).astype(np.float32)
    for jcam in (JaxCamera.default(), JaxCamera.default().orbit(d_yaw=1.0)):
        for d in (None, depth):
            want = jpipeline.splat_starfield(jnp.zeros((90, 160, 3)), jdirs, jcam, width=160, height=90,
                                             depth=None if d is None else jnp.asarray(d))
            got = pipeline.splat_starfield(torch.zeros((90, 160, 3)), dirs, jax_camera(jcam), width=160, height=90,
                                           depth=None if d is None else _t(d))
            assert_hdr_close(got.numpy(), want, "stars")
    own = pipeline.starfield_directions(n=800, device="cpu")
    assert own.shape == (800, 3)
    np.testing.assert_allclose(torch.linalg.vector_norm(own, dim=1).numpy(), 1.0, rtol=1e-6)
    assert torch.equal(own, pipeline.starfield_directions(n=800, device="cpu"))  # seeded with 7, as nbx's key


# ---- camera paths --------------------------------------------------------------------

def _cams_close(cams, jcams, what):
    assert len(cams) == len(jcams)
    for k, (c, jc) in enumerate(zip(cams, jcams)):
        for name in ("eye", "target", "up"):
            assert_close(getattr(c, name).numpy(), np.asarray(getattr(jc, name)), f"{what} {k} {name}", 1e-5)
        assert abs(c.fov_deg - float(jc.fov_deg)) <= 1e-5 * abs(float(jc.fov_deg))


@pytest.mark.parametrize("ease", [False, True])
def test_orbit_path_matches(ease):
    jcam = JaxCamera.default()
    cam = Camera.default("cpu")
    _cams_close(list(campath.orbit_path(cam, 9, d_yaw=2.0, d_pitch=0.4, zoom=0.6, ease=ease)),
                list(jcampath.orbit_path(jcam, 9, d_yaw=2.0, d_pitch=0.4, zoom=0.6, ease=ease)), "orbit")
    full = list(campath.orbit_path(cam, 13))
    assert_close(full[-1].eye.numpy(), cam.eye.numpy(), "full turn home", 1e-5)


def test_keyframe_path_matches():
    jkeys = [JaxCamera.default(), JaxCamera.default().orbit(2.5, 0.3, 0.5),
             JaxCamera(eye=jnp.asarray([40.0, 10.0, -60.0]), target=jnp.asarray([5.0, 0.0, 0.0]),
                       up=jnp.asarray([0.0, 1.0, 0.0]), fov_deg=60.0)]
    keys = [jax_camera(k) for k in jkeys]
    for ease in (True, False):
        _cams_close(list(campath.keyframe_path(keys, 11, ease=ease)), list(jcampath.keyframe_path(jkeys, 11, ease=ease)),
                    f"keyframes ease={ease}")
    with pytest.raises(ValueError, match="2 keyframes"):
        list(campath.keyframe_path(keys[:1], 4))
    ts = np.linspace(-0.5, 1.5, 41).astype(np.float32)
    np.testing.assert_array_equal(campath.ease_in_out(_t(ts)).numpy(), np.asarray(jcampath.ease_in_out(ts)))


def test_flash_pool_over_frames_in_the_pipeline():
    """A merge flash fires once and then decays over frames through
    render_and_advance, on the port alone (test_merge_flash_decays_over_frames)."""
    from nbx_torch import scene
    from nbx_torch.collisions import empty_events
    from nbx_torch.config import SimConfig

    cfg = SimConfig(capacity=32)
    st = scene.make_state(cfg, scene.head_on_collision(), "cpu")
    fr = pipeline.FrameState.create(cfg.capacity, cfg.trail_length, device="cpu")
    cam = Camera.default("cpu")
    ev = empty_events(cfg, "cpu")
    ev = dataclasses.replace(ev, merge_mass=ev.merge_mass.index_fill(0, torch.tensor([0]), 60.0),
                             merge_mask=ev.merge_mask.index_fill(0, torch.tensor([0]), True))
    fr, img0 = pipeline.render_and_advance(fr, st, cfg, ev, cam, width=160, height=90, use_bloom=False,
                                           n_impostors=0)
    assert float(fr.lights.intensity.max()) == 6.0
    quiet = empty_events(cfg, "cpu")
    prev = 6.0
    for _ in range(12):
        fr, img = pipeline.render_and_advance(fr, st, cfg, quiet, cam, width=160, height=90, use_bloom=False,
                                              n_impostors=0)
        cur = float(fr.lights.intensity.max())
        assert 0 < cur < prev
        prev = cur
    assert float(img0[38:52, 72:88].sum()) > float(img[38:52, 72:88].sum()) > 0
