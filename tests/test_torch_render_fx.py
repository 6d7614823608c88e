"""The port's bloom and flash lights against the JAX package's on the same
inputs, as tests/test_render_fx.py holds `nbx.render` (the impostor pass:
tests/test_torch_impostor.py; particles, trails, the starfield and camera
paths: tests/test_torch_render_particles.py).

Bars: images and lights to FLOAT_TOL (1e-5) of each array's largest
magnitude, the live lights and lit pixels exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbx.render import bloom as jbloom
from nbx.render import lights as jlights
from nbx.render.splat import Camera as JaxCamera
from nbx_torch import convert
from nbx_torch.render import bloom, lights
from torch_parity import assert_close, assert_hdr_close, jax_camera

torch.set_num_threads(1)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


# ---- bloom ---------------------------------------------------------------------

@pytest.mark.parametrize("strength,threshold,sigma,radius", [(1.2, 0.3, 3.0, 8), (0.7, 0.05, 2.0, 5)])
def test_bloom_matches(strength, threshold, sigma, radius):
    rng = np.random.default_rng(0)
    hdr = (np.abs(rng.normal(0, 0.2, (40, 56, 3))) * (rng.uniform(size=(40, 56, 1)) < 0.1) * 30).astype(np.float32)
    hdr[0, 0] = 25.0  # a bright corner: the halo clamps, it does not wrap
    want = jbloom.bloom(jnp.asarray(hdr), strength, threshold, sigma, radius)
    got = bloom.bloom(_t(hdr), strength, threshold, sigma, radius)
    assert_hdr_close(got.numpy(), want, "bloom")


def test_bloom_keeps_sub_threshold_pixels():
    img = torch.zeros((32, 32, 3))
    img[16, 16] = 0.2
    np.testing.assert_array_equal(bloom.bloom(img).numpy(), img.numpy())


# ---- lights --------------------------------------------------------------------

def test_lights_advance_matches_over_frames():
    """Random flashes, more than the pool holds on some frames: the pool's
    slots, decay and cull as the JAX package's, frame after frame."""
    rng = np.random.default_rng(1)
    jli = jlights.LightState.create()
    li = convert.light_state_from_arrays({"pos": np.asarray(jli.pos), "intensity": np.asarray(jli.intensity)}, "cpu")
    for k in range(30):
        f = 12
        fpos = rng.uniform(-50, 50, (f, 3)).astype(np.float32)
        energy = rng.uniform(0, 120, f).astype(np.float32)
        mask = rng.uniform(size=f) < (0.8 if k % 7 == 0 else 0.15)
        jli = jlights.advance(jli, fpos, energy, mask)
        li = lights.advance(li, _t(fpos), _t(energy), _t(mask))
        np.testing.assert_array_equal(li.intensity.numpy() > 0, np.asarray(jli.intensity) > 0)
        assert_close(li.intensity.numpy(), np.asarray(jli.intensity), f"intensity {k}")
        assert_close(li.pos.numpy(), np.asarray(jli.pos), f"pos {k}")
    assert int((li.intensity > 0).sum()) > 0
    pos = rng.uniform(-60, 60, (200, 3)).astype(np.float32)
    assert_close(lights.body_light_gain(li, _t(pos)).numpy(), np.asarray(jlights.body_light_gain(jli, pos)),
                 "body_light_gain")


def test_light_pool_decay_cull_and_reuse():
    li = lights.LightState.create(pool=4, device="cpu")
    fpos = torch.tensor([[1.0, 2.0, 3.0]])
    li = lights.advance(li, fpos, torch.tensor([100.0]), torch.tensor([True]))
    assert float(li.intensity.max()) == 15.0
    frames = 0
    while float(li.intensity.max()) > 0:
        li = lights.advance(li, torch.zeros((1, 3)), torch.zeros(1), torch.tensor([False]))
        frames += 1
        assert frames < 100
    assert frames > 10
    li = lights.advance(li, fpos, torch.tensor([10.0]), torch.tensor([True]))
    assert float(li.intensity.max()) == 2.0


@pytest.mark.parametrize("with_depth", [False, True])
def test_light_glow_matches(with_depth):
    rng = np.random.default_rng(2)
    jli = jlights.LightState(pos=jnp.asarray(rng.uniform(-30, 30, (16, 3)), jnp.float32),
                             intensity=jnp.asarray(np.where(rng.uniform(size=16) < 0.6, rng.uniform(0.1, 15, 16), 0),
                                                   jnp.float32))
    li = lights.LightState(pos=_t(jli.pos), intensity=_t(jli.intensity))
    img = np.abs(rng.normal(0, 0.2, (48, 64, 3))).astype(np.float32)
    depth = np.where(rng.uniform(size=(48, 64)) < 0.5, rng.uniform(120, 200, (48, 64)), np.inf).astype(np.float32)
    jcam = JaxCamera.default()
    want = jlights.splat_light_glow(jnp.asarray(img), jli, jcam, width=64, height=48,
                                    depth=jnp.asarray(depth) if with_depth else None)
    got = lights.splat_light_glow(_t(img), li, jax_camera(jcam), width=64, height=48,
                                  depth=_t(depth) if with_depth else None)
    assert_hdr_close(got.numpy(), want, "light glow")
