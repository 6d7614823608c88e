"""The port's renderer (`nbx_torch.render`) against the JAX package's on the
same inputs: the camera, the point splats, flashes, tonemap and the viewer's
files, as tests/test_render.py and test_camera.py hold `nbx.render`; the
whole frame is in tests/test_torch_render_frame.py.

Inputs: the reference galaxy at capacity 300 at 160x90 (and 64x48), under
three cameras. Bars: every image to FLOAT_TOL (1e-5) of its largest
magnitude, HDR before the tonemap or the frame after it, with the set of lit
pixels exact."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbx import scene as jscene
from nbx.config import SimConfig as JaxConfig
from nbx.render import colormap as jcolormap
from nbx.render import splat as jsplat
from nbx.render import viewer as jviewer
from nbx_torch.config import SimConfig
from nbx_torch.interactive import Simulation
from nbx_torch.render import colormap, splat, viewer
from torch_parity import assert_close, assert_hdr_close, configs, jax_camera, port_state

torch.set_num_threads(1)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _galaxy():
    jcfg, cfg = configs()
    jst = jscene.make_state(jcfg, jscene.reference_galaxy(seed=0), key=0)
    return jcfg, cfg, jst


# ---- the camera ---------------------------------------------------------------

def test_camera_project_orbit_pan_and_raycast():
    jcfg, cfg, jst = _galaxy()
    jcam = jsplat.Camera.default().orbit(0.4, 0.2, 0.7).pan(0.05, -0.02)
    cam = splat.Camera.default("cpu").orbit(0.4, 0.2, 0.7).pan(0.05, -0.02)
    for name in ("eye", "target", "up"):
        assert_close(getattr(cam, name).numpy(), np.asarray(getattr(jcam, name)), name)
    cam = jax_camera(jcam)
    for got, want in zip(splat.project(cam, _t(jst.pos), 160, 90), jsplat.project(jcam, jst.pos, 160, 90)):
        assert_close(got.numpy(), np.asarray(want), "project")
    for sx, sy in ((80, 45), (10, 80), (150, 5), (80, 0)):
        p, hit = splat.screen_to_plane(cam, sx, sy, 160, 90, plane_y=0.5)
        jp, jhit = jsplat.screen_to_plane(jcam, sx, sy, 160, 90, plane_y=0.5)
        assert bool(hit) == bool(jhit)
        if bool(hit):
            assert_close(p.numpy(), np.asarray(jp), "screen_to_plane")
    up = jax_camera(jsplat.Camera(eye=jnp.asarray([0.0, 50.0, 0.1]), target=jnp.zeros(3), up=jnp.asarray([0, 1.0, 0])))
    assert not bool(splat.screen_to_plane(up, 80, 0, 160, 90, plane_y=60.0)[1])  # the ray runs away


def test_spawn_drag_screen_and_render_match_the_jax_simulation():
    from nbx.interactive import Simulation as JaxSimulation

    jsim_ = JaxSimulation(JaxConfig(capacity=16), scenario="collision")
    s = Simulation(SimConfig(capacity=16), scenario="collision", device="cpu")
    jcam, cam = jsplat.Camera.default(), splat.Camera.default("cpu")
    assert s.spawn_drag_screen(cam, 80, 45, 100, 50, 160, 90) == jsim_.spawn_drag_screen(jcam, 80, 45, 100, 50,
                                                                                            160, 90)
    assert_close(s.bodies()["pos"], jsim_.bodies()["pos"], "spawned pos")
    assert_close(s.bodies()["vel"], jsim_.bodies()["vel"], "spawned vel")
    assert_hdr_close(s.render(width=64, height=48), jsim_.render(width=64, height=48), "Simulation.render")


# ---- splats, flashes, tonemap -------------------------------------------------

def test_body_color_and_tonemap():
    rng = np.random.default_rng(0)
    temp = rng.uniform(0, 300, 64).astype(np.float32)
    mat = rng.integers(0, 3, 64).astype(np.int32)
    _, cfg = configs()
    m = cfg.materials
    jm = JaxConfig().materials
    assert_close(colormap.body_color(_t(temp), _t(mat), m.color1, m.color2).numpy(),
                 np.asarray(jcolormap.body_color(temp, mat, jm.color1, jm.color2)), "body_color")
    hdr = np.abs(rng.normal(0, 3, (24, 32, 3))).astype(np.float32) ** 2
    for mode in ("aces", "reinhard"):
        for exposure in (1.0, 1.5, 4.0):
            assert_close(colormap.tonemap(_t(hdr), exposure, mode).numpy(),
                         np.asarray(jcolormap.tonemap(hdr, exposure, mode)), f"tonemap {mode} {exposure}")


def _splat_args(jst, jcfg):
    return (jst.pos, jst.radius(jcfg), jst.temp, jst.mat, jst.alive, jcfg.materials.color1, jcfg.materials.color2)


SPLAT_CAMERAS = {
    "default": lambda c: c,
    "near": lambda c: c.orbit(0.3, 0.25, 0.25),  # wide footprints: the 5x5 and 11x11 tiers
    "side": lambda c: c.orbit(1.2, -0.3, 0.6).pan(0.1, 0.05),
}


@pytest.mark.parametrize("view", list(SPLAT_CAMERAS))
@pytest.mark.parametrize("extras", ["plain", "depth+light"])
def test_splat_bodies_hdr_matches(view, extras):
    jcfg, cfg, jst = _galaxy()
    st = port_state(jst, cfg)
    jcam = SPLAT_CAMERAS[view](jsplat.Camera.default())
    kw, jkw = {}, {}
    if extras != "plain":
        rng = np.random.default_rng(1)
        depth = np.where(rng.uniform(size=(90, 160)) < 0.3, rng.uniform(100, 200, (90, 160)), np.inf)
        gain = rng.uniform(0, 2, 300).astype(np.float32)
        jkw = dict(depth=jnp.asarray(depth, jnp.float32), light_gain=jnp.asarray(gain))
        kw = dict(depth=_t(depth.astype(np.float32)), light_gain=_t(gain))
    want = jsplat.splat_bodies_hdr(*_splat_args(jst, jcfg), jcam, width=160, height=90, **jkw)
    got = splat.splat_bodies_hdr(st.pos, st.radius(cfg), st.temp, st.mat, st.alive, cfg.materials.color1,
                                 cfg.materials.color2, jax_camera(jcam), width=160, height=90, **kw)
    assert_hdr_close(got.numpy(), want, f"splat {view} {extras}")


def test_splat_frame_and_render_state():
    jcfg, cfg, jst = _galaxy()
    st = port_state(jst, cfg)
    want = jsplat.render_state(jst, jcfg, width=64, height=48, exposure=1.5)
    got = splat.render_state(st, cfg, splat.Camera.default("cpu"), width=64, height=48, exposure=1.5)
    assert_hdr_close(got.numpy(), want, "render_state")
    dead = st.replace(alive=torch.zeros_like(st.alive))
    assert float(splat.render_state(dead, cfg, splat.Camera.default("cpu"), width=64, height=48).max()) == 0.0


@pytest.mark.parametrize("with_depth", [False, True])
def test_add_flashes_matches(with_depth):
    rng = np.random.default_rng(2)
    n = 40  # more than a batch of LIGHT_POOL blobs
    fpos = rng.uniform(-40, 40, (n, 3)).astype(np.float32)
    energy = rng.uniform(1, 150, n).astype(np.float32)
    mask = rng.uniform(size=n) < 0.6
    img = np.abs(rng.normal(0, 0.3, (48, 64, 3))).astype(np.float32)
    depth = np.where(rng.uniform(size=(48, 64)) < 0.4, rng.uniform(120, 180, (48, 64)), np.inf).astype(np.float32)
    jcam = jsplat.Camera.default()
    want = jsplat.add_flashes(jnp.asarray(img), fpos, energy, mask, jcam, width=64, height=48,
                              depth=jnp.asarray(depth) if with_depth else None)
    got = splat.add_flashes(_t(img), _t(fpos), _t(energy), _t(mask), jax_camera(jcam), width=64, height=48,
                            depth=_t(depth) if with_depth else None)
    assert_hdr_close(got.numpy(), want, "add_flashes")


# ---- the viewer -----------------------------------------------------------------

def test_png_bytes_and_frames_match(tmp_path):
    rng = np.random.default_rng(6)
    img = rng.uniform(-0.1, 1.1, (18, 32, 3)).astype(np.float32)
    np.testing.assert_array_equal(viewer.to_u8(_t(img)), jviewer.to_u8(img))
    assert viewer.png_bytes(_t(img)) == jviewer.png_bytes(img)
    assert viewer.png_bytes(viewer.to_u8_device(_t(img)), level=1) == jviewer.png_bytes(jviewer.to_u8(img), level=1)
    stack = rng.uniform(0, 1, (3, 8, 12, 3)).astype(np.float32)
    paths = viewer.write_frames(str(tmp_path / "port"), list(_t(stack)))
    jpaths = jviewer.write_frames(str(tmp_path / "jax"), stack)
    assert [os.path.basename(p) for p in paths] == [os.path.basename(p) for p in jpaths]
    for p, q in zip(paths, jpaths):
        assert open(p, "rb").read() == open(q, "rb").read()


def test_trajectory_and_player_match(tmp_path):
    rng = np.random.default_rng(7)
    pos = rng.normal(0, 20, (6, 10, 3)).astype(np.float32)
    rad = rng.uniform(0.5, 2, 10).astype(np.float32)
    temps = rng.uniform(0, 100, (6, 10)).astype(np.float32)
    mats = rng.integers(0, 3, 10).astype(np.int32)
    viewer.record_trajectory(str(tmp_path / "t.json"), _t(pos), _t(rad), _t(temps), _t(mats), stride=2, max_bodies=8)
    jviewer.record_trajectory(str(tmp_path / "j.json"), pos, rad, temps, mats, stride=2, max_bodies=8)
    assert json.load(open(tmp_path / "t.json")) == json.load(open(tmp_path / "j.json"))
    viewer.write_html_player(str(tmp_path / "t.html"), str(tmp_path / "t.json"))
    jviewer.write_html_player(str(tmp_path / "j.html"), str(tmp_path / "t.json"))
    assert open(tmp_path / "t.html").read() == open(tmp_path / "j.html").read()


def test_async_readback_order():
    rb = viewer.AsyncReadback()
    assert rb.push(torch.full((2, 2), 1.0)) is None
    np.testing.assert_array_equal(rb.push(torch.full((2, 2), 2.0)), np.full((2, 2), 1.0))
    np.testing.assert_array_equal(rb.flush(), np.full((2, 2), 2.0))
    assert rb.flush() is None
