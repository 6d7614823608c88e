"""The port's live viewer server (`nbx_torch.serve`) on the CPU, as
tests/test_serve.py holds the JAX package's: every endpoint of LiveSim's
HTTP layer on a free localhost port; BigLiveSim's frames against the port's
own `granular_full_kdk_scan` (held against the JAX package in
tests/test_torch_collisions_scaled.py), its buckets re-sized after an
overflow; the CLI's `serve` and `demo`."""

import json
import os
import socket
import struct
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

from nbx_torch import __main__ as cli
from nbx_torch.bench.granular import granular_cloud
from nbx_torch.collisions_scaled import granular_full_kdk_scan, make_granular_state
from nbx_torch.config import SimConfig
from nbx_torch.ops.pm import isolated_green_hat
from nbx_torch.serve import BigLiveSim, LiveSim, make_handler

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def server():
    live = LiveSim(SimConfig(capacity=32), scenario="collision", width=160, height=90, fps=30.0,
                   device="cpu").start()
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(live))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    for _ in range(600):
        if live.frame_png or live.n_errors:
            break
        time.sleep(0.05)
    assert live.n_errors == 0, live.first_error
    yield base, live
    assert live.n_errors == 0, live.first_error
    httpd.shutdown()
    live.stop()


def _timed_out(e: Exception) -> bool:
    return isinstance(e, TimeoutError) or (isinstance(e, urllib.error.URLError)
                                          and isinstance(e.reason, (TimeoutError, socket.timeout)))


def _get(url, _tries=3):
    """GET with retries on a timeout, raised as TimeoutError or as a URLError
    whose reason is one (a busy host can starve the HTTP thread)."""
    for i in range(_tries):
        try:
            with urllib.request.urlopen(url, timeout=10) as r:
                return r.status, r.read(), r.headers.get("Content-Type")
        except (TimeoutError, urllib.error.URLError) as e:
            if not _timed_out(e) or i == _tries - 1:
                raise


def _state(base) -> dict:
    s = json.loads(_get(base + "/state")[1])
    assert s["error"] is None and s["n_errors"] == 0, (s["error"], s["first_error"])
    return s


def test_get_retries_timeouts_of_both_kinds(monkeypatch):
    calls = []

    class Reply:
        status = 200
        headers = {"Content-Type": "text/plain"}

        def read(self):
            return b"ok"

        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

    def flaky(url, timeout):
        calls.append(url)
        if len(calls) == 1:
            raise urllib.error.URLError(socket.timeout("timed out"))
        if len(calls) == 2:
            raise TimeoutError("timed out")
        return Reply()

    monkeypatch.setattr(urllib.request, "urlopen", flaky)
    assert _get("http://x/") == (200, b"ok", "text/plain") and len(calls) == 3
    calls.clear()
    monkeypatch.setattr(urllib.request, "urlopen",
                        lambda url, timeout: (_ for _ in ()).throw(urllib.error.URLError("refused")))
    with pytest.raises(urllib.error.URLError):  # not a timeout: no retry
        _get("http://x/")


def test_index_page(server):
    base, _ = server
    code, body, ctype = _get(base + "/")
    assert code == 200 and ctype == "text/html"
    for control in (b"'G','G',0.1,5", b"'spawn_mass','spawnMass',1,5000", b"'bloom_strength','bloomStr',0,3",
                    b"Galaxy", b"Collision", b"drawPreview"):
        assert control in body, control


def test_frame_png_and_stepping(server):
    base, _ = server
    code, body, ctype = _get(base + "/frame.png")
    assert code == 200 and ctype == "image/png" and body[:8] == b"\x89PNG\r\n\x1a\n"
    assert struct.unpack(">II", body[16:24]) == (160, 90)
    s0 = _state(base)
    assert s0["alive"] == 2 and s0["width"] == 160
    deadline = time.time() + 60
    while _state(base)["step"] <= s0["step"] and time.time() < deadline:
        time.sleep(0.1)
    assert _state(base)["step"] > s0["step"]  # the background thread steps


def test_spawn_adds_a_body(server):
    base, _ = server
    before = _state(base)["alive"]
    code, body, _ = _get(base + "/spawn?sx0=80&sy0=50&sx1=90&sy1=50")
    assert code == 200 and json.loads(body) == {"spawned": True, "evicted": False}
    assert _state(base)["alive"] == before + 1


def test_set_changes_g_and_viewer_params(server):
    base, live = server
    _, body, _ = _get(base + "/set?G=2.5&fracture_threshold=42&bloom_strength=2.0&bogus=1")
    assert json.loads(body)["set"] == {"G": 2.5, "fracture_threshold": 42.0, "bloom_strength": 2.0}
    s = _state(base)
    assert s["G"] == 2.5 and s["params"]["fracture_threshold"] == 42.0 and s["params"]["bloom_strength"] == 2.0
    assert live.sim.cfg.G == 2.5 and isinstance(live.sim.cfg.G, float)
    _get(base + "/set?G=0.5&fracture_threshold=25&bloom_strength=1.2")


def test_orbit_and_pan(server):
    base, live = server
    eye0, tgt0 = live.cam.eye.clone(), live.cam.target.clone()
    _get(base + "/orbit?dyaw=0.5&zoom=1.1")
    assert float((live.cam.eye - eye0).abs().max()) > 1.0
    _get(base + "/orbit?panx=0.05&pany=0.02")
    assert float((live.cam.target - tgt0).abs().max()) > 0.5


def test_resize_changes_the_png(server):
    base, live = server
    code, body, _ = _get(base + "/resize?w=128&h=72")
    assert code == 200 and json.loads(body) == {"width": 128, "height": 72}
    deadline = time.time() + 60
    while time.time() < deadline:
        buf = live.frame_png
        if len(buf) > 24 and struct.unpack(">II", buf[16:24]) == (128, 72):
            break
        time.sleep(0.05)
    else:
        raise AssertionError("no frame at the new size")
    live.paused = True
    with live.lock:
        pass
    _get(base + "/resize?w=99999&h=4")
    assert (live.width, live.height) == (1920, 36)  # clamped
    _get(base + "/resize?w=160&h=90")
    live.paused = False


def test_stream_pushes_frames(server):
    base, _ = server
    req = urllib.request.urlopen(base + "/stream", timeout=15)
    assert "multipart/x-mixed-replace" in req.headers.get("Content-Type")
    data = b""
    deadline = time.time() + 30
    while data.count(b"--nbxframe") < 3 and time.time() < deadline:
        data += req.read(4096)
    req.close()
    parts = data.split(b"--nbxframe")
    assert len([p for p in parts if b"\x89PNG" in p]) >= 2
    assert b"Content-Type: image/png" in parts[1]


def test_reset_and_unknown_path(server):
    base, _ = server
    _get(base + "/reset?scenario=galaxy")
    assert _state(base)["alive"] > 2
    _get(base + "/reset?scenario=collision")
    assert _state(base)["alive"] == 2
    with pytest.raises(urllib.error.HTTPError):
        _get(base + "/nope")


def test_a_frame_that_raises_is_counted_and_never_cleared():
    """The loop keeps serving after a frame raises (the reference's
    behaviour): `error` clears with the next good frame, `n_errors` and
    `first_error` stay."""
    live = LiveSim(SimConfig(capacity=32), scenario="collision", width=64, height=48, fps=100.0, device="cpu")
    good, calls = live._advance_and_render, []

    def flaky():
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("frame 2")
        return good()
    live._advance_and_render = flaky
    live.start()
    try:
        deadline = time.time() + 60
        while live.step_count < 3 and time.time() < deadline:
            time.sleep(0.02)
    finally:
        live.stop()
    s = live.stats()
    assert live.step_count >= 3 and s["error"] is None
    assert s["n_errors"] == 1 and s["first_error"] == "RuntimeError: frame 2"


# ---- BigLiveSim --------------------------------------------------------------------

N_BIG, G_BIG, BAND_BIG, PM_BIG = 4096, 8, 2, 16


def test_big_live_sim_resizes_after_an_overflow_and_matches_the_scan():
    """4,096 bodies (g = 8, PM 16^3) on the CPU, its first layout at half the
    block budgets bucketed_layout_for sizes: the first frames overflow, the
    overflow read back a frame late re-sizes the layout once, and every later
    frame counts none. Each frame's state equals the port's
    granular_full_kdk_scan run on the same layouts, bit for bit."""
    box = 100.0 * (N_BIG / 131072.0) ** (1.0 / 3.0)
    pos, vel, mass = granular_cloud(N_BIG, box=box)
    live = BigLiveSim(n=N_BIG, width=64, height=48, pm_grid=PM_BIG, n_cells=G_BIG, band_cells=BAND_BIG, n_trails=32,
                      device="cpu")
    live.buckets = tuple((t, s, max(8, m // 2)) for t, s, m in live.buckets)  # too tight: the first frames overflow
    ref = make_granular_state(pos, vel, mass, seed=0, device="cpu")
    green = isolated_green_hat(box, PM_BIG, device="cpu")
    overflow = []
    for k in range(6):
        img = live._advance_and_render()
        layout = live.buckets  # a re-size takes effect at the start of the frame
        assert img.shape == (48, 64, 3) and img.dtype == torch.uint8
        ref, totals, _ = granular_full_kdk_scan(ref, live.cfg, box, 1, n_cells=G_BIG, band_cells=BAND_BIG,
                                                buckets=layout, force_impl="pm", pm_grid=PM_BIG, log_events=True,
                                                green_hat=green)
        overflow.append(int(totals["n_overflow"]))
        for f in ("pos", "vel", "mass", "mat", "temp", "partner", "contact_t"):
            assert torch.equal(getattr(live.state, f), getattr(ref, f)), (k, f)
    assert overflow[0] > 0 and overflow[-3:] == [0, 0, 0], overflow
    assert live.n_resizes == 1 and live.n_overflow == 0
    s = live.stats()
    assert s["n_overflow"] == 0 and s["n_resizes"] == 1 and s["error"] is None and s["n_errors"] == 0
    assert s["alive"] == N_BIG


def test_big_live_sim_serves_and_takes_the_verbs():
    live = BigLiveSim(n=512, width=64, height=48, force_impl="zero", n_cells=G_BIG, band_cells=BAND_BIG,
                      n_trails=16, device="cpu", fps=30.0).start()
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(live))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        for _ in range(600):
            if live.frame_png or live.n_errors:
                break
            time.sleep(0.05)
        code, body, ctype = _get(base + "/frame.png")
        assert code == 200 and ctype == "image/png" and body[:4] == b"\x89PNG"
        s = _state(base)
        assert s["alive"] == 512 and "n_bounces" in s and "n_resizes" in s
        _get(base + "/set?G=1.25&bloom_strength=0.7")
        assert abs(live.cfg.G - 1.25) < 1e-6 and abs(live.bloom_strength - 0.7) < 1e-6
        code, body, _ = _get(base + "/spawn?sx0=20&sy0=20&sx1=30&sy1=25")
        out = json.loads(body)
        assert code == 200 and out["spawned"] in (0, 1) and out["evicted"] == 0
        _get(base + "/orbit?dyaw=0.1&zoom=1.1")
        assert _get(base + "/reset?scenario=disk")[0] == 200
        assert _state(base)["error"] is None
        assert live.n_errors == 0, live.first_error
    finally:
        httpd.shutdown()
        live.stop()


# ---- the CLI -------------------------------------------------------------------------

def test_cli_serve_and_demo_refuse_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        cli.main(["serve", "--big"])
    with pytest.raises(RuntimeError, match="CUDA device"):
        cli.main(["demo", "galaxy", "4", str(tmp_path)])
    assert not os.listdir(tmp_path)


def test_cli_demo_galaxy_on_the_cpu(tmp_path):
    """`demo galaxy 12 <dir>` writes every fourth frame (3 PNGs of 640x360),
    the trajectory and the HTML player."""
    out = str(tmp_path / "galaxy")
    assert cli.main(["demo", "galaxy", "12", out, "--device", "cpu"]) == 0
    pngs = sorted(f for f in os.listdir(out) if f.endswith(".png"))
    assert pngs == ["frame_00000.png", "frame_00001.png", "frame_00002.png"]
    for f in pngs:
        body = open(os.path.join(out, f), "rb").read()
        assert body[:8] == b"\x89PNG\r\n\x1a\n" and struct.unpack(">II", body[16:24]) == (640, 360)
    traj = json.load(open(os.path.join(out, "trajectory.json")))
    assert len(traj["pos"]) == 6 and len(traj["pos"][0]) == 300
    assert "DATA = {" in open(os.path.join(out, "player.html")).read()
    assert np.isfinite(np.asarray(traj["pos"], np.float64)).all()
