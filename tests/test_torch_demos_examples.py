"""The ports of examples/granular_demo.py, orbit_movie.py, spatial_demo.py
and merger_full.py (`python -m nbx_torch demo granular|orbit|spatial|
merger_full`) on the CPU: each starts from the example's setup (the disk
arrays, the camera path, the cloud and the step's parameters, the merger's
grid, band, buckets and P3M tune; the JAX package's functions where the
example calls them, the example's own lines where it builds them inline),
runs at a tiny size and writes its PNGs; the CLI refuses each without a
card."""

import importlib.util
import json
import math
import os
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbx import scene as jscene
from nbx.config import SimConfig as JaxConfig
from nbx.config import body_radius as jax_body_radius
from nbx.ops.collide import bucketed_layout_for as jax_bucketed_layout_for
from nbx.ops.p3m import p3m_tune_for as jax_p3m_tune_for
from nbx.render.campath import orbit_path as jax_orbit_path
from nbx.render.splat import Camera as JaxCamera
from nbx_torch import __main__ as cli
from nbx_torch.bench import granular
from nbx_torch.demos import merger_full, orbit, spatial

torch.set_num_threads(1)

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"


def _example(name):
    spec = importlib.util.spec_from_file_location(f"example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _source(name):
    return (EXAMPLES / f"{name}.py").read_text()


def _pngs(d):
    return sorted(p for p in os.listdir(d) if p.endswith(".png"))


# ---- setups --------------------------------------------------------------------


def test_granular_disk_is_the_examples():
    """demo_state(n): the example's debris_disk(n - 1) with its hot core."""
    n = 512
    pos, vel, mass = _example("granular_demo").debris_disk(n - 1)
    st = granular.demo_state(n, device="cpu")
    np.testing.assert_array_equal(st.pos.numpy(), pos)
    np.testing.assert_array_equal(st.vel.numpy(), vel)
    np.testing.assert_array_equal(st.mass.numpy(), mass)
    want_temp = np.zeros(n, np.float32)
    want_temp[0] = 1000.0
    np.testing.assert_array_equal(st.temp.numpy(), want_temp)
    assert granular.DEMO_LAYOUT == dict(n_cells=28, max_per_cell=12, band_cells=6, force_impl="auto")
    assert granular.DEMO_STEPS_PER_FRAME == 4


def test_orbit_camera_path_is_the_examples():
    n = 7
    want = list(jax_orbit_path(JaxCamera.default(), n, d_yaw=1.5 * np.pi, d_pitch=-0.25, zoom=0.45, ease=True))
    got = orbit.cameras(n, "cpu")
    assert len(got) == len(want) == n
    for g, w in zip(got, want):
        for f in ("eye", "target", "up"):
            np.testing.assert_allclose(getattr(g, f).numpy(), np.asarray(getattr(w, f)), rtol=0, atol=1e-4)
        assert g.fov_deg == w.fov_deg


def test_orbit_events_flatten_every_substep():
    from nbx_torch import scene, sim
    from nbx_torch.config import SimConfig

    cfg = SimConfig(sub_steps=2)
    st = scene.make_state(cfg, scene.reference_galaxy(seed=0), "cpu", seed=0)
    _, evs = sim.run(st, cfg, 3)
    flat = orbit.flatten_events(evs)
    assert evs.merge_pos.shape[:2] == (3, 2) and flat.merge_pos.shape[0] == 6
    assert torch.equal(flat.merge_mask[2:4], evs.merge_mask[1])
    assert torch.equal(flat.n_bounces, evs.n_bounces.reshape(-1))


@pytest.mark.parametrize("n,d", [(8192, 1), (512, 1), (8192, 8), (4096, 3)])
def test_spatial_setup_is_the_examples(n, d):
    """The cloud and the step's parameters, from the example's own lines."""
    src = _source("spatial_demo")
    body = src[src.index("    rng = np.random.default_rng(0)\n"):src.index("\n    cfg = SimConfig(")]
    ns = {"np": np, "n": n}
    exec("\n".join(line[4:] for line in body.splitlines()), ns)
    for got, want in zip(spatial.cloud(n), (ns["pos"], ns["vel"], ns["mass"])):
        np.testing.assert_array_equal(got, want)
    ns = {"math": math, "n": n, "d": d}
    exec(re.search(r"\n    (g = 16 \* d // .*)\n", src).group(1), ns)
    caps = re.search(r"halo_cap=(.*), mig_cap=(.*),\n", src)
    want = dict(n_cells=ns["g"], band_cells=4, packed_caps=(96, 256), halo_cap=eval(caps.group(1), ns),
                mig_cap=eval(caps.group(2), ns), force_impl="pm", pm_grid=64)
    assert spatial.layout(n, d) == want
    assert "band_cells=4, packed_caps=(96, 256)" in src and 'force_impl="pm", pm_grid=64' in src
    assert dict(G=0.5, dt=0.016, sub_steps=1, merge_time=0.1, fracture_threshold=6.0).items() <= \
        vars(spatial.config()).items()


@pytest.fixture(scope="module")
def merger_2048():
    return merger_full.merger_setup("cpu", 2048)


def test_merger_full_setup_is_the_examples(merger_2048):
    """The P3M tune and the buckets are the JAX package's on the same
    scene; the grid is the example's rule without its clamp at 64."""
    st, cfg, box, kw = merger_2048
    sc, jbox = jscene.galaxy_merger_3d(n=2048, seed=0)
    assert box == jbox
    np.testing.assert_array_equal(st.pos.numpy(), sc["pos"])
    want_tune = jax_p3m_tune_for(sc["pos"], box, residual_budget=131072, affected_budget=2048, k_max=1536)
    assert kw["p3m"] == want_tune
    assert kw["pm_grid"] == want_tune["g"]
    jcfg = JaxConfig(G=0.5, dt=0.35, sub_steps=1, softening=0.5, merge_time=0.5, fracture_threshold=25.0,
                     max_fractures=32)
    for f, v in merger_full.MERGER_CFG.items():
        assert getattr(cfg, f) == getattr(jcfg, f)
    r_max = float(np.max(np.asarray(jax_body_radius(jnp.asarray(sc["mass"]), jnp.asarray(sc["mat"]),
                                                    jcfg.materials))))
    src = _source("merger_full")
    assert "g_c = min(64, int(box / (2.2 * r_max)))" in src
    unclamped = int(box / (2.2 * r_max))
    unclamped = max(8, unclamped - unclamped % 2)
    assert (kw["n_cells"], kw["band_cells"]) == (unclamped, 8 if unclamped >= 16 else 2)
    assert kw["buckets"] == jax_bucketed_layout_for(sc["pos"], box, kw["n_cells"], kw["band_cells"])


# ---- the demos at a tiny size on the CPU ------------------------------------------


def test_demo_granular_writes_frames(tmp_path, capsys):
    out = str(tmp_path / "granular")
    assert cli.main(["demo", "granular", "512", "2", out, "--device", "cpu"]) == 0
    pngs = _pngs(out)
    assert len(pngs) == 2 and min(os.path.getsize(os.path.join(out, p)) for p in pngs) > 1000
    assert "2 frames x 4 steps at N=512" in capsys.readouterr().out


def test_demo_orbit_writes_frames(tmp_path):
    out = str(tmp_path / "orbit")
    assert cli.main(["demo", "orbit", "2", out, "--device", "cpu"]) == 0
    pngs = _pngs(out)
    assert len(pngs) == 2 and min(os.path.getsize(os.path.join(out, p)) for p in pngs) > 1000


def test_demo_spatial_writes_the_strip(tmp_path):
    """4 steps at n = 512 in a gloo group of this process alone: a
    snapshot each step, four side by side."""
    import torch.distributed as dist

    out = str(tmp_path / "spatial")
    assert cli.main(["demo", "spatial", "512", "4", out, "--device", "cpu"]) == 0
    assert not dist.is_initialized()
    assert _pngs(out) == ["spatial_strip.png"]
    png = (Path(out) / "spatial_strip.png").read_bytes()
    assert png[:8] == b"\x89PNG\r\n\x1a\n" and int.from_bytes(png[16:20], "big") == 4 * 480


def test_demo_merger_full_writes_a_frame(tmp_path, capsys):
    out = str(tmp_path / "merger_full")
    assert cli.main(["demo", "merger_full", "2048", "1", out, "--device", "cpu"]) == 0
    assert len(_pngs(out)) == 1
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    keys = {"n", "n_frames", "steps_per_frame", "box", "p3m", "collisions", "ms_per_step_p50",
            "ms_per_render_p50", "s_per_frame_p50", "wall_s", "n_overflow_max", "n_uncorrected_max",
            "n_bounces", "n_merges", "n_fractures", "n_dropped"}
    assert keys <= set(res) and res["n"] == 2048 and res["device"] == "cpu"
    assert res["n_uncorrected_max"] == 0


@pytest.mark.parametrize("which", ["granular", "orbit", "spatial", "merger_full"])
def test_cli_demo_refuses_without_a_card(monkeypatch, tmp_path, which):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        cli.main(["demo", which, "2", str(tmp_path)])
    assert not os.listdir(tmp_path)


def test_new_modules_leave_out_jax_and_nbx():
    """The modules of this round import neither jax nor the JAX package."""
    import subprocess
    import sys

    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import nbx_torch.collisions_binned, nbx_torch.bench.microops, nbx_torch.demos.granular, "
        "nbx_torch.demos.orbit, nbx_torch.demos.spatial, nbx_torch.demos.merger_full\n"
        "bad = sorted(m for m in set(sys.modules) - before if m.split('.')[0] in ('jax', 'jaxlib', 'nbx'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    repo = str(EXAMPLES.parent)
    out = subprocess.run([sys.executable, "-c", code], env=dict(os.environ, PYTHONPATH=repo), cwd=repo,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
