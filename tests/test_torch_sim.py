"""The port's frame step against the JAX package's, frame by frame, and
against the NumPy oracle of the reference semantics (tests/oracle.py).

- collisions off: nbx_torch.sim.step vs nbx.sim.step, dense (capacity 64)
  and row-blocked (capacity 2304, above sim._DENSE_MAX);
- collisions on: substep by substep, with the fracture uniforms rebuilt from
  the JAX state's key and injected through `draws=`;
- the three oracle scenes of tests/test_parity.py at that file's tolerances;
- diagnostics through sim.run's hook vs nbx.diagnostics.run_logged.

Slots, insertion order and event counts must match exactly; floats to 1e-5
of each field's largest magnitude."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle as orc
from nbx import diagnostics as jdiag
from nbx import scene as jscene
from nbx import sim as jsim
from nbx.config import SimConfig as JaxConfig
from nbx_torch import diagnostics, scene, sim
from nbx_torch.config import SimConfig
from nbx_torch.state import compact_arrays
from torch_parity import (
    EVENT_COUNTS, assert_close, assert_events_match, assert_state_matches,
    jax_draws, port_state,
)

torch.set_num_threads(1)

_jax_substep = jax.jit(jsim.substep, static_argnames=("force_impl", "collision_impl"))


def _galaxy_with_impacts():
    """The reference galaxy (40-body disk) plus three far pairs on collision
    course: one fractures, one merges, one bounces."""
    sc = jscene.reference_galaxy(n_disk=40, seed=7)

    def pair(center, m, speed, gap):
        r = (3.0 * m / (4.0 * np.pi)) ** (1.0 / 3.0)
        c = np.asarray(center, np.float32)
        e = np.array([1.0, 0.0, 0.0], np.float32)
        return [c - gap * r * e, c + gap * r * e], [speed * e, -speed * e], [m, m]

    extra = [pair((200, 0, 0), 20.0, 10.0, 0.95), pair((0, 200, 0), 5.0, 0.1, 0.8),
             pair((-200, 0, 0), 5.0, 3.0, 0.95)]
    for p, v, m in extra:
        sc["pos"] = np.concatenate([sc["pos"], np.asarray(p, np.float32)])
        sc["vel"] = np.concatenate([sc["vel"], np.asarray(v, np.float32)])
        sc["mass"] = np.concatenate([sc["mass"], np.asarray(m, np.float32)])
        sc["mat"] = np.concatenate([sc["mat"], np.zeros(2, np.int32)])
        sc["temp"] = np.concatenate([sc["temp"], np.zeros(2, np.float32)])
    return sc


@pytest.mark.parametrize(
    "capacity,n_disk,frames", [(64, 40, 20), (2304, 2000, 3)], ids=["dense", "blocked"]
)
def test_step_matches_jax_gravity_only(capacity, n_disk, frames):
    sc = jscene.reference_galaxy(n_disk=n_disk, seed=7)
    jcfg = JaxConfig(capacity=capacity, collisions=False)
    cfg = SimConfig(capacity=capacity, collisions=False)
    jst = jscene.make_state(jcfg, sc)
    st = scene.make_state(cfg, sc, "cpu")
    for _ in range(frames):
        jst, jev = jsim.step(jst, jcfg)
        st, ev = sim.step(st, cfg)
        assert_state_matches(st, jst)
        assert_events_match(ev, jev)


def test_substeps_match_jax_full_physics():
    """20 frames of full physics with injected fracture draws."""
    sc = _galaxy_with_impacts()
    kw = dict(capacity=64, merge_time=0.02, fracture_threshold=5.0)
    jcfg, cfg = JaxConfig(**kw), SimConfig(**kw)
    jst = jscene.make_state(jcfg, sc, 11)
    st = port_state(jst, cfg)
    h = sim.substep_size(cfg)
    jh = jnp.float32(jcfg.dt) / jcfg.sub_steps
    assert float(jh) == h
    totals = dict.fromkeys(EVENT_COUNTS, 0)
    for _ in range(20 * cfg.sub_steps):
        draws = jax_draws(jst.key, jcfg)
        jst, jev = _jax_substep(jst, jcfg, jh)
        st, ev = sim.substep(st, cfg, h, draws=draws)
        assert_state_matches(st, jst)
        assert_events_match(ev, jev)
        for k in totals:
            totals[k] += int(getattr(ev, k))
    for k in ("n_merges", "n_fractures", "n_bounces"):
        assert totals[k] > 0, totals


def test_gravity_dispatch_on_cpu():
    rng = np.random.default_rng(0)
    for n in (2048, 2304):
        pos = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32) * 20)
        mass = torch.from_numpy(rng.uniform(0.5, 2.0, n).astype(np.float32))
        auto = sim.gravity(pos, mass, 0.5, 0.5)
        want = "dense" if n <= sim._DENSE_MAX else "blocked"
        torch.testing.assert_close(auto, sim.gravity(pos, mass, 0.5, 0.5, want), rtol=0, atol=0)
        assert_close(sim.gravity(pos, mass, 0.5, 0.5, "pairwise").numpy(), auto.numpy(), "pairwise")
    with pytest.raises(ValueError):
        sim.gravity(pos, mass, 0.5, 0.5, "pallas")


# --- the oracle scenes of tests/test_parity.py, at its tolerances ----------

def _run_port(sc, cfg, n_frames, seed=0):
    st = scene.make_state(cfg, sc, "cpu", seed=seed)
    for _ in range(n_frames):
        st, _ = sim.step(st, cfg)
    return st


def _run_oracle(sc, cfg, n_frames):
    sys_ = orc.from_scene(
        sc, G=cfg.G, softening=cfg.softening, max_bodies=cfg.capacity,
        fracture_threshold=cfg.fracture_threshold, min_fragment_mass=cfg.min_fragment_mass,
        merge_time=cfg.merge_time, heat_decay=cfg.heat_decay,
    )
    h = cfg.dt / cfg.sub_steps
    for _ in range(n_frames * cfg.sub_steps):
        sys_.integrate(h)
    return sys_


def test_oracle_galaxy_gravity_parity():
    sc = scene.reference_galaxy(n_disk=40, seed=7)
    cfg = SimConfig(capacity=64, collisions=False)
    got = compact_arrays(_run_port(sc, cfg, 40))
    ref = _run_oracle(sc, cfg, 40)
    np.testing.assert_allclose(got["pos"], ref.pos_array(), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(got["vel"], ref.vel_array(), rtol=1e-3, atol=1e-3)


def test_oracle_collision_bounce_parity():
    sc = scene.head_on_collision()
    sc["pos"][:, 0] = [-4, 4]
    sc["pos"][:, 2] = [0, 2]
    cfg = SimConfig(capacity=16, merge_time=1e9, fracture_threshold=1e9)
    st = _run_port(sc, cfg, 120)
    ref = _run_oracle(sc, cfg, 120)
    got = compact_arrays(st)
    assert len(ref.bodies) == 2 and int(st.n_alive) == 2
    assert ref.events["bounces"] > 0
    np.testing.assert_allclose(got["pos"], ref.pos_array(), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(got["vel"], ref.vel_array(), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(got["temp"], ref.temp_array(), rtol=1e-3, atol=1e-3)


def test_oracle_merge_parity():
    sc = scene.head_on_collision()
    sc["pos"][:, 0] = [-4, 4]
    sc["pos"][:, 2] = [0, 0]
    sc["vel"][:, 0] = [0.2, -0.2]
    cfg = SimConfig(capacity=16, merge_time=0.005, fracture_threshold=1e9)
    st = _run_port(sc, cfg, 200)
    ref = _run_oracle(sc, cfg, 200)
    got = compact_arrays(st)
    assert len(ref.bodies) == 1 and int(st.n_alive) == 1
    assert ref.events["merges"] == 1
    np.testing.assert_allclose(got["mass"], ref.mass_array(), rtol=1e-5)
    np.testing.assert_allclose(got["pos"], ref.pos_array(), rtol=5e-3, atol=5e-3)
    np.testing.assert_allclose(got["vel"], ref.vel_array(), atol=1e-4)
    np.testing.assert_allclose(got["temp"], ref.temp_array(), rtol=1e-2)


def test_galaxy_full_physics_runs():
    """Full physics with the state's own generator: stays finite and within
    capacity (tests/test_parity.py's run check)."""
    sc = scene.reference_galaxy(n_disk=60, seed=3)
    cfg = SimConfig(capacity=100)
    st, evs = sim.run(scene.make_state(cfg, sc, "cpu", seed=42), cfg, 30)
    assert evs.n_bounces.shape == (30, cfg.sub_steps)
    assert 1 <= int(st.n_alive) <= cfg.capacity
    assert torch.isfinite(st.pos).all() and torch.isfinite(st.vel).all()
    assert int(st.step_count) == 30 * cfg.sub_steps


def test_run_logged_matches_jax(tmp_path):
    """sim.run's diagnostics hook: per-frame energies, momenta and counts."""
    sc = jscene.reference_galaxy(n_disk=40, seed=5)
    jcfg, cfg = JaxConfig(capacity=48, collisions=False), SimConfig(capacity=48, collisions=False)
    jst, jd = jdiag.run_logged(jscene.make_state(jcfg, sc), jcfg, 8)
    path = tmp_path / "diag.jsonl"
    st, d = diagnostics.run_logged(scene.make_state(cfg, sc, "cpu"), cfg, 8, str(path))
    assert_state_matches(st, jst)
    for name in ("kinetic", "potential", "momentum", "angular_momentum", "total_mass", "max_temp"):
        assert_close(getattr(d, name).numpy(), getattr(jd, name), name)
    np.testing.assert_array_equal(d.n_alive.numpy(), np.asarray(jd.n_alive))
    # Both drifts are float32 rounding noise (~1e-6); each energy agrees to
    # 1e-5 of |E|, so the drifts agree to 2e-5.
    drift, jdrift = float(diagnostics.relative_energy_drift(d)), float(jdiag.relative_energy_drift(jd))
    assert abs(drift - jdrift) <= 2e-5
    lines = [json.loads(s) for s in path.read_text().splitlines()]
    assert [r["step"] for r in lines] == list(range(8))
    assert lines[-1]["energy"] == pytest.approx(lines[-1]["kinetic"] + lines[-1]["potential"])

    m = diagnostics.measure_arrays(st.pos, st.vel, st.mass, cfg.G, cfg.softening, block=16)
    jm = jdiag.measure_arrays(jst.pos, jst.vel, jst.mass, jcfg.G, jcfg.softening, block=16)
    for name in ("kinetic", "potential", "momentum", "angular_momentum", "n_alive"):
        assert_close(getattr(m, name).numpy(), getattr(jm, name), name)


def test_import_leaves_out_jax_and_nbx():
    """The port imports neither jax nor the JAX package."""
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import nbx_torch, nbx_torch.sim, nbx_torch.scene, nbx_torch.diagnostics, "
        "nbx_torch.convert, nbx_torch.ops.pairwise, nbx_torch.ops._build, nbx_torch.ops.sequential, "
        "nbx_torch.ops.p3m, nbx_torch.checkpoint, nbx_torch.interactive, nbx_torch.profiling, "
        "nbx_torch.__main__, nbx_torch.bench.p3m_cluster\n"
        "new = set(sys.modules) - before\n"
        "bad = sorted(m for m in new if m.split('.')[0] in ('jax', 'jaxlib', 'nbx'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=repo,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
