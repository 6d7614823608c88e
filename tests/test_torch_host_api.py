"""The port's host API on the CPU: checkpoint (`nbx_torch.checkpoint`),
`interactive.Simulation`, `profiling` and the CLI's `run`, as
tests/test_checkpoint.py, test_interactive.py and test_profiling.py hold the
JAX package's, plus loading a checkpoint `nbx` wrote."""

import glob
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbx import checkpoint as jcheckpoint
from nbx import scene as jscene
from nbx import sim as jsim
from nbx.config import SimConfig as JaxConfig
from nbx_torch import __main__ as cli
from nbx_torch import checkpoint, convert, profiling, scene, sim
from nbx_torch.config import SimConfig
from nbx_torch.interactive import Simulation

torch.set_num_threads(1)

STATE_FIELDS = ("pos", "vel", "acc", "mass", "temp", "mat", "alive", "seq", "next_seq", "step_count", "contact")


def _violent_galaxy():
    """A 20-body galaxy and a head-on pair that meets about frame 7 and
    fractures, so the fracture draws shape the trajectory after it."""
    sc = scene.reference_galaxy(n_disk=20, seed=1)
    pair = dict(pos=[[150, 0, 0], [158, 0, 0.3]], vel=[[20, 0, 0], [-20, 0, 0]], mass=[30.0, 30.0], mat=[0, 0],
                temp=[0.0, 0.0])
    return {k: np.concatenate([sc[k], np.asarray(v, sc[k].dtype)]) for k, v in pair.items()}


def _setup(tmp_path):
    cfg = SimConfig(capacity=48, fracture_threshold=5.0)
    st = scene.make_state(cfg, _violent_galaxy(), "cpu", seed=7)
    for _ in range(5):
        st, _ = sim.step(st, cfg)
    return cfg, st, str(tmp_path / "snap.npz")


def _assert_same_state(a, b):
    for name in STATE_FIELDS:
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


def test_roundtrip_bit_exact(tmp_path):
    cfg, st, path = _setup(tmp_path)
    checkpoint.save_state(path, st, cfg)
    st2, cfg2 = checkpoint.load_state(path, "cpu")
    _assert_same_state(st, st2)
    assert cfg2.replace(materials=None) == cfg.replace(materials=None)
    for name in ("density", "color1", "color2"):
        assert torch.equal(getattr(cfg2.materials, name), getattr(cfg.materials, name))


def test_resume_reproduces_trajectory(tmp_path):
    """Fracture draws included: the generator's state round-trips."""
    cfg, st, path = _setup(tmp_path)
    checkpoint.save_state(path, st, cfg)
    a, fractures = st, 0
    for _ in range(10):
        a, ev = sim.step(a, cfg)
        fractures += int(ev.n_fractures.sum())
    b, cfg2 = checkpoint.load_state(path, "cpu")
    for _ in range(10):
        b, _ = sim.step(b, cfg2)
    assert fractures > 0
    _assert_same_state(a, b)


def test_version_gate(tmp_path):
    cfg, st, path = _setup(tmp_path)
    checkpoint.save_state(path, st, cfg)
    z = dict(np.load(path))
    z["format_version"] = np.int32(99)
    np.savez(path, **z)
    with pytest.raises(ValueError, match="format"):
        checkpoint.load_state(path, "cpu")


def test_generator_device_gate(tmp_path):
    cfg, st, path = _setup(tmp_path)
    checkpoint.save_state(path, st, cfg)
    z = dict(np.load(path))
    z["state.generator_device"] = np.str_("cuda")
    np.savez(path, **z)
    with pytest.raises(ValueError, match="cuda device"):
        checkpoint.load_state(path, "cpu")


def test_loads_a_checkpoint_nbx_wrote(tmp_path):
    """Every array of the JAX package's file but its PRNG key; the
    generator is seeded with `seed`, and the run goes on."""
    jcfg = JaxConfig(capacity=32)
    jst = jscene.make_state(jcfg, jscene.reference_galaxy(n_disk=20, seed=1), key=7)
    for _ in range(3):
        jst, _ = jsim.step(jst, jcfg)
    path = str(tmp_path / "nbx.npz")
    jcheckpoint.save_state(path, jst, jcfg)
    st, cfg = checkpoint.load_state(path, "cpu", seed=5)
    want = convert.state_from_arrays({name: np.asarray(getattr(jst, name)) for name in STATE_FIELDS},
                                     cfg, "cpu", seed=5)
    _assert_same_state(st, want)
    assert cfg.capacity == 32 and cfg.G == float(np.asarray(jcfg.G)) and cfg.dt == float(np.asarray(jcfg.dt))
    assert cfg.collisions is True and cfg.max_fragments == jcfg.max_fragments
    np.testing.assert_array_equal(cfg.materials.density.numpy(), np.asarray(jcfg.materials.density))
    st, _ = sim.step(st, cfg)
    assert int(st.step_count) == int(jst.step_count) + cfg.sub_steps


# --- Simulation: the cases of tests/test_interactive.py ---------------------

def test_lifecycle():
    s = Simulation(SimConfig(capacity=64), scenario="galaxy", n_disk=20, seed=0, device="cpu")
    assert s.n_alive == 21
    s.step(3)
    assert s.n_alive >= 1
    s.reset("collision")
    assert s.n_alive == 2


def test_live_retune_changes_physics():
    s = Simulation(SimConfig(capacity=8, collisions=False), scenario="kepler", device="cpu")
    s.set(G=0.0)
    v0 = s.bodies()["vel"].copy()
    s.step(10)
    np.testing.assert_allclose(s.bodies()["vel"], v0, atol=1e-6)
    s.set(G=0.5)
    s.step(10)
    assert np.abs(s.bodies()["vel"] - v0).max() > 1e-4


def test_spawn_drag_slingshot():
    s = Simulation(SimConfig(capacity=8, collisions=False), scenario="collision", device="cpu")
    s.spawn_drag([0, 0, 0], [10, 0, 0], mass=5.0)
    b = s.bodies()
    np.testing.assert_allclose(b["vel"][-1], [-5.0, 0, 0])
    np.testing.assert_allclose(b["pos"][-1], [0, 0, 0])
    assert b["mass"][-1] == 5.0


def test_spawn_uses_config_mass():
    s = Simulation(SimConfig(capacity=8, spawn_mass=33.0, collisions=False), scenario="collision", device="cpu")
    s.spawn([1, 2, 3], [0, 0, 0])
    assert s.bodies()["mass"][-1] == 33.0


def test_save_load_roundtrip(tmp_path):
    s = Simulation(SimConfig(capacity=16), scenario="galaxy", n_disk=10, seed=2, device="cpu")
    s.step(5)
    p = str(tmp_path / "sim.npz")
    s.save(p)
    s2 = Simulation.load(p, device="cpu")
    np.testing.assert_array_equal(s2.bodies()["pos"], s.bodies()["pos"])
    assert s2.cfg.G == s.cfg.G
    s2.step(2)


def test_measure():
    s = Simulation(SimConfig(capacity=16, collisions=False), scenario="kepler", device="cpu")
    d = s.measure()
    assert np.isfinite(d.kinetic) and np.isfinite(d.potential)
    assert d.n_alive == 2


def test_run_checkpointed_resumes_bitwise(tmp_path):
    """The snapshot of run_checkpointed resumes bit for bit; the config
    fallback of load keeps a state without contact timers stepping."""
    p = str(tmp_path / "run.npz")
    s = Simulation(SimConfig(capacity=48, fracture_threshold=5.0), scenario="galaxy", n_disk=30, seed=4,
                   device="cpu")
    s.run_checkpointed(12, p, every=5)
    assert not glob.glob(str(tmp_path / "*.tmp.npz"))
    s2 = Simulation.load(p, device="cpu")
    s.step(4)
    s2.step(4)
    _assert_same_state(s.state, s2.state)
    s3 = Simulation(SimConfig(capacity=8, collisions=False), scenario="kepler", device="cpu")
    checkpoint.save_state(p, s3.state)  # no config in the file
    s4 = Simulation.load(p, device="cpu")
    assert s4.cfg.collisions is False and s4.cfg.capacity == 8
    s4.step(2)
    with pytest.raises(NotImplementedError, match="ROADMAP item 9"):
        s4.render()


# --- profiling: the cases of tests/test_profiling.py --------------------------

def test_step_timer_percentiles():
    t = profiling.StepTimer()
    for _ in range(20):
        with t:
            pass
    s = t.summary()
    assert s["n"] == 20 and s["p50_ms"] >= 0 and s["p99_ms"] >= s["p50_ms"]


def test_metrics_logger(tmp_path):
    p = str(tmp_path / "m.jsonl")
    with profiling.MetricsLogger(p) as m:
        m.log(0, energy=torch.tensor(1.5), momentum=torch.tensor([1.0, 2, 3]))
        m.log(1, energy=2.5, count=np.int32(3))
    lines = [json.loads(line) for line in open(p)]
    assert lines[0]["step"] == 0 and lines[0]["momentum"] == [1.0, 2.0, 3.0] and lines[0]["energy"] == 1.5
    assert lines[1]["energy"] == 2.5 and lines[1]["count"] == 3


def test_check_finite_raises():
    good = {"a": torch.ones(3), "b": torch.zeros(2), "n": torch.arange(3)}
    profiling.check_finite(good)
    with pytest.raises(FloatingPointError, match="a"):
        profiling.check_finite({"a": torch.tensor([1.0, float("nan")])})
    cfg = SimConfig(capacity=8)
    st = scene.make_state(cfg, scene.head_on_collision(), "cpu")
    profiling.check_finite(st)
    with pytest.raises(FloatingPointError, match=r"state\.vel"):
        profiling.check_finite(st.replace(vel=st.vel / 0.0))
    with pytest.raises(FloatingPointError, match=r"events\[1\]"):
        profiling.check_finite([torch.ones(2), torch.tensor([float("inf")])], name="events")


def test_nan_guard():
    x = torch.tensor(-1.0)
    with profiling.nan_guard():
        assert float(torch.log(-x)) == 0.0  # a clean op passes
        with pytest.raises(FloatingPointError, match="log"):
            torch.log(x) * 1.0
    assert torch.isnan(torch.log(x))  # outside the block NaN propagates silently


def test_trace_writes_profile(tmp_path):
    d = str(tmp_path / "trace")
    with profiling.trace(d):
        _ = torch.arange(1024.0).sum()
    files = glob.glob(d + "/**/*", recursive=True)
    assert any(f.endswith("trace.json") for f in files), files
    assert json.load(open(f"{d}/trace.json"))["traceEvents"]


def test_run_cli_raises_without_a_card(monkeypatch, tmp_path):
    """`python -m nbx_torch run` runs on the card: where torch sees none it
    raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        cli.main(["run", "--frames", "2", "--checkpoint", str(tmp_path / "c.npz")])
    assert not (tmp_path / "c.npz").exists()
