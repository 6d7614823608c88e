"""The port's gravity-only benchmarks (nbx_torch.bench.drift, latency,
throughput and `python -m nbx_torch bench ...`) against nbx.bench's, on the
CPU, and their refusal to run on the CPU unless asked.

The JAX drift gate runs its Pallas kernels in interpret mode; latency and
throughput take the JAX package's precision "jnp", the blocked dense sum,
which is what the port's `pairwise_acc` computes on a CPU tensor. Tolerance:
1e-5 of the largest magnitude (float32 sums in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbx import scene as jscene
from nbx.bench import drift as jdrift
from nbx.bench import latency as jlatency
from nbx.bench import throughput as jthroughput
from nbx_torch import __main__ as cli
from nbx_torch.bench import cvt_rate, drift, latency, throughput

torch.set_num_threads(1)

TOL = 1e-5


def _assert_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err < TOL, err


def test_gate_scene_is_the_jax_gates():
    """The Plummer sphere, softening and step of nbx.bench.drift.main."""
    pos, vel, mass, G, eps, h = drift.gate_scene(512, device="cpu")
    sc = jscene.plummer(n=512, total_mass=512.0, scale_radius=10.0, G=1.0, seed=0)
    for got, k in ((pos, "pos"), (vel, "vel"), (mass, "mass")):
        np.testing.assert_array_equal(got.numpy(), sc[k])
    assert (G, eps, h) == (1.0, 10.0 * 512 ** (-1 / 3), float(np.sqrt(10.0**3 / 512)) / 200.0)


@pytest.mark.parametrize("compensated", [True, False])
def test_drift_run_matches_jax(compensated):
    """N = 128, 100 steps, energies every 50: the energies and the final
    state of JAX's drift_run (K1 and K3 interpreted) and the port's."""
    pos, vel, mass, G, eps, h = drift.gate_scene(128, device="cpu")
    jp, jv, je = jdrift.drift_run(jnp.asarray(pos.numpy()), jnp.asarray(vel.numpy()), jnp.asarray(mass.numpy()),
                                  G, eps, h, 100, 50, interpret=True, compensated=compensated)
    p, v, e = drift.drift_run(pos, vel, mass, G, eps, h, 100, 50, compensated=compensated)
    assert e.shape == (3,)
    _assert_close(e.numpy(), je)
    _assert_close(p.numpy(), jp)
    _assert_close(v.numpy(), jv)
    assert drift.relative_drift(e) < drift.GATE


def test_drift_main_on_the_cpu():
    """The result dict of the JAX main, with the device named."""
    r = drift.main(n=128, n_steps=100, diag_every=50, device="cpu")
    assert r["metric"] == "relative_energy_drift_100_steps" and r["pass"] and r["device"] == "cpu"
    assert r["value"] < r["gate"] == 1e-4 and r["steps"] == 100


def _latency_inputs(n=128):
    sc = jscene.plummer(n=n, total_mass=float(n), scale_radius=10.0, seed=0)
    return sc["pos"], sc["vel"], sc["mass"]


@pytest.mark.parametrize("warm", [False, True])
def test_kdk_scan_matches_jax(warm):
    pos, vel, mass = _latency_inputs()
    acc0 = np.random.default_rng(0).normal(size=pos.shape).astype(np.float32) if warm else None
    want = jlatency.kdk_scan(jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(mass), 1.0, 0.1, 1e-2, 10,
                             precision="jnp", acc0=None if acc0 is None else jnp.asarray(acc0))
    got = latency.kdk_scan(torch.from_numpy(pos), torch.from_numpy(vel), torch.from_numpy(mass), 1.0, 0.1, 1e-2,
                           10, acc0=None if acc0 is None else torch.from_numpy(acc0))
    for g, w in zip(got, want):
        _assert_close(g.numpy(), w)


def test_chained_force_evals_match_jax():
    pos, _, mass = _latency_inputs()
    want = jthroughput.chained_force_evals(jnp.asarray(pos), jnp.asarray(mass), 0.5, 0.5, 5, precision="jnp")
    got = throughput.chained_force_evals(torch.from_numpy(pos), torch.from_numpy(mass), 0.5, 0.5, 5)
    _assert_close(got.numpy(), want)


def test_latency_and_throughput_mains_on_the_cpu():
    out = latency.main(reps=3, ns=(64, 128), device="cpu")
    assert set(out) == {64, 128} and all(ms > 0 for ms in out.values())
    assert throughput.main(n=256, reps=2, device="cpu") > 0


@pytest.mark.parametrize("which", ["drift", "latency", "throughput"])
def test_cli_raises_without_a_card(monkeypatch, which):
    """`python -m nbx_torch bench ...` runs on the card: where torch sees
    none it raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = {"drift": ["128", "100"], "latency": ["2"], "throughput": ["128", "2"]}[which]
    with pytest.raises(RuntimeError, match="CUDA device"):
        cli.main(["bench", which, *args])


def test_cvt_rate_raises_without_a_card(monkeypatch):
    """The conversion loop (`python -m nbx_torch.bench.cvt_rate`) measures
    the card: where torch sees none it raises before it builds anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        cvt_rate.main(2)


@pytest.mark.parametrize("main", [drift.main, throughput.main])
def test_other_precisions_wait_for_their_kernels(main):
    """A precision that no kernel computes raises ValueError before anything
    runs, also at the end of a list. (Until K1c was ported, "mxu" raised
    NotImplementedError here.)"""
    for bad in ("tf32", "f32r,tf32"):
        with pytest.raises(ValueError, match="precision"):
            main(128, 10, bad, device="cpu")
