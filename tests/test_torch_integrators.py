"""nbx_torch.integrators against nbx.integrators, and the integrator gates of
tests/test_integrators.py on the port alone.

The parity tests run both packages in float64 (JAX under jax_enable_x64, the
fixture below, switched back off after each test) with each package's dense
forces, from the same numpy inputs: 1e-12 relative to each field's largest
magnitude, the two differing only in float64 rounding. Softening 0.5 and 0
square exactly, so the port's float32-rounded eps^2 (`forces.eps2_of`) is
the JAX package's float64 one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbx import forces as jforces
from nbx import integrators as jint
from nbx_torch import convert, forces, integrators, scene

torch.set_num_threads(1)

F64_TOL = 1e-12
G, EPS = 0.5, 0.5


@pytest.fixture(autouse=True)
def _x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _bodies(n=16, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(0, 5, (n, 3)), rng.normal(0, 1, (n, 3)), rng.uniform(1, 3, n)


def _both(pos, vel, mass):
    """(JAX arrays, port tensors) of the same float64 numpy inputs."""
    j = tuple(jnp.asarray(x, jnp.float64) for x in (pos, vel, mass))
    t = tuple(torch.tensor(x, dtype=torch.float64) for x in (pos, vel, mass))
    return j, t


def _assert_close(got, want, tol=F64_TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype == np.float64
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)
    assert err < tol, err


def _assert_states_close(port_state, jax_state):
    arrays = convert.phase_state_to_arrays(port_state)
    for name, want in jax_state._asdict().items():
        _assert_close(arrays[name], want)


@pytest.mark.parametrize("n_steps", [1, 200])
@pytest.mark.parametrize("method", list(integrators.STEPPERS))
def test_steppers_match_jax(method, n_steps):
    (jp, jv, jm), (tp, tv, tm) = _both(*_bodies(seed=1))
    jf = lambda p: jforces.accelerations(p, jm, G, EPS)  # noqa: E731
    tf = lambda p: forces.accelerations(p, tm, G, EPS)  # noqa: E731
    js, jes = jint.run(jint.init_phase(jp, jv, jf), 0.01, n_steps, jf, method=method,
                       diagnostics=lambda s: jforces.kinetic_energy(s.vel, jm))
    ts, tes = integrators.run(integrators.init_phase(tp, tv, tf), 0.01, n_steps, tf, method=method,
                              diagnostics=lambda s: forces.kinetic_energy(s.vel, tm))
    _assert_states_close(ts, js)
    _assert_close(tes.numpy(), jes)
    if n_steps == 1:  # the stepper itself, from a reference-style cold start (acc = 0)
        one = integrators.STEPPERS[method](integrators.init_phase(tp, tv), 0.01, tf)
        _assert_states_close(one, getattr(jint, integrators.STEPPERS[method].__name__)(
            jint.init_phase(jp, jv), 0.01, jf))


def test_compensated_run_matches_jax():
    (jp, jv, jm), (tp, tv, tm) = _both(*_bodies(seed=2))
    jf = lambda p: jforces.accelerations(p, jm, G, EPS)  # noqa: E731
    tf = lambda p: forces.accelerations(p, tm, G, EPS)  # noqa: E731
    js, jes = jint.run(jint.init_phase(jp, jv, jf), 0.01, 200, jf, compensated=True,
                       diagnostics=lambda s: jforces.kinetic_energy(s.vel, jm))
    ts, tes = integrators.run(integrators.init_phase(tp, tv, tf), 0.01, 200, tf, compensated=True,
                              diagnostics=lambda s: forces.kinetic_energy(s.vel, tm))
    _assert_states_close(ts, js)
    _assert_close(tes.numpy(), jes)
    with pytest.raises(ValueError, match="kdk only"):
        integrators.run(ts, 0.01, 1, tf, method="dkd", compensated=True)


def test_hermite_matches_jax():
    (jp, jv, jm), (tp, tv, tm) = _both(*_bodies(seed=3))
    jfj = lambda p, v: jforces.acc_and_jerk(p, jm, v, G, EPS)  # noqa: E731
    tfj = lambda p, v: forces.acc_and_jerk(p, tm, v, G, EPS)  # noqa: E731
    js0, ts0 = jint.init_hermite(jp, jv, jfj), integrators.init_hermite(tp, tv, tfj)
    _assert_states_close(ts0, js0)
    _assert_states_close(integrators.hermite_step(ts0, 0.01, tfj), jint.hermite_step(js0, 0.01, jfj))
    js, jes = jint.run_hermite(js0, 0.01, 200, jfj, diagnostics=lambda s: jforces.kinetic_energy(s.vel, jm))
    ts, tes = integrators.run_hermite(ts0, 0.01, 200, tfj, diagnostics=lambda s: forces.kinetic_energy(s.vel, tm))
    _assert_states_close(ts, js)
    _assert_close(tes.numpy(), jes)
    assert integrators.run_hermite(ts0, 0.01, 3, tfj)[1] is None


def test_states_carry_over_from_jax():
    """convert's integrator states keep the JAX states' values and dtypes."""
    (jp, jv, jm), _ = _both(*_bodies(seed=4))
    jfj = lambda p, v: jforces.acc_and_jerk(p, jm, v, G, EPS)  # noqa: E731
    jh = jint.init_hermite(jp, jv, jfj)
    arrays = {k: np.asarray(v) for k, v in jh._asdict().items()}
    th = convert.hermite_state_from_arrays(arrays, "cpu")
    assert isinstance(th, integrators.HermiteState) and th.pos.dtype == torch.float64
    back = convert.hermite_state_to_arrays(th)
    for k in arrays:
        np.testing.assert_array_equal(back[k], arrays[k])
    ph = convert.phase_state_from_arrays({k: arrays[k].astype(np.float32) for k in ("pos", "vel", "acc")}, "cpu")
    assert isinstance(ph, integrators.PhaseState) and ph.acc.dtype == torch.float32
    np.testing.assert_array_equal(convert.phase_state_to_arrays(ph)["vel"], arrays["vel"].astype(np.float32))


# ---- the gates of tests/test_integrators.py, on the port alone ---------------------


def _kepler(e=0.0):
    sc = scene.kepler_two_body(m1=1000.0, m2=1.0, a=50.0, e=e, G=0.5)
    return tuple(torch.tensor(sc[k], dtype=torch.float64) for k in ("pos", "vel", "mass"))


def _energy(pos, vel, mass, G_=0.5):
    return forces.kinetic_energy(vel, mass) + forces.potential_energy(pos, mass, G_, 0.0)


def _max_drift(es, e0):
    return float(((es - e0).abs() / abs(e0)).max())


def test_kepler_period():
    """After one analytic period T = 2 pi sqrt(a^3 / GM) the separation
    returns to its start (circular orbit, eps = 0)."""
    pos, vel, mass = _kepler()
    T = 2 * np.pi * np.sqrt(50.0**3 / (0.5 * float(mass.sum())))
    f = lambda p: forces.accelerations(p, mass, 0.5, 0.0)  # noqa: E731
    s, diag = integrators.run(integrators.init_phase(pos, vel, f), T / 4096, 4096, f, method="kdk")
    assert diag is None
    np.testing.assert_allclose(s.pos.numpy(), pos.numpy(), atol=5e-3 * 50.0)


def test_hermite_fourth_order_and_beats_kdk():
    """Hermite's energy error shrinks ~16x when h halves (order 4), and at
    the same h it beats KDK by far on an eccentric orbit."""
    pos, vel, mass = _kepler(e=0.6)
    e0 = float(_energy(pos, vel, mass))
    fj = lambda p, v: forces.acc_and_jerk(p, mass, v, 0.5, 0.0)  # noqa: E731

    def hermite_drift(h, n):
        s = integrators.init_hermite(pos, vel, fj)
        _, es = integrators.run_hermite(s, h, n, fj, diagnostics=lambda st: _energy(st.pos, st.vel, mass))
        return _max_drift(es, e0)

    d1, d2 = hermite_drift(0.08, 4000), hermite_drift(0.04, 8000)
    assert d2 < d1 / 8.0, (d1, d2)
    f = lambda p: forces.accelerations(p, mass, 0.5, 0.0)  # noqa: E731
    _, es = integrators.run(integrators.init_phase(pos, vel, f), 0.08, 4000, f,
                            diagnostics=lambda st: _energy(st.pos, st.vel, mass))
    assert d1 < _max_drift(es, e0) / 10.0


def _method_drift(method, e, h, n):
    pos, vel, mass = _kepler(e=e)
    f = lambda p: forces.accelerations(p, mass, 0.5, 0.0)  # noqa: E731
    s = integrators.init_phase(pos, vel, f)
    e0 = float(_energy(pos, vel, mass))
    _, es = integrators.run(s, h, n, f, method=method, diagnostics=lambda st: _energy(st.pos, st.vel, mass))
    return _max_drift(es, e0)


def test_leapfrog_beats_euler():
    assert _method_drift("kdk", 0.0, 0.05, 2000) < 1e-2 * _method_drift("euler", 0.0, 0.05, 2000)


def test_dkd_and_symplectic_euler_conserve():
    """The ablation variants are symplectic: bounded energy error."""
    assert _method_drift("dkd", 0.2, 0.02, 5000) < 1e-4
    assert _method_drift("symplectic_euler", 0.2, 0.02, 5000) < 5e-3


def test_compensation_changes_a_long_float32_run():
    """Kahan-compensated KDK is not the plain one under another name: over
    3,000 float32 steps of the Kepler orbit the two end in different states,
    and the compensated one lies closer to the same run in float64."""
    pos, vel, mass = _kepler(e=0.3)

    def final(dtype, compensated):
        p, v, m = (x.to(dtype) for x in (pos, vel, mass))
        f = lambda x: forces.accelerations(x, m, 0.5, 0.0)  # noqa: E731
        s, _ = integrators.run(integrators.init_phase(p, v, f), 0.05, 3000, f, compensated=compensated)
        return s.pos.double()

    exact = final(torch.float64, False)
    plain, kahan = final(torch.float32, False), final(torch.float32, True)
    assert not torch.equal(plain, kahan)
    assert (kahan - exact).abs().max() < 0.5 * (plain - exact).abs().max()
