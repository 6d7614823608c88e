"""nbx_torch.forces, config and thermal against their nbx counterparts on the
same numpy inputs. Tolerance: 1e-5 of the largest magnitude (float32 in
another summation order; rsqrt and cbrt/pow differ by ulps)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbx import config as jconfig
from nbx import forces as jforces
from nbx import thermal as jthermal
from nbx_torch import config, forces, thermal
from torch_parity import assert_close

torch.set_num_threads(1)


def _bodies(n, seed, dead=0):
    rng = np.random.default_rng(seed)
    pos = (rng.normal(size=(n, 3)) * 20).astype(np.float32)
    vel = (rng.normal(size=(n, 3)) * 2).astype(np.float32)
    mass = rng.uniform(0.5, 5, n).astype(np.float32)
    if dead:  # dead slots: mass 0, parked at the origin
        pos[-dead:] = 0.0
        mass[-dead:] = 0.0
    return pos, vel, mass


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("softening", [0.5, 0.0])
def test_accelerations_match(softening):
    """Dense form, including eps = 0 with coincident dead slots (masked)."""
    pos, _, mass = _bodies(200, 0, dead=20)
    got = forces.accelerations(*_t(pos, mass), 0.5, softening)
    want = jforces.accelerations(*_j(pos, mass), 0.5, softening)
    assert torch.isfinite(got).all()
    assert_close(got.numpy(), want, "acc")


@pytest.mark.parametrize("block", [64, 256])
def test_accelerations_blocked_match(block):
    pos, _, mass = _bodies(256, 1, dead=16)
    got = forces.accelerations_blocked(*_t(pos, mass), 0.5, 0.5, block)
    want = jforces.accelerations_blocked(*_j(pos, mass), 0.5, 0.5, block)
    assert_close(got.numpy(), want, "acc")
    assert_close(got.numpy(), forces.accelerations(*_t(pos, mass), 0.5, 0.5).numpy(), "dense")


def test_accelerations_blocked_rejects_ragged_block():
    pos, _, mass = _bodies(100, 2)
    with pytest.raises(ValueError):
        forces.accelerations_blocked(*_t(pos, mass), 0.5, 0.5, 64)


def test_acc_and_jerk_match():
    pos, vel, mass = _bodies(150, 3, dead=10)
    got_a, got_j = forces.acc_and_jerk(*_t(pos, mass, vel), 0.5, 0.5)
    want_a, want_j = jforces.acc_and_jerk(*_j(pos, mass, vel), 0.5, 0.5)
    assert_close(got_a.numpy(), want_a, "acc")
    assert_close(got_j.numpy(), want_j, "jerk")


@pytest.mark.parametrize("block", [None, 64])
def test_potential_energy_matches(block):
    pos, _, mass = _bodies(256, 4, dead=16)
    got = float(forces.potential_energy(*_t(pos, mass), 0.5, 0.5, block))
    want = float(jforces.potential_energy(*_j(pos, mass), 0.5, 0.5, block))
    assert abs(got - want) <= 1e-5 * abs(want)


def test_kinetic_energy_matches():
    _, vel, mass = _bodies(300, 5)
    got = float(forces.kinetic_energy(*_t(vel, mass)))
    want = float(jforces.kinetic_energy(*_j(vel, mass)))
    assert abs(got - want) <= 1e-6 * abs(want)


def test_body_radius_and_inverse_mass_match():
    """pow(x, 1/3) in place of cbrt: agreement to float32 ulps."""
    rng = np.random.default_rng(6)
    mass = rng.uniform(0.0, 500.0, 300).astype(np.float32)
    mass[::7] = 0.0
    mat = rng.integers(0, 3, 300).astype(np.int32)
    got = config.body_radius(*_t(mass, mat), config.default_materials())
    want = jconfig.body_radius(*_j(mass, mat), jconfig.default_materials())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)
    np.testing.assert_array_equal(
        config.inverse_mass(torch.from_numpy(mass)).numpy(),
        np.asarray(jconfig.inverse_mass(jnp.asarray(mass))),
    )


def test_materials_and_defaults_match():
    jm, m = jconfig.default_materials(), config.default_materials()
    for name in ("density", "color1", "color2"):
        np.testing.assert_array_equal(getattr(m, name).numpy(), np.asarray(getattr(jm, name)))
    jc, c = jconfig.SimConfig(), config.SimConfig()
    for f in ("G", "softening", "dt", "spawn_mass", "fracture_threshold", "min_fragment_mass",
              "merge_time", "heat_decay", "heat_to_glow", "restitution", "friction",
              "sub_steps", "capacity", "trail_length", "collisions", "max_merges",
              "max_fractures", "max_fragments", "match_rounds", "max_births"):
        assert getattr(c, f) == getattr(jc, f), f


def test_thermal_matches():
    rng = np.random.default_rng(7)
    temp = rng.uniform(0.0, 0.3, 500).astype(np.float32)
    energy = rng.uniform(0.0, 10.0, 500).astype(np.float32)
    mass = rng.uniform(0.0, 5.0, 500).astype(np.float32)
    mass[::5] = 0.0
    np.testing.assert_array_equal(
        thermal.decay(torch.from_numpy(temp), 0.998).numpy(),
        np.asarray(jthermal.decay(jnp.asarray(temp), jnp.float32(0.998))),
    )
    assert_close(
        thermal.impact_heating(*_t(energy, mass)).numpy(),
        jthermal.impact_heating(*_j(energy, mass)), "heat",
    )
