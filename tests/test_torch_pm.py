"""nbx_torch.ops.pm against nbx.ops.pm on the same bodies: CIC deposit and
gather (periodic and isolated, bodies outside the box included), the
Green's-function transforms, PM accelerations and the PM leapfrog.

Tolerance: 1e-5 of each output's largest magnitude for the grid operations
(float32 sums in another order). The transforms go through two FFT libraries
(pocketfft under XLA, PyTorch's own on the CPU), whose float32 round-off
differs: 1e-5 of the largest magnitude holds there too, and the leapfrog's
out-of-box count must match exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbx.ops import pm as jpm
from nbx_torch.ops import pm
from torch_parity import assert_close

torch.set_num_threads(1)

BOX = 100.0


def _bodies(n, seed, lo=0.0, hi=BOX):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    vel = rng.normal(0, 0.5, (n, 3)).astype(np.float32)
    mass = rng.uniform(0.5, 2.0, n).astype(np.float32)
    return pos, vel, mass


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("g", [8, 16])
def test_cic_deposit_matches(periodic, g):
    pos, _, mass = _bodies(400, g, lo=-8.0, hi=BOX + 8.0)  # some bodies outside
    got = pm.cic_deposit(_t(pos), _t(mass), BOX, g, periodic)
    want = jpm.cic_deposit(jnp.asarray(pos), jnp.asarray(mass), BOX, g, periodic)
    assert got.shape == (g, g, g) and got.dtype == torch.float32
    assert_close(got.numpy(), want, "rho")
    if not periodic:  # bodies fully outside deposit nothing
        assert float(got.sum()) < float(mass.sum())


@pytest.mark.parametrize("periodic", [True, False])
def test_cic_gather_matches(periodic):
    g = 16
    pos, _, _ = _bodies(300, 1, lo=-8.0, hi=BOX + 8.0)
    field = np.random.default_rng(2).normal(size=(g, g, g, 3)).astype(np.float32)
    got = pm.cic_gather(_t(field), _t(pos), BOX, g, periodic)
    want = jpm.cic_gather(jnp.asarray(field), jnp.asarray(pos), BOX, g, periodic)
    assert_close(got.numpy(), want, "gathered field")


def test_out_of_box_count_matches():
    pos, _, _ = _bodies(500, 3, lo=-5.0, hi=BOX + 5.0)
    got = pm.out_of_box_count(_t(pos), BOX)
    assert got.dtype == torch.int32
    assert int(got) == int(jpm.out_of_box_count(jnp.asarray(pos), BOX)) > 0


@pytest.mark.parametrize("smoothed", [False, True])
@pytest.mark.parametrize("g", [8, 16])
def test_isolated_green_hat_matches(smoothed, g):
    a = BOX / 12 / 3.0
    got = pm.isolated_green_hat(BOX, g, a, smoothed=smoothed, device="cpu")
    want = np.asarray(jpm.isolated_green_hat(BOX, g, a, smoothed=smoothed))
    assert got.dtype == torch.complex64 and got.shape == want.shape
    got = got.numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("isolated", [True, False])
@pytest.mark.parametrize("g", [16, 32])
def test_pm_acceleration_matches(isolated, g):
    # isolated: the recommended [0, box/2)^3; periodic: the whole box
    pos, _, mass = _bodies(512, g, lo=5.0, hi=45.0 if isolated else BOX)
    got = pm.pm_acceleration(_t(pos), _t(mass), 0.5, BOX, g=g, isolated=isolated)
    want = jpm.pm_acceleration(jnp.asarray(pos), jnp.asarray(mass), 0.5, BOX, g=g,
                               isolated=isolated)
    assert_close(got.numpy(), want, "acc")


def test_pm_acceleration_with_green_hat():
    g = 16
    pos, _, mass = _bodies(256, 4, lo=10.0, hi=40.0)
    gh = pm.isolated_green_hat(BOX, g, device="cpu")
    got = pm.pm_acceleration(_t(pos), _t(mass), 1.0, BOX, g=g, green_hat=gh)
    want = pm.pm_acceleration(_t(pos), _t(mass), 1.0, BOX, g=g)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("isolated", [True, False])
def test_pm_kdk_scan_matches(isolated):
    g = 16
    pos, vel, mass = _bodies(256, 5, lo=2.0, hi=48.0)
    vel *= 20.0  # some bodies leave [0, box/2)
    got = pm.pm_kdk_scan(_t(pos), _t(vel), _t(mass), 0.5, BOX, 0.05, 5, g=g, isolated=isolated)
    want = jpm.pm_kdk_scan(jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(mass), 0.5, BOX,
                           0.05, 5, g=g, isolated=isolated)
    assert_close(got[0].numpy(), want[0], "pos")
    assert_close(got[1].numpy(), want[1], "vel")
    assert int(got[2]) == int(want[2])
