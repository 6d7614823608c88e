"""nbx_torch.ops.pairwise against nbx.ops.pairwise.pairwise_acc (f32r).

The JAX kernel runs in interpret mode, as tests/test_kernel.py runs it on the
CPU; the port's wrapper runs its plain PyTorch version because the tensors
lie on the CPU. Tolerance: 1e-5 of max|a| (float32 sums in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbx.ops import pairwise as jpairwise
from nbx_torch.ops import pairwise

torch.set_num_threads(1)

TOL = 1e-5


def _rand(n, seed=0):
    rng = np.random.default_rng(seed)
    pos = (rng.normal(size=(n, 3)) * 20).astype(np.float32)
    mass = rng.uniform(0.5, 5, n).astype(np.float32)
    return pos, mass


def _jax_acc(pos, mass, target_pos=None):
    tp = None if target_pos is None else jnp.asarray(target_pos)
    return np.asarray(jpairwise.pairwise_acc(
        jnp.asarray(pos), jnp.asarray(mass), 0.5, 0.5, target_pos=tp,
        tile_i=8, tile_j=128, interpret=True,
    ))


def _port_acc(pos, mass, target_pos=None):
    tp = None if target_pos is None else torch.from_numpy(target_pos)
    return pairwise.pairwise_acc(
        torch.from_numpy(pos), torch.from_numpy(mass), 0.5, 0.5, tp
    ).numpy()


def _assert_close(got, want):
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err < TOL, err


@pytest.mark.parametrize("n", [64, 300, 777])
def test_pairwise_acc_matches_jax(n):
    pos, mass = _rand(n, n)
    _assert_close(_port_acc(pos, mass), _jax_acc(pos, mass))


def test_rectangular_targets():
    """Targets a slice of the sources (the sharded path's use)."""
    pos, mass = _rand(300, 1)
    tpos = np.ascontiguousarray(pos[37:137])
    _assert_close(_port_acc(pos, mass, tpos), _jax_acc(pos, mass, tpos))


def test_rectangular_targets_not_sources():
    pos, mass = _rand(300, 2)
    tpos, _ = _rand(45, 3)
    _assert_close(_port_acc(pos, mass, tpos), _jax_acc(pos, mass, tpos))


def test_mass_zero_padding_is_inert():
    """Mass-0 bodies add nothing: the padded sum equals the sum over the 50
    real bodies alone (JAX's and the port's)."""
    pos, mass = _rand(100, 2)
    mass[50:] = 0.0
    got = _port_acc(pos, mass)[:50]
    real = np.ascontiguousarray(pos[:50])
    _assert_close(got, _jax_acc(real, mass[:50]))
    _assert_close(got, _port_acc(real, mass[:50]))


def test_reference_blocks_do_not_change_the_sum():
    pos, mass = _rand(300, 4)
    p, m = torch.from_numpy(pos), torch.from_numpy(mass)
    whole = pairwise.pairwise_acc_reference(p, m, 0.5, 0.5, block=1024)
    ragged = pairwise.pairwise_acc_reference(p, m, 0.5, 0.5, block=7)
    torch.testing.assert_close(ragged, whole, rtol=0, atol=0)


def test_cpu_call_is_not_a_launch():
    pos, mass = _rand(64, 5)
    before = pairwise.pairwise_acc.launches
    _port_acc(pos, mass)
    assert pairwise.pairwise_acc.launches == before


@pytest.mark.parametrize("softening", [0.0, -1.0])
def test_rejects_nonpositive_softening(softening):
    pos, mass = _rand(8, 6)
    with pytest.raises(ValueError, match="softening"):
        pairwise.pairwise_acc(torch.from_numpy(pos), torch.from_numpy(mass), 0.5, softening)
