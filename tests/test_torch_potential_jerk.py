"""nbx_torch.ops.pairwise's acc+jerk and potential sums against
nbx.ops.pairwise (the Pallas kernels K6 and K3 in interpret mode, at the tiles
tests/test_kernel.py uses) and against the dense forms of both packages.

The port's wrappers run their plain PyTorch versions because the tensors lie
on the CPU. Tolerance: 1e-5 of the largest magnitude (float32 sums in
another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbx import forces as jforces
from nbx.ops import pairwise as jpairwise
from nbx_torch import forces
from nbx_torch.ops import pairwise

torch.set_num_threads(1)

TOL = 1e-5
G, EPS = 0.5, 0.5
TILES = dict(tile_i=8, tile_j=128, interpret=True)


def _rand(n, seed=0):
    rng = np.random.default_rng(seed)
    pos = (rng.normal(size=(n, 3)) * 20).astype(np.float32)
    vel = rng.normal(size=(n, 3)).astype(np.float32)
    mass = rng.uniform(0.5, 5, n).astype(np.float32)
    return pos, vel, mass


def _assert_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err < TOL, err


def _t(*arrays):
    return [None if a is None else torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


def _acc_jerk_both(pos, vel, mass, tpos=None, tvel=None):
    """((acc, jerk) of JAX's K6 in interpret mode, (acc, jerk) of the port)."""
    jp, jv, jm, jtp, jtv = _j(pos, vel, mass, tpos, tvel)
    want = jpairwise.pairwise_acc_jerk(jp, jm, jv, G, EPS, target_pos=jtp, target_vel=jtv, **TILES)
    tp, tv, tm, ttp, ttv = _t(pos, vel, mass, tpos, tvel)
    got = pairwise.pairwise_acc_jerk(tp, tm, tv, G, EPS, ttp, ttv)
    return want, got


@pytest.mark.parametrize("n", [64, 300])
def test_acc_jerk_matches_jax(n):
    pos, vel, mass = _rand(n, n)
    for want, got in zip(*_acc_jerk_both(pos, vel, mass)):
        _assert_close(got.numpy(), want)


@pytest.mark.parametrize("targets", ["slice", "not_sources"])
def test_acc_jerk_rectangular_targets(targets):
    pos, vel, mass = _rand(300, 1)
    if targets == "slice":
        tpos, tvel = pos[37:137], vel[37:137]
    else:
        tpos, tvel, _ = _rand(45, 3)
    for want, got in zip(*_acc_jerk_both(pos, vel, mass, tpos, tvel)):
        _assert_close(got.numpy(), want)


def test_acc_jerk_equals_the_dense_form_for_positive_softening():
    """No diagonal mask in the blocked sum, a masked diagonal in
    forces.acc_and_jerk: the same for eps > 0."""
    pos, vel, mass = _t(*_rand(200, 4))
    for got, want in zip(pairwise.pairwise_acc_jerk(pos, mass, vel, G, EPS),
                         forces.acc_and_jerk(pos, mass, vel, G, EPS)):
        _assert_close(got.numpy(), want.numpy())


def test_acc_jerk_reference_blocks_do_not_change_the_sum():
    pos, vel, mass = _t(*_rand(300, 5))
    whole = pairwise.pairwise_acc_jerk_reference(pos, mass, vel, G, EPS, block=1024)
    ragged = pairwise.pairwise_acc_jerk_reference(pos, mass, vel, G, EPS, block=7)
    for a, b in zip(ragged, whole):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_acc_jerk_source_split_at_the_drift_gates_size():
    """K6 splits its sources as K1 does: at 16,384 bodies, 512 blocks of 256
    threads of ACCJERK_TARGETS = 2 targets, 32 target blocks x 16 splits of
    4 tiles."""
    rows = pairwise.ACCJERK_ROWS
    assert rows == 256 * pairwise.ACCJERK_TARGETS == 512
    s = pairwise.source_splits(16384, 16384, rows)
    assert (-(-16384 // rows), s, pairwise.split_tiles(16384, s)) == (32, 16, 4)


@pytest.mark.parametrize("splits", [2, 3, None])
def test_acc_jerk_reference_does_not_depend_on_the_split(splits):
    """The kernel's order, each split's sources then the splits in turn (G
    applied once), agrees with the plain version's one sum to TOL: nothing
    cancels in K6. None: the kernel's own split at these shapes, more than
    one run, the last shorter."""
    pos, vel, mass = _t(*_rand(3000, 16))
    tpos, tvel = pos[:700], vel[:700]
    if splits is None:
        splits = pairwise.source_splits(700, 3000, pairwise.ACCJERK_ROWS)
        assert splits > 1 and splits * pairwise.split_tiles(3000, splits) * pairwise.TILE > 3000
    run = pairwise.split_tiles(3000, splits) * pairwise.TILE
    acc, jerk = torch.zeros(700, 3), torch.zeros(700, 3)
    for j0 in range(0, 3000, run):
        a, j = pairwise.pairwise_acc_jerk_reference(pos[j0:j0 + run], mass[j0:j0 + run], vel[j0:j0 + run], 1.0, EPS,
                                                    tpos, tvel)
        acc, jerk = acc + a, jerk + j
    want = pairwise.pairwise_acc_jerk_reference(pos, mass, vel, G, EPS, tpos, tvel)
    for got, w in zip((acc * G, jerk * G), want):
        _assert_close(got.numpy(), w.numpy())


def test_acc_jerk_needs_target_vel_with_target_pos():
    pos, vel, mass = _t(*_rand(16, 6))
    with pytest.raises(ValueError, match="together"):
        pairwise.pairwise_acc_jerk(pos, mass, vel, G, EPS, target_pos=pos[:4])


def _potential_both(pos, mass, tpos=None, tmass=None):
    jp, jm, jtp, jtm = _j(pos, mass, tpos, tmass)
    want = jpairwise.potential_per_body(jp, jm, G, EPS, target_pos=jtp, target_mass=jtm, **TILES)
    tp, tm, ttp, ttm = _t(pos, mass, tpos, tmass)
    return want, pairwise.potential_per_body(tp, tm, G, EPS, ttp, ttm)


@pytest.mark.parametrize("n", [64, 300])
def test_potential_per_body_matches_jax(n):
    pos, _, mass = _rand(n, n + 10)
    want, got = _potential_both(pos, mass)
    _assert_close(got.numpy(), want)


def test_potential_per_body_target_slice():
    """Targets a slice of the sources (the sharded path's use): the self term
    removed from each, the slice's rows of the full result."""
    pos, _, mass = _rand(300, 11)
    want, got = _potential_both(pos, mass, pos[37:137], mass[37:137])
    _assert_close(got.numpy(), want)
    _assert_close(got.numpy(), _potential_both(pos, mass)[1].numpy()[37:137])


def test_potential_energy_matches_jax_and_the_dense_form():
    pos, _, mass = _rand(300, 12)
    got = float(pairwise.potential_energy(*_t(pos, mass), G, EPS))
    _assert_close(got, float(jforces.potential_energy(jnp.asarray(pos), jnp.asarray(mass), G, EPS)))
    _assert_close(got, float(jpairwise.potential_energy(jnp.asarray(pos), jnp.asarray(mass), G, EPS, **TILES)))
    _assert_close(got, float(forces.potential_energy(*_t(pos, mass), G, EPS)))


def test_mass_zero_padding_is_inert():
    """Mass-0 bodies add nothing to either sum: the padded results on the 50
    real bodies equal JAX's and the port's over the real bodies alone."""
    pos, vel, mass = _rand(100, 13)
    mass[50:] = 0.0
    tp, tv, tm = _t(pos, vel, mass)
    real = (pos[:50], vel[:50], mass[:50])
    for want, got in zip(_acc_jerk_both(*real)[0], pairwise.pairwise_acc_jerk(tp, tm, tv, G, EPS)):
        _assert_close(got.numpy()[:50], want)
    want, _ = _potential_both(real[0], real[2])
    _assert_close(pairwise.potential_per_body(tp, tm, G, EPS).numpy()[:50], want)


def test_cpu_calls_are_not_launches():
    pos, vel, mass = _t(*_rand(64, 14))
    before = (pairwise.pairwise_acc_jerk.launches, pairwise.potential_per_body.launches)
    pairwise.pairwise_acc_jerk(pos, mass, vel, G, EPS)
    pairwise.potential_energy(pos, mass, G, EPS)
    assert (pairwise.pairwise_acc_jerk.launches, pairwise.potential_per_body.launches) == before


@pytest.mark.parametrize("softening", [0.0, -1.0])
def test_rejects_nonpositive_softening(softening):
    pos, vel, mass = _t(*_rand(8, 15))
    with pytest.raises(ValueError, match="softening"):
        pairwise.pairwise_acc_jerk(pos, mass, vel, G, softening)
    with pytest.raises(ValueError, match="softening"):
        pairwise.potential_per_body(pos, mass, G, softening)
    with pytest.raises(ValueError, match="softening"):
        pairwise.potential_energy(pos, mass, G, softening)


def test_potential_source_split_at_the_drift_gates_size():
    """K3 splits its sources as K6 does: at 16,384 bodies, 512 blocks of 256
    threads of POTENTIAL_TARGETS = 4 targets, 16 target blocks x 32 splits
    of 2 tiles; at 262,144, 256 target blocks x 2 splits."""
    rows = pairwise.POTENTIAL_ROWS
    assert rows == 256 * pairwise.POTENTIAL_TARGETS == 1024
    s = pairwise.source_splits(16384, 16384, rows)
    assert (-(-16384 // rows), s, pairwise.split_tiles(16384, s)) == (16, 32, 2)
    assert pairwise.source_splits(262144, 262144, rows) == 2


@pytest.mark.parametrize("splits", [2, 3, None])
def test_potential_reference_does_not_depend_on_the_split(splits):
    """The kernel's order, each split's raw sum then the splits in turn,
    times -G, then the self term removed, agrees with the plain version's
    one sum to TOL: nothing cancels in K3. None: the kernel's own split at
    these shapes, more than one run, the last shorter. The targets are a
    slice of the sources, so each sum holds its self term."""
    pos, _, mass = _t(*_rand(3000, 17))
    tpos, tmass = pos[:700], mass[:700]
    if splits is None:
        splits = pairwise.source_splits(700, 3000, pairwise.POTENTIAL_ROWS)
        assert splits > 1 and splits * pairwise.split_tiles(3000, splits) * pairwise.TILE > 3000
    run = pairwise.split_tiles(3000, splits) * pairwise.TILE
    none = torch.zeros(700)
    total = torch.zeros(700)
    for j0 in range(0, 3000, run):  # -phi of each run with no self term removed: its raw sum
        total = total - pairwise.potential_per_body_reference(pos[j0:j0 + run], mass[j0:j0 + run], 1.0, EPS, tpos,
                                                              none)
    got = total * -G + G * tmass / EPS
    _assert_close(got.numpy(), pairwise.potential_per_body_reference(pos, mass, G, EPS, tpos, tmass).numpy())
