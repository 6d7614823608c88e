"""The plain reference against the port's plain versions at tiny N, and its
own arithmetic. (This test may import the port; the reference may not.)"""

from __future__ import annotations

import pytest
import torch

from benchmark import scenes
from benchmark.reference import gravity as ref


def rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.double() - want.double()).abs().max() / want.double().abs().max())


@pytest.fixture
def disk():
    sc = scenes.cold_collapse_disk(512, seed=4)
    return torch.from_numpy(sc["pos"]), torch.from_numpy(sc["mass"])


def test_accelerations_match_the_ports_dense_law_in_float64(disk):
    from nbx_torch import forces

    pos, mass = disk
    want = forces.accelerations(pos.double(), mass.double(), 0.5, 0.5)
    got, scale = ref.accelerations(pos, mass, pos, 0.5, 0.5)
    # the matrix-product form rounds |x|^2 ~ 1e4 against pair distances ~ 1:
    # some 1e-11 of the force's scale, 1e4 times below float32's
    assert ref.acc_gap(got, want, scale) < 1e-10
    d = pos.double()[None] - pos.double()[:, None]
    s2 = (d * d).sum(-1) + 0.25
    terms = 0.5 * mass.double()[None] * d.norm(dim=-1) / s2**1.5  # the terms' sizes
    assert torch.allclose(scale, 0.5 * (mass.double()[None] / s2).sum(1), rtol=1e-12)
    assert bool((scale >= terms.sum(1)).all())


def test_accelerations_blocks_and_targets(disk, monkeypatch):
    pos, mass = disk
    whole, scale = ref.accelerations(pos, mass, pos[100:200], 0.5, 0.5)
    monkeypatch.setattr(ref, "BLOCK_ELEMENTS", 512 * 7)  # blocks of 7 targets
    got, got_scale = ref.accelerations(pos, mass, pos[100:200], 0.5, 0.5)
    assert ref.acc_gap(got, whole, scale) < 1e-12 and rel(got_scale, scale) < 1e-13  # sums in another order


def test_float32_kernel_plain_version_is_within_float32_of_the_reference(disk):
    from nbx_torch.ops.pairwise import pairwise_acc

    pos, mass = disk
    got = pairwise_acc(pos, mass, 0.5, 0.5)  # the CPU's plain version of K1
    want, scale = ref.accelerations(pos, mass, pos, 0.5, 0.5)
    assert ref.acc_gap(got, want, scale) < 1e-5


def test_kdk_follows_the_ports_integrator_in_float64(disk):
    from nbx_torch import forces

    pos, mass = disk
    vel = torch.zeros_like(pos).double()
    acc = forces.accelerations(pos.double(), mass.double(), 0.5, 0.5)
    h = ref.f32(0.016 / 2)
    x, v, a = pos.double(), vel, acc
    for _ in range(2):  # sim.substep's order, in float64
        v = v + a * (0.5 * h)
        x = x + v * h
        a = forces.accelerations(x, mass.double(), 0.5, 0.5)
        v = v + a * (0.5 * h)
    rx, rv, ra, scale, mean_scale = ref.kdk(pos, vel, mass, 0.5, 0.5, h, 2)
    assert rel(rx, x) < 1e-12 and rel(rv, v) < 1e-9 and rel(ra, a) < 1e-9
    assert rel(scale, ref.accelerations(rx, mass, rx, 0.5, 0.5)[1]) < 1e-13
    sx, sv, sa, s_scale, s_mean = ref.kdk(pos, vel, mass, 0.5, 0.5, h, 2, rows=slice(10, 20))
    assert rel(sa, ra[10:20]) < 1e-13 and torch.equal(sx, rx[10:20])
    assert rel(s_mean, mean_scale[10:20]) < 1e-13 and bool((mean_scale > 0).all())


def test_kdk_starts_from_its_own_force_not_the_callers(disk):
    """Without a0 the reference works out the starting force itself: a
    stored force that is off moves the given-a0 path, never the default."""
    pos, mass = disk
    vel = torch.zeros_like(pos).double()
    h = ref.f32(0.008)
    own = ref.kdk(pos, vel, mass, 0.5, 0.5, h, 1)
    a0 = ref.accelerations(pos, mass, pos, 0.5, 0.5)[0]
    given = ref.kdk(pos, vel, mass, 0.5, 0.5, h, 1, a0=a0)
    assert all(torch.equal(x, y) for x, y in zip(own, given))
    stale = ref.kdk(pos, vel, mass, 0.5, 0.5, h, 1, a0=1.1 * a0)
    assert rel(stale[1], own[1]) > 1e-3


def test_acc_gap_is_over_the_scale():
    r = torch.tensor([[1.0, 0, 0], [0.0, 2.0, 0]])
    p = r.clone()
    p[1, 1] += 1e-3
    assert ref.acc_gap(p, r, torch.tensor([10.0, 4.0])) == pytest.approx(1e-3 / 4.0, rel=1e-4)  # float32


def test_dvel_gap_allows_the_stored_rounding_only():
    start = torch.tensor([[1000.0, 0, 0], [0.0, 1.0, 0]], dtype=torch.float64)
    r = start + torch.tensor([[1e-3, 0, 0], [0.0, 1e-3, 0]], dtype=torch.float64)
    kicks, dt, scale = 4, 0.01, torch.tensor([0.1, 0.1], dtype=torch.float64)
    rounding = r.clone()
    rounding[0, 0] += 2 * ref.EPS32 * 1000.0  # two ulps of a stored 1000
    assert ref.dvel_gap(rounding, r, start, dt, kicks, scale) == 0.0
    off = r.clone()
    off[1, 1] += 1e-5  # far past the rounding of a stored 1
    want = (1e-5 - kicks * ref.EPS32 * float(r[1].norm())) / (dt * 0.1)
    assert ref.dvel_gap(off, r, start, dt, kicks, scale) == pytest.approx(want, rel=1e-6)
