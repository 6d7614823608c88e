"""nbx_torch.ops.collide (the bucketed collision pass, kernel K2's plain
version on the CPU) and its binning helpers against nbx.ops.collide /
nbx.ops.p3m, the Pallas kernel in interpret mode as the JAX suite runs it.

Cell sorts, bucket sizing, partners, bounce and overflow counts and the
cell-size flag must match exactly; the deltas to 1e-5 of each field's largest
magnitude (float32 sums in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbx.config import body_radius as jax_body_radius
from nbx.config import default_materials
from nbx.ops import collide as jcollide
from nbx.ops import p3m as jp3m
from nbx_torch.ops import collide, p3m
from torch_parity import assert_close

torch.set_num_threads(1)

BOX = 100.0


def _clustered_scene(n=192, seed=7):
    """Uniform background and a dense clump (the scene of
    tests/test_collisions_scaled.py): windows land in both buckets."""
    rng = np.random.default_rng(seed)
    n_bg = n * 2 // 3
    bg = rng.uniform(10, 90, (n_bg, 3))
    clump = rng.normal(35.0, 2.5, (n - n_bg, 3))
    pos = np.clip(np.concatenate([bg, clump]), 1.0, 99.0).astype(np.float32)
    vel = rng.normal(0, 1.0, (n, 3)).astype(np.float32)
    mass = rng.uniform(2.0, 8.0, n).astype(np.float32)
    return pos, vel, mass


def _radius(mass, scale):
    """The JAX package's radii (jnp.cbrt), handed to both packages."""
    r = jax_body_radius(jnp.asarray(mass), jnp.zeros(mass.shape, jnp.int32), default_materials())
    return (np.asarray(r) * scale).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


@pytest.mark.parametrize("g", [4, 8, 13])
def test_cell_sort_matches(g):
    rng = np.random.default_rng(g)
    pos = rng.uniform(-10.0, 110.0, (300, 3)).astype(np.float32)  # out-of-box included
    pos[:40] = np.round(pos[:40] / (BOX / g)) * (BOX / g)  # bodies on cell faces
    order, starts, cid = p3m.cell_sort(_t(pos), BOX, g)
    jorder, jstarts, jcid = jp3m.cell_sort(jnp.asarray(pos), BOX, g)
    for got, want in ((order, jorder), (starts, jstarts), (cid, jcid)):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("density,k", [(0.0, 8), (0.1, 8), (0.5, 40), (1.0, 16)])
def test_take_rows_matches(density, k):
    mask = np.random.default_rng(3).uniform(size=64) < density
    idx, valid = p3m.take_rows(_t(mask), k)
    jidx, jvalid = jp3m.take_rows(jnp.asarray(mask), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))


@pytest.mark.parametrize("seed,g,b,q", [(7, 8, 4, 0.6), (11, 16, 2, 0.8), (8, 8, 3, 0.3), (5, 6, 6, 0.95)])
def test_bucketed_layout_for_matches(seed, g, b, q):
    pos, _, _ = _clustered_scene(seed=seed)
    got = collide.bucketed_layout_for(pos, BOX, g, b, split_quantile=q)
    want = jcollide.bucketed_layout_for(jnp.asarray(pos), BOX, g, b, split_quantile=q)
    assert got == want
    assert all(isinstance(v, int) for bucket in got for v in bucket)
    cnt_t, cnt_s = collide._window_counts(pos, BOX, g, b)
    jcnt_t, jcnt_s = jcollide._window_counts(jnp.asarray(pos), BOX, g, b)
    np.testing.assert_array_equal(cnt_t, jcnt_t)
    np.testing.assert_array_equal(cnt_s, jcnt_s)
    maxrun = collide._window_max_strip_runs(pos, BOX, g, b)
    np.testing.assert_array_equal(maxrun, jcollide._window_max_strip_runs(jnp.asarray(pos), BOX, g, b))
    for a, w in zip(collide.bucket_flags_host(cnt_t, maxrun, got),
                    jcollide.bucket_flags_host(jcnt_t, maxrun, want)):
        np.testing.assert_array_equal(a, w)


def _pass_case(name):
    """(pos, vel, mass, radius, g, b, buckets) of the named scene."""
    if name == "two_buckets":
        pos, vel, mass = _clustered_scene()
        buckets = collide.bucketed_layout_for(pos, BOX, 8, 4, split_quantile=0.6)
        return pos, vel, mass, _radius(mass, 2.0), 8, 4, buckets
    if name == "three_buckets":
        # a small first tier whose budget (16) is short of its 44 windows:
        # the rest spill to the next tier
        pos, vel, mass = _clustered_scene(seed=5)
        buckets = ((3, 5, 16),) + collide.bucketed_layout_for(pos, BOX, 8, 4, split_quantile=0.6)
        return pos, vel, mass, _radius(mass, 2.0), 8, 4, buckets
    if name == "tiny_budgets":
        pos, vel, mass = _clustered_scene(seed=8)  # radius x4: contacts in the kept windows
        return pos, vel, mass, _radius(mass, 4.0), 8, 4, ((24, 64, 8), (128, 256, 8))
    if name == "dead_bodies":
        pos, vel, mass = _clustered_scene(seed=9)
        radius = _radius(mass, 2.0)
        mass[::5] = 0.0  # dead slots still bin and count in every occupancy
        buckets = collide.bucketed_layout_for(pos, BOX, 8, 4, split_quantile=0.6)
        return pos, vel, mass, radius, 8, 4, buckets
    raise ValueError(name)


@pytest.mark.parametrize("name", ["two_buckets", "three_buckets", "tiny_budgets", "dead_bodies"])
def test_binned_pass_matches(name):
    pos, vel, mass, radius, g, b, buckets = _pass_case(name)
    got = collide.binned_collision_pass(
        _t(pos), _t(vel), _t(mass), _t(radius), BOX, g, band_cells=b, buckets=buckets)
    want = jcollide.binned_collision_pass(
        jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(mass), jnp.asarray(radius), BOX,
        n_cells=g, band_cells=b, buckets=buckets, interpret=True)
    dv, dp, dt, best, nb, ovf, small = got
    jdv, jdp, jdt, jbest, jnb, jovf, jsmall = want
    assert_close(dv.numpy(), jdv, "dvel")
    assert_close(dp.numpy(), jdp, "dpos")
    assert_close(dt.numpy(), jdt, "dtemp")
    np.testing.assert_array_equal(best["j"].numpy(), np.asarray(jbest["j"]))
    np.testing.assert_array_equal(best["approaching"].numpy(), np.asarray(jbest["approaching"]))
    for k in ("vn", "q", "energy", "m_j"):
        assert_close(best[k].numpy(), jbest[k], k)
    assert int(nb) == int(jnb) > 0
    assert int(ovf) == int(jovf)
    assert bool(small) == bool(jsmall)
    if name == "tiny_budgets":
        assert int(ovf) > 0
    else:
        assert int(ovf) == 0


def test_buckets_populated():
    """The two- and three-bucket cases above run every bucket."""
    for name in ("two_buckets", "three_buckets"):
        pos, _, _, _, g, b, buckets = _pass_case(name)
        cnt_t, cnt_s = collide._window_counts(pos, BOX, g, b)
        maxrun = collide._window_max_strip_runs(pos, BOX, g, b, cnt_s=cnt_s)
        flags = collide.bucket_flags_host(cnt_t, maxrun, buckets)
        assert all(f.any() for f in flags), name


@pytest.mark.parametrize("kw", [
    dict(),  # full column (K8)
    dict(band_cells=4),  # banded per-cell caps
    dict(band_cells=4, packed_caps=(32, 64)),
    dict(band_cells=4, packed_caps=(32, 64), max_blocks=16),
])
def test_unported_layouts_raise(kw):
    pos, vel, mass = _clustered_scene(n=32)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        collide.binned_collision_pass(_t(pos), _t(vel), _t(mass), _t(mass), BOX, 8, **kw)


def test_kernel_wrapper_counts_no_cpu_launch():
    """On CPU tensors the wrapper runs the plain version and counts nothing."""
    pos, vel, mass, radius, g, b, buckets = _pass_case("two_buckets")
    before = collide.collide_fused.launches
    collide.binned_collision_pass(_t(pos), _t(vel), _t(mass), _t(radius), BOX, g,
                                  band_cells=b, buckets=buckets)
    assert collide.collide_fused.launches == before
