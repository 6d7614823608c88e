"""nbx_torch.ops.collide (every layout of the collision pass, the kernel's
plain version on the CPU) and its binning and sizing helpers against
nbx.ops.collide / nbx.ops.p3m, the Pallas kernels in interpret mode as the
JAX suite runs them.

Cell sorts, layout sizing, partners, `approaching`, bounce and overflow
counts and the cell-size flag must match exactly; the deltas and the partner
record's floats to 1e-5 of each field's largest magnitude (float32 sums in
another order; the full-column TPU kernel also uses other, equivalent
arithmetic)."""

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
    got, want = _both_passes(pos, vel, mass, radius, g, band_cells=b, buckets=buckets)
    _assert_pass_matches(got, want)
    assert int(got[4]) > 0
    assert (int(got[5]) > 0) == (name == "tiny_budgets")


def test_buckets_populated():
    """The two- and three-bucket cases above run every bucket."""
    for name in ("two_buckets", "three_buckets"):
        pos, _, _, _, g, b, buckets = _pass_case(name)
        cnt_t, cnt_s = collide._window_counts(pos, BOX, g, b)
        maxrun = collide._window_max_strip_runs(pos, BOX, g, b, cnt_s=cnt_s)
        flags = collide.bucket_flags_host(cnt_t, maxrun, buckets)
        assert all(f.any() for f in flags), name


def _assert_pass_matches(got, want):
    """Every output of binned_collision_pass against the JAX package's."""
    dv, dp, dt, best, nb, ovf, small = got
    jdv, jdp, jdt, jbest, jnb, jovf, jsmall = want
    assert_close(dv.numpy(), jdv, "dvel")
    assert_close(dp.numpy(), jdp, "dpos")
    assert_close(dt.numpy(), jdt, "dtemp")
    np.testing.assert_array_equal(best["j"].numpy(), np.asarray(jbest["j"]))
    np.testing.assert_array_equal(best["approaching"].numpy(), np.asarray(jbest["approaching"]))
    for k in ("vn", "q", "energy", "m_j"):
        assert_close(best[k].numpy(), jbest[k], k)
    assert int(nb) == int(jnb)
    assert int(ovf) == int(jovf)
    assert bool(small) == bool(jsmall)


def _both_passes(pos, vel, mass, radius, g, **kw):
    got = collide.binned_collision_pass(_t(pos), _t(vel), _t(mass), _t(radius), BOX, g, **kw)
    want = jcollide.binned_collision_pass(
        jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(mass), jnp.asarray(radius), BOX,
        n_cells=g, interpret=True, **kw)
    return got, want


def _layout_case(name):
    """(pos, vel, mass, radius, g, layout keywords, overflows) of the named
    case of the full-column, banded, band-packed and compacted layouts."""
    pos, vel, mass = _clustered_scene(seed=9 if name.endswith("dead") else 7)
    radius = _radius(mass, 2.0)
    if name.endswith("dead"):
        mass[::5] = 0.0  # dead slots still bin and take their cells' slots
    cases = {
        # per-cell caps K: the clustered scene holds up to 49 bodies a cell at
        # g = 8 and 70 at g = 4
        "full_column_cover": (4, dict(max_per_cell=80), False),
        "full_column_k16": (8, dict(max_per_cell=16), True),
        "full_column_dead": (8, dict(max_per_cell=16), True),
        "banded_cover": (4, dict(band_cells=2, max_per_cell=80), False),
        "banded_k4": (8, dict(band_cells=4, max_per_cell=4), True),
        "banded_dead": (8, dict(band_cells=3, max_per_cell=16), True),  # 3 does not divide 8
        # band-packed: caps from packed_caps_for cover every window; (8, 10)
        # drops target rows and source lanes; (68, 24) source lanes only
        "band_packed_cover": (8, dict(band_cells=4, packed_caps="sized"), False),
        "band_packed_tiny": (8, dict(band_cells=4, packed_caps=(8, 10)), True),
        "band_packed_sources": (8, dict(band_cells=4, packed_caps=(68, 24)), True),
        # compacted: packed_layout_for covers; a budget of 40 of the 72
        # occupied windows drops windows only; tiny caps on dead bodies
        "compacted_cover": (8, dict(band_cells=4, packed_caps="sized"), False),
        "compacted_budget": (8, dict(band_cells=4, packed_caps=(68, 70), max_blocks=40), True),
        "compacted_dead": (8, dict(band_cells=4, packed_caps=(16, 24), max_blocks=64), True),
    }
    g, kw, overflows = cases[name]
    if kw.get("packed_caps") == "sized":
        if name.startswith("compacted"):
            lay = collide.packed_layout_for(pos, BOX, g, kw["band_cells"])
            kw = dict(kw, packed_caps=lay["packed_caps"], max_blocks=lay["max_blocks"])
        else:
            kw = dict(kw, packed_caps=collide.packed_caps_for(pos, BOX, g, kw["band_cells"]))
    return pos, vel, mass, radius, g, kw, overflows


LAYOUT_CASES = ["full_column_cover", "full_column_k16", "full_column_dead", "banded_cover", "banded_k4",
                "banded_dead", "band_packed_cover", "band_packed_tiny", "band_packed_sources",
                "compacted_cover", "compacted_budget", "compacted_dead"]


@pytest.mark.parametrize("name", LAYOUT_CASES)
def test_layout_pass_matches(name):
    pos, vel, mass, radius, g, kw, overflows = _layout_case(name)
    got, want = _both_passes(pos, vel, mass, radius, g, **kw)
    _assert_pass_matches(got, want)
    assert int(got[4]) > 0
    assert (int(got[5]) > 0) == overflows


def test_band_packed_counts_source_overflow_per_own_strip():
    """The band-packed layout counts a strip's missed lanes once, the
    compacted layout once per window that reads it: on the same caps with a
    budget for every window, the kept set is the same and the counts differ."""
    pos, vel, mass, radius, g, kw, _ = _layout_case("band_packed_sources")
    t = (_t(pos), _t(vel), _t(mass), _t(radius), BOX, g)
    packed = collide.binned_collision_pass(*t, **kw)
    compact = collide.binned_collision_pass(*t, max_blocks=g * g * 2, **kw)
    for a, b in zip(packed[:3], compact[:3]):
        assert torch.equal(a, b)
    assert torch.equal(packed[3]["j"], compact[3]["j"])
    assert 0 < int(packed[5]) < int(compact[5])


@pytest.mark.parametrize("seed,g,b,q", [(7, 8, 4, 1.0), (11, 8, 2, 0.8), (8, 6, 3, 0.5), (5, 8, 8, 0.95)])
def test_packed_sizing_matches(seed, g, b, q):
    pos, _, _ = _clustered_scene(seed=seed)
    got = collide.packed_caps_for(pos, BOX, g, b, quantile=q)
    assert got == jcollide.packed_caps_for(jnp.asarray(pos), BOX, g, b, quantile=q)
    assert all(isinstance(v, int) for v in got)
    lay = collide.packed_layout_for(pos, BOX, g, b, quantile=q, block_slack=1.1)
    jlay = jcollide.packed_layout_for(jnp.asarray(pos), BOX, g, b, quantile=q, block_slack=1.1)
    assert lay == jlay
    assert isinstance(lay["max_blocks"], int) and all(isinstance(v, int) for v in lay["packed_caps"])


@pytest.mark.parametrize("fn,kw", [
    ("packed_caps_for", dict(max_source_lanes=256)),
    ("packed_layout_for", dict(max_source_lanes=256)),
    ("packed_layout_for", dict(max_block_pair_lanes=4096)),
])
def test_packed_sizing_raises_where_jax_raises(fn, kw):
    pos, _, _ = _clustered_scene()
    with pytest.raises(ValueError):
        getattr(jcollide, fn)(jnp.asarray(pos), BOX, 8, 4, **kw)
    with pytest.raises(ValueError):
        getattr(collide, fn)(pos, BOX, 8, 4, **kw)


@pytest.mark.parametrize("construction", ["auto", "grid", "slice"])
@pytest.mark.parametrize("windows", [1, 4])
def test_windows_per_block_and_construction_change_nothing(windows, construction):
    """The bucketed pass gives the same outputs for every windows_per_block
    and construction (on the CPU the plain version runs; the card tests hold
    the kernel at W > 1 bitwise against W = 1)."""
    pos, vel, mass, radius, g, b, buckets = _pass_case("two_buckets")
    t = (_t(pos), _t(vel), _t(mass), _t(radius), BOX, g)
    base = collide.binned_collision_pass(*t, band_cells=b, buckets=buckets)
    got = collide.binned_collision_pass(*t, band_cells=b, buckets=buckets, windows_per_block=windows,
                                        construction=construction)
    for a, w in zip(got[:3], base[:3]):
        assert torch.equal(a, w)
    for k in base[3]:
        assert torch.equal(got[3][k], base[3][k])
    assert [int(x) for x in got[4:]] == [int(x) for x in base[4:]]


def test_multi_window_matches_jax():
    """windows_per_block=4 and the slice construction on both packages."""
    pos, vel, mass, radius, g, b, buckets = _pass_case("two_buckets")
    got, want = _both_passes(pos, vel, mass, radius, g, band_cells=b, buckets=buckets,
                             windows_per_block=4, construction="slice")
    _assert_pass_matches(got, want)


@pytest.mark.parametrize("kw", [
    dict(buckets=((8, 8, 8),)),  # buckets without band_cells
    dict(band_cells=4, buckets=((8, 8, 8),), packed_caps=(8, 8)),
    dict(band_cells=4, buckets=((8, 8, 8),), max_blocks=8),
    dict(band_cells=4, max_blocks=8),  # max_blocks without packed_caps
    dict(packed_caps=(8, 8), max_blocks=8),  # ... without band_cells
    dict(packed_caps=(8, 8)),  # packed_caps without band_cells
    dict(band_cells=0),
    dict(band_cells=9),
])
def test_layout_argument_errors(kw):
    """The JAX package's layout checks, with its ValueErrors."""
    pos, vel, mass = _clustered_scene(n=32)
    r = _radius(mass, 1.0)
    with pytest.raises(ValueError):
        jcollide.binned_collision_pass(jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(mass), jnp.asarray(r),
                                       BOX, n_cells=8, interpret=True, **kw)
    with pytest.raises(ValueError):
        collide.binned_collision_pass(_t(pos), _t(vel), _t(mass), _t(r), BOX, 8, **kw)


@pytest.mark.parametrize("kw", [dict(construction="sliec"), dict(windows_per_block=0)])
def test_port_rejects_unknown_construction_and_window_count(kw):
    """Where the JAX package silently takes an unknown construction as "grid"
    and W < 1 as 1, the port raises."""
    pos, vel, mass, radius, g, b, buckets = _pass_case("two_buckets")
    with pytest.raises(ValueError):
        collide.binned_collision_pass(_t(pos), _t(vel), _t(mass), _t(radius), BOX, g, band_cells=b,
                                      buckets=buckets, **kw)


@pytest.mark.parametrize("kw", [dict(windows_per_block=1), dict(windows_per_block=4), dict(band_cells=None)])
def test_kernel_wrapper_counts_no_cpu_launch(kw):
    """On CPU tensors every wrapper (collide_fused, collide_fused_multi,
    collide_full_column) runs the plain version and counts nothing."""
    pos, vel, mass, radius, g, b, buckets = _pass_case("two_buckets")
    wrappers = (collide.collide_fused, collide.collide_fused_multi, collide.collide_full_column)
    before = [w.launches for w in wrappers]
    if kw.get("band_cells", b) is None:
        kw = dict(max_per_cell=16)
    else:
        kw = dict(kw, band_cells=b, buckets=buckets)
    out = collide.binned_collision_pass(_t(pos), _t(vel), _t(mass), _t(radius), BOX, g, **kw)
    assert int(out[4]) > 0
    assert [w.launches for w in wrappers] == before
