"""nbx_torch.ops.p3m against nbx.ops.p3m on the CPU: the tensor short-range
path, the scene-census tuner, p3m_acceleration with both short-range
implementations (the port's "ops"/"kernel" for the JAX package's
"xla"/"pallas", the JAX side's Pallas kernels in interpret mode, the port's
through their plain PyTorch versions), with and without occupancy buckets,
and the KDK scan; the two-level residual's argument checks and the box given
as a tensor; and the clustered scene of nbx_torch.bench.p3m_cluster
(tests/test_torch_p3m_twolevel.py and test_torch_p3m_outliers.py hold the
two-level residual's scenes).

Floats to the JAX tests' own bar, rtol 2e-5 and atol 3e-6 max|acc|; counts
and tune dicts exactly."""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from nbx import forces as jforces
from nbx.bench import p3m_cluster as jbench
from nbx.ops import p3m as jp3m
from nbx_torch.bench import p3m_cluster
from nbx_torch.ops import p3m, pm, ppkernel

torch.set_num_threads(1)

IMPL = {"ops": "xla", "kernel": "pallas"}


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=3e-6 * np.abs(want).max())


def _scene(n=900, seed=5, lo=1.0, hi=24.0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(lo, hi, (n, 3)).astype(np.float32),
            rng.uniform(0.5, 2.0, n).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("case", ["overflowing", "erfc", "last_cell"])
def test_short_range_acc_matches(case):
    if case == "overflowing":
        pos, mass = _scene(n=700, seed=3)
        args = (0.7, 50.0 / 6 / 3.0, 50.0, 6, 12, 0.05)
    else:  # a >> the scene: the pass alone is the softened direct sum
        rng = np.random.default_rng(2 if case == "erfc" else 9)
        lo, span, n = (5.0, 1.5, 64) if case == "erfc" else (95.0, 4.0, 32)
        pos = (lo + rng.uniform(0, span, (n, 3))).astype(np.float32)
        mass = rng.uniform(0.5, 2.0, n).astype(np.float32)
        args = (1.0, 1e3, 100.0, 4, 64, 0.2)
    want, w_ovf = jp3m.short_range_acc(jnp.asarray(pos), jnp.asarray(mass), *args)
    got, ovf = p3m.short_range_acc(*_t(pos, mass), *args)
    assert int(ovf) == int(w_ovf)
    _close(got.numpy(), want)
    if case != "overflowing":
        direct = jforces.accelerations(jnp.asarray(pos), jnp.asarray(mass), 1.0, 0.2)
        np.testing.assert_allclose(got.numpy(), np.asarray(direct), rtol=2e-3, atol=1e-4)


def _tune_scene():
    """The field + core scene of tests/test_p3m.py's tuner test."""
    rng = np.random.default_rng(2)
    field = rng.uniform(0.5, 24.5, (30000, 3))
    core = np.clip(rng.normal(12.5, 0.8, (3000, 3)), 0.5, 24.5)
    return np.concatenate([field, core]).astype(np.float32)


@pytest.mark.parametrize("case", ["clustered", "uniform"])
def test_p3m_tune_for_matches(case):
    if case == "clustered":
        pos, kw = _tune_scene(), dict(g_candidates=(64,), cells_candidates=(8, 12, 16))
    else:
        pos = np.random.default_rng(3).uniform(0.5, 24.5, (20000, 3)).astype(np.float32)
        kw = dict(g_candidates=(64,), cells_candidates=(8, 12))
    got = p3m.p3m_tune_for(pos, 50.0, **kw)
    assert got == jp3m.p3m_tune_for(jnp.asarray(pos), 50.0, **kw)
    assert (got["pp_buckets"] is None) == (case == "uniform")


@pytest.mark.parametrize("pp_impl,buckets", [("ops", None), ("kernel", None), ("kernel", "census"),
                                             ("kernel", "tiny")])
def test_p3m_acceleration_matches(pp_impl, buckets):
    pos, mass = _scene()
    kw = dict(G=1.0, box_size=50.0, eps=0.1, g=16, n_cells=6, max_per_cell=16, max_residual=1024)
    if buckets == "census":
        rng = np.random.default_rng(7)  # a field and a core: the bulk bucket's caps sit below K
        pos = np.concatenate([rng.uniform(1.0, 49.0, (600, 3)),
                              np.clip(rng.normal(25.0, 1.5, (300, 3)), 1.0, 49.0)]).astype(np.float32)
        kw.update(max_per_cell=64)
        buckets = ppkernel.pp_buckets_for(pos, 50.0, 6, 64)
        assert buckets is not None and buckets[0][0] < 64
    elif buckets == "tiny":  # an undersized last bucket drops cells
        pos, mass = _scene(hi=49.0)
        kw.update(n_cells=4, g=16)
        buckets = ((8, 8, 8), (16, 16, 8))
    jp, jm = jnp.asarray(pos), jnp.asarray(mass)
    want, w_unc = jp3m.p3m_acceleration(jp, jm, **kw, pp_impl=IMPL[pp_impl], pp_buckets=buckets,
                                        interpret=True)
    got, unc = p3m.p3m_acceleration(*_t(pos, mass), **kw, pp_impl=pp_impl, pp_buckets=buckets)
    assert unc.dtype == torch.int32 and int(unc) == int(w_unc)
    _close(got.numpy(), want)
    assert (int(unc) > 0) == (buckets == ((8, 8, 8), (16, 16, 8)))


def test_p3m_argument_checks():
    """The two submesh rules of `nbx` (sub_cells >= 4, sub_g >= 3 sub_cells)
    and the port's pp_impl and residual_mode names."""
    pos, mass = _scene(n=64)
    call = functools.partial(p3m.p3m_acceleration, *_t(pos, mass), 1.0, 50.0, g=16, n_cells=6)
    with pytest.raises(ValueError, match="sub_cells must be >= 4"):
        call(residual_mode="twolevel", sub_g=32, sub_cells=3)
    with pytest.raises(ValueError, match="under-resolves"):
        call(residual_mode="twolevel", sub_g=32, sub_cells=12)
    with pytest.raises(ValueError, match="residual_mode"):
        call(residual_mode="sparse")
    with pytest.raises(ValueError, match="pp_impl"):
        call(pp_impl="xla")


def test_box_as_tensor_gives_the_same_bits():
    """The two-level submesh passes its box (and scale) as a 0-d tensor:
    every function that takes one gives the bits of the same box as a Python
    float."""
    pos, mass = _scene(n=400, seed=8)
    tp, tm = _t(pos, mass)
    box, a = 27.123, p3m.smoothing_length(27.123, 5)
    tbox, ta = torch.tensor(box, dtype=torch.float32), torch.tensor(a, dtype=torch.float32)
    for x, y in zip(p3m.cell_sort(tp, box, 5), p3m.cell_sort(tp, tbox, 5)):
        assert torch.equal(x, y)
    for x, y in zip(p3m.cell_bin_full(tp, box, 5, 8), p3m.cell_bin_full(tp, tbox, 5, 8)):
        assert torch.equal(x, y)
    acc, ovf = p3m.short_range_acc(tp, tm, 0.7, a, box, 5, 8, 0.05)
    acc_t, ovf_t = p3m.short_range_acc(tp, tm, 0.7, ta, tbox, 5, 8, 0.05)
    assert torch.equal(acc, acc_t) and int(ovf) == int(ovf_t) > 0
    rho = pm.cic_deposit(tp, tm, box, 12, periodic=False)
    assert torch.equal(rho, pm.cic_deposit(tp, tm, tbox, 12, periodic=False))
    field = torch.stack([rho, 2 * rho, -rho], dim=-1)
    assert torch.equal(pm.cic_gather(field, tp, box, 12, periodic=False),
                       pm.cic_gather(field, tp, tbox, 12, periodic=False))


def test_p3m_kdk_scan_matches():
    rng = np.random.default_rng(4)
    pos = rng.uniform(10.0, 40.0, (512, 3)).astype(np.float32)
    mass = rng.uniform(0.5, 2.0, 512).astype(np.float32)
    vel = rng.normal(0, 0.5, (512, 3)).astype(np.float32)
    kw = dict(g=32, n_cells=8, max_per_cell=8, eps=0.1)
    jp, jv, junc = jp3m.p3m_kdk_scan(jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(mass), 1.0,
                                     100.0, 1e-2, 3, **kw)
    p, v, unc = p3m.p3m_kdk_scan(*_t(pos, vel, mass), 1.0, 100.0, 1e-2, 3, **kw)
    assert int(unc) == int(junc)
    _close(p.numpy(), jp)
    _close(v.numpy(), jv)


def test_cluster_scene_and_sample_errors():
    pos, mass, n_field = p3m_cluster.cluster_scene(3072, 600)
    jpos, jmass, jn_field = jbench.cluster_scene(3072, 600)
    np.testing.assert_array_equal(pos, np.asarray(jpos))
    np.testing.assert_array_equal(mass, np.asarray(jmass))
    assert n_field == jn_field == 2472
    tp, tm = _t(pos, mass)
    direct = torch.from_numpy(np.asarray(jforces.accelerations_blocked(
        jnp.asarray(pos), jnp.asarray(mass), 1.0, p3m_cluster.EPS, 1024)))
    errs = p3m_cluster.sample_errors(tp, tm, direct, n_field, n_sample=256)
    assert set(errs) == {"median", "core_median", "field_median"}
    assert max(errs.values()) < 1e-5
    acc, unc = p3m.p3m_acceleration(tp, tm, 1.0, p3m_cluster.BOX, g=32, n_cells=8,
                                    max_per_cell=64, eps=p3m_cluster.EPS, max_residual=1024,
                                    pp_impl="kernel")
    assert int(unc) == 0
    assert p3m_cluster.sample_errors(tp, tm, acc, n_field, n_sample=256)["median"] < 0.05


def test_cluster_bench_mode_specs():
    """`nbx`'s mode specs dense|twolevel[@n_cells,K[,pp[,b]]], its pp names
    taken for the port's; a bare mode keeps the production tune."""
    tune = p3m_cluster.mode_tune("twolevel")
    assert tune == dict(p3m_cluster.PRODUCTION_TUNE, residual_mode="twolevel", sub_g=96, sub_cells=24, sub_k=96)
    assert p3m_cluster.mode_tune("dense") == p3m_cluster.PRODUCTION_TUNE
    tune = p3m_cluster.mode_tune("dense@25,96,xla")
    assert (tune["n_cells"], tune["max_per_cell"], tune["pp_impl"]) == (25, 96, "ops")
    assert p3m_cluster.mode_tune("twolevel@12,768,pallas")["pp_impl"] == "kernel"
    pos = _tune_scene()
    tune = p3m_cluster.mode_tune("dense@8,64,kernel,b", pos)
    assert tune["pp_buckets"] == ppkernel.pp_buckets_for(pos, p3m_cluster.BOX, 8, 64)
    for bad in ("sparse", "dense@12,768,cuda"):
        with pytest.raises(ValueError):
            p3m_cluster.mode_tune(bad)
