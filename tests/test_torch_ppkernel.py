"""nbx_torch.ops.ppkernel (the P3M pair passes of K4 and K5) against
nbx.ops.ppkernel on the CPU: the same scenes as tests/test_ppkernel.py, the
JAX side in interpret mode, the port's side through the kernels' plain
PyTorch versions on the work items the kernels take. Also the cell binning of
nbx_torch.ops.p3m and the K5 layout as the card computes it (row sums)
against its plain version (the TPU kernel's column sums).

Floats to the JAX tests' own bar, rtol 2e-5 and atol 3e-6 max|acc|; counts,
bucket tuples and binning exactly."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from nbx.ops import p3m as jp3m
from nbx.ops import ppkernel as jpp
from nbx_torch.bench.pp_scenes import MAIN_CASES, clustered, main_case, residual_case, uniform
from nbx_torch.ops import p3m, ppkernel

torch.set_num_threads(1)


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=3e-6 * np.abs(want).max())


def _both(pos, mass):
    return (jnp.asarray(pos), jnp.asarray(mass)), (torch.from_numpy(pos), torch.from_numpy(mass))


@pytest.mark.parametrize("k", [32, 2])
def test_cell_bin_full_matches(k):
    pos, mass = uniform(500, 1, 1.0, 49.0)
    want = jp3m.cell_bin_full(jnp.asarray(pos), 50.0, 6, k)
    got = p3m.cell_bin_full(torch.from_numpy(pos), 50.0, 6, k)
    for g, w, name in zip(got, want, ("table", "counts", "n_overflow", "dropped")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert (int(got[2]) > 0) == (k == 2)


@pytest.mark.parametrize("case", ["clustered", "uniform"])
def test_pp_buckets_for_matches(case):
    if case == "clustered":
        pos, _ = clustered()
        args = (pos, 50.0, 6, 64)
    else:  # near-uniform occupancy: the tuner declines
        rng = np.random.default_rng(5)
        pos = rng.uniform(1.0, 49.0, (20000, 3)).astype(np.float32)
        ijk = np.clip((pos / 12.5).astype(int), 0, 3)
        args = (pos, 50.0, 4, int(np.bincount((ijk[:, 0] * 4 + ijk[:, 1]) * 4 + ijk[:, 2]).max()))
    got = ppkernel.pp_buckets_for(*args)
    assert got == jpp.pp_buckets_for(jnp.asarray(args[0]), *args[1:])
    assert (got is None) == (case == "uniform")


@pytest.mark.parametrize("case", list(MAIN_CASES))
def test_short_range_acc_kernel_matches(case):
    pos, mass, G, a, box, g, k, eps, buckets = main_case(case)
    if buckets == "census":
        buckets = ppkernel.pp_buckets_for(pos, box, g, k)
        assert buckets is not None and buckets[0][0] < k
    (jp, jm), (tp, tm) = _both(pos, mass)
    want, w_ovf = jpp.short_range_acc_pallas(jp, jm, G, a, box, g, k, eps, interpret=True,
                                             buckets=buckets)
    got, ovf = ppkernel.short_range_acc_kernel(tp, tm, G, a, box, g, k, eps, buckets=buckets)
    assert ovf.dtype == torch.int32 and int(ovf) == int(w_ovf)
    _close(got.numpy(), want)
    if case in ("overflowing", "bucket_drop"):
        assert int(ovf) > 0


def _residuals(pos, box, g, k, m):
    jd = jp3m.cell_bin_full(jnp.asarray(pos), box, g, k)[3]
    td = p3m.cell_bin_full(torch.from_numpy(pos), box, g, k)[3]
    return jp3m.take_rows(jd, m), p3m.take_rows(td, m)


def test_residual_table_acc_kernel_matches():
    pos, mass, G, a, box, g, k, m, _, eps = residual_case("core")
    (jri, jrv), (ri, rv) = _residuals(pos, box, g, k, m)
    (jp, jm), (tp, tm) = _both(pos, mass)
    want, w_missed = jpp.residual_table_acc_pallas(jp, jm, G, a, box, g, k, jri, jrv, eps,
                                                   interpret=True)
    got, missed = ppkernel.residual_table_acc_kernel(tp, tm, G, a, box, g, k, ri, rv, eps)
    assert int(missed) == int(w_missed) == 0
    _close(got.numpy(), want)
    # Newton's third law across the pass: forward and reaction cancel
    mom = (mass[:, None] * got.numpy()).sum(0)
    assert np.abs(mom).max() < 1e-3 * np.abs(mass[:, None] * got.numpy()).sum()


def test_residual_table_affected_cap_counted():
    pos, mass, G, a, box, g, k, m, cap, eps = residual_case("affected_cap")
    (jri, jrv), (ri, rv) = _residuals(pos, box, g, k, m)
    (jp, jm), (tp, tm) = _both(pos, mass)
    want, w_missed = jpp.residual_table_acc_pallas(jp, jm, G, a, box, g, k, jri, jrv, eps,
                                                   affected_cap=cap, interpret=True)
    got, missed = ppkernel.residual_table_acc_kernel(tp, tm, G, a, box, g, k, ri, rv, eps,
                                                     affected_cap=cap)
    assert int(missed) == int(w_missed) > 0
    _close(got.numpy(), want)


def test_residual_rr_dense_kernel_matches():
    pos, mass, G, a, box, g, k, m, _, eps = residual_case("core")
    (jri, jrv), (ri, rv) = _residuals(pos, box, g, k, m)
    (jp, jm), (tp, tm) = _both(pos, mass)
    want = jpp.residual_rr_dense_pallas(jp, jm, G, a, box, jri, jrv, eps, interpret=True)
    got = ppkernel.residual_rr_dense_kernel(tp, tm, G, a, box, ri, rv, eps)
    _close(got.numpy(), want)


@pytest.mark.parametrize("include_rr", [False, True])
def test_residual_short_acc_matches(include_rr):
    pos, mass, G, a, box, g, k, m, _, eps = residual_case("core")
    (jri, jrv), (ri, rv) = _residuals(pos, box, g, k, m)
    (jp, jm), (tp, tm) = _both(pos, mass)
    jtab = jp3m.cell_bin_full(jp, box, g, k)[0]
    want = jp3m._residual_short_acc(jp, jm, G, a, eps, box, g, jtab, jri, jrv,
                                    include_rr=include_rr)
    got = p3m._residual_short_acc(tp, tm, G, a, eps, box, g, p3m.cell_bin(tp, box, g, k)[0], ri, rv,
                                  include_rr=include_rr)
    _close(got.numpy(), want)


def test_react_row_sums_match_column_sums():
    """K5's design on the card: the reaction as a row sum (K4's law with
    targets and sources swapped) over the work items the kernel takes, run
    through K4's plain version, equals the TPU kernel's column-sum form, the
    plain version of K5."""
    pos, mass, G, a, box, g, k, m, _, eps = residual_case("core")
    tp, tm = torch.from_numpy(pos), torch.from_numpy(mass)
    _, (ri, rv) = _residuals(pos, box, g, k, m)
    order, starts, _ = p3m.cell_sort(tp, box, g)
    cnt = starts[1:] - starts[:-1]
    aff = torch.nonzero(cnt > 0)[:40, 0]  # 40 occupied cells stand in for the affected set
    aff_start, aff_len = starts[aff], torch.clamp(cnt[aff], max=k)
    rows, row_out = ppkernel._residual_rows(tp, tm, box, ri, rv)
    feats = ppkernel._sorted_rows(tp, tm, order)
    law = p3m.pp_law(eps, a, G)
    n = pos.shape[0]
    fwd_win, react_win = ppkernel._react_items(row_out, aff_start, aff_len, k)
    got = (ppkernel.pp_short_reference(rows, row_out, feats, fwd_win, aff.shape[0], k, n, law)
           + ppkernel.pp_short_reference(feats, order, rows, react_win, 1, rows.shape[0], n, law))
    want = ppkernel.pp_react(rows, row_out, feats, order, aff_start, aff_len, k, n, law)
    assert int(rv.sum()) > 0 and bool((want[order[aff_start.long()].long()] != 0).any())
    _close(got.numpy(), want.numpy())
