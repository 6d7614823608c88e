"""nbx_torch.ops.ppkernel (the P3M pair passes of K4 and K5) against
nbx.ops.ppkernel on the CPU: the same scenes as tests/test_ppkernel.py, the
JAX side in interpret mode, the port's side through the kernels' plain
PyTorch versions on the work items the kernels take. Also the cell binning of
nbx_torch.ops.p3m and K5's layout as the card computes it (the kept runs
as one array of rows, block partials in block order) against its plain
version (the TPU kernel's column sums).

Floats to the JAX tests' own bar, rtol 2e-5 and atol 3e-6 max|acc|; counts,
bucket tuples and binning exactly."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from nbx.ops import p3m as jp3m
from nbx.ops import ppkernel as jpp
from nbx_torch.bench.pp_scenes import MAIN_CASES, RESIDUAL_CASES, clustered, main_case, residual_case, uniform
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


def _table_args(case):
    pos, mass, G, a, box, g, k, m, cap, eps = residual_case(case)
    tp, tm = torch.from_numpy(pos), torch.from_numpy(mass)
    sort = p3m.cell_sort(tp, box, g)
    ri, rv = p3m.take_rows(p3m.overflowing(sort, k)[1], m)
    return ppkernel._table_pass(tp, tm, G, a, box, g, k, ri, rv, eps, cap, sort)


def _blocked_react(block, rows, row_out, feats, order, aff_start, aff_len, k, n_out, law):
    """K5's design on the card in plain PyTorch: the kept rows as one array
    (`_kept_rows`), in blocks of `block` rows (REACT_ROWS on the card); each
    block's forward partials of every live residual against its rows, added
    in block order, times G; each kept row's reaction against every live
    residual, from the same law evaluation."""
    kept, kept_out, n_kept = ppkernel._kept_rows(feats, order, aff_start, aff_len, k)
    live = rows[: int((row_out >= 0).sum())]
    g = law[3]
    out = torch.zeros((n_out + 1, 3))
    fwd = torch.zeros((live.shape[0], 3))
    for b0 in range(0, int(n_kept), block):  # the live blocks, in order
        blk = kept[b0:b0 + block]
        d, r2 = ppkernel._pairs(live, blk)  # d = p_kept - p_res, [T, R]
        wb = ppkernel._law_base(r2, law)
        mk = blk[:, 3]
        fwd = fwd + ppkernel._row_sums(torch.where(mk > 0.0, wb * mk, 0.0), d)
        react = torch.stack([(wb * live[:, 3:4] * dc).sum(0) for dc in d], dim=-1)
        o = kept_out[b0:b0 + block].long()
        out[torch.where(o >= 0, o, n_out)] = -g * react
    out[row_out[: live.shape[0]].long()] = g * fwd
    return out[:n_out]


@pytest.mark.parametrize("block", [ppkernel.REACT_ROWS, 64])
@pytest.mark.parametrize("case", list(RESIDUAL_CASES))
def test_react_blocks_match_column_sums(case, block):
    """K5's design on the card, the kept runs as one array of rows in blocks
    with the forward partials added in block order, run through a plain
    evaluation, equals the TPU kernel's column-sum form (the plain version
    of K5) on the same scene: in the card's blocks (one live block on these
    scenes) and in blocks of 64 rows (4 and 7 live blocks)."""
    args, _ = _table_args(case)
    rows, row_out, feats, order, aff_start, aff_len = args[:6]
    want = ppkernel.pp_react(*args)
    assert int((row_out >= 0).sum()) > 0 and bool((want[order[aff_start.long()].long()] != 0).any())
    assert block == ppkernel.REACT_ROWS or -(-int(aff_len.sum()) // block) > 3
    _close(_blocked_react(block, *args).numpy(), want.numpy())


def test_kept_rows_hold_the_affected_runs_in_order():
    """At an affected_cap that cuts (n_missed > 0): the live prefix is each
    affected cell's kept run in turn, with its bodies' output rows; the rest
    are parked, mass 0 and output row -1, up to whole blocks of the caps."""
    (_, _, feats, order, aff_start, aff_len, k, _, _), missed = _table_args("affected_cap")
    assert int(missed) > 0
    kept, kept_out, n_kept = ppkernel._kept_rows(feats, order, aff_start, aff_len, k)
    runs = [torch.arange(int(s), int(s) + int(n)) for s, n in zip(aff_start, aff_len)]
    idx = torch.cat(runs)
    assert kept.shape == (ppkernel.react_blocks(aff_start.shape[0], k) * ppkernel.REACT_ROWS, 4)
    assert kept.shape[0] % ppkernel.REACT_ROWS == 0 and kept.shape[0] >= aff_start.shape[0] * k
    assert n_kept.dtype == torch.int32 and int(n_kept) == idx.shape[0] > 0
    assert torch.equal(kept[: idx.shape[0]], feats[idx])
    assert torch.equal(kept_out[: idx.shape[0]], order[idx])
    assert bool((kept[idx.shape[0]:, 3] == 0).all()) and bool((kept_out[idx.shape[0]:] == -1).all())
    assert ppkernel.react_partial_bytes(512, aff_start.shape[0], k) == (
        kept.shape[0] // ppkernel.REACT_ROWS * 512 * 12, ppkernel.REACT_SPLITS * kept.shape[0] * 12)
