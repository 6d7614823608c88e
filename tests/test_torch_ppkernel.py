"""nbx_torch.ops.ppkernel (the P3M pair passes of K4 and K5) against
nbx.ops.ppkernel on the CPU: the same scenes as tests/test_ppkernel.py, the
JAX side in interpret mode, the port's side through the kernels' plain
PyTorch versions on the work items the kernels take. Also the cell binning of
nbx_torch.ops.p3m, K4's layout (work items of THREADS x TARGETS targets
against those of 128; the residual-residual block's runs from M alone, their
sums added in run order) and K5's layout as the card computes it (the kept
runs as one array of rows, block partials in block order) against their
plain versions (for K5 the TPU kernel's column sums).

Floats to the JAX tests' own bar, rtol 2e-5 and atol 3e-6 max|acc|; counts,
bucket tuples and binning exactly."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from nbx.ops import p3m as jp3m
from nbx.ops import ppkernel as jpp
from nbx_torch.bench.pp_scenes import MAIN_CASES, RESIDUAL_CASES, clustered, main_case, residual_case, uniform
from nbx_torch.ops import p3m, pairwise, ppkernel

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


def _item_targets(win, item):
    """(target rows, each target's strips [T, 2 n_strips]) of a pass's work
    items, sorted by row; every item holds at most `item` targets."""
    w = win.long()
    assert bool((w[:, 1] <= item).all())
    ar = torch.arange(item)
    live = ar[None, :] < w[:, 1:2]
    rows = (w[:, 0:1] + ar)[live]
    strips = w[:, 2:][live.nonzero()[:, 0]]
    order = torch.argsort(rows)
    return rows[order], strips[order]


@pytest.mark.parametrize("case", list(MAIN_CASES))
def test_main_items_cover_each_kept_body_once(case, monkeypatch):
    """K4's work items of ITEM targets (THREADS threads of TARGETS) hold every
    kept body of the main pass once, each with the 27 strips it had in
    items of 128 targets (one thread a target), in every bucket: the same
    targets and the same strips, in fewer items."""
    pos, mass, G, a, box, g, k, eps, buckets = main_case(case)
    if buckets == "census":
        buckets = ppkernel.pp_buckets_for(pos, box, g, k)
    _, starts, _ = p3m.cell_sort(torch.from_numpy(pos), box, g)
    win, ovf = ppkernel._main_items(starts, g, k, buckets)
    monkeypatch.setattr(ppkernel, "ITEM", 128)
    win128, ovf128 = ppkernel._main_items(starts, g, k, buckets)
    assert ppkernel.ITEM == 128 != ppkernel.THREADS * ppkernel.TARGETS
    item = ppkernel.THREADS * ppkernel.TARGETS
    rows, strips = _item_targets(win, item)
    rows128, strips128 = _item_targets(win128, 128)
    assert int(ovf) == int(ovf128)
    assert torch.equal(rows, rows128) and torch.equal(strips, strips128)
    assert rows.unique().shape == rows.shape and strips.shape[1] == 2 * 27
    t_rows = [ppkernel._t_round(min(t, k)) for t, _, _ in buckets] if buckets else [k]
    cells = [b for _, _, b in buckets] if buckets else [g ** 3]
    assert win.shape[0] == sum(c * -(-t // item) for c, t in zip(cells, t_rows))
    assert win128.shape[0] == sum(c * -(-t // 128) for c, t in zip(cells, t_rows))
    cnt = starts[1:] - starts[:-1]
    kept = torch.cat([torch.arange(int(s), int(s) + min(int(n), k)) for s, n in zip(starts[:-1], cnt)])
    if case == "bucket_drop":  # the last bucket drops cells: their kept bodies are counted, not targets
        assert rows.shape[0] < kept.shape[0] and bool(torch.isin(rows, kept).all())
    else:
        assert torch.equal(rows, kept)


@pytest.mark.parametrize("m", [256, 512, 1024, 32768, 118784])
def test_rr_runs_come_from_m_alone(m):
    """The residual-residual block's runs, from M = max_residual alone:
    whole tiles in order over the one strip, the last shorter (or equal), S
    as source_splits sizes it for ceil(M / ITEM) items; at the 1M merger's
    M (118,784) and live count (79,166) the runs past the live residuals
    are empty."""
    s, run = ppkernel.rr_runs(m)
    item = ppkernel.THREADS * ppkernel.TARGETS
    assert run % ppkernel.SOURCE_TILE == 0 and s >= 1
    assert s == pairwise.source_splits(m, m, item, ppkernel.SOURCE_TILE, ppkernel.RR_GRID)
    assert (s - 1) * run < m <= s * run
    bounds = [(r * run, min(m, (r + 1) * run)) for r in range(s)]
    assert bounds[0][0] == 0 and bounds[-1][1] == m
    assert all(hi == lo2 for (_, hi), (lo2, _) in zip(bounds, bounds[1:]))
    assert bounds[-1][1] - bounds[-1][0] <= run
    assert ppkernel.rr_partial_bytes(m) == (s * m * 12 if s > 1 else 0)
    if m == 118784:
        n_live = 79166
        assert s > 1 and bounds[-1][1] - bounds[-1][0] < run
        live = [lo < n_live for lo, _ in bounds]
        assert live == sorted(live, reverse=True) and 1 < sum(live) < s
        assert -(-m // item) * s >= ppkernel.RR_GRID


@pytest.mark.parametrize("case", list(RESIDUAL_CASES))
def test_rr_runs_summed_in_order_match_the_reference(case):
    """The residual-residual block as the card computes it, in plain
    PyTorch: each run's raw sums (the strip cut to the run), added in run
    order, times G, equal pp_short_reference on the whole strip; the items
    of ITEM targets cover the live residuals, those past them are empty."""
    pos, mass, G, a, box, g, k, m, _, eps = residual_case(case)
    tp, tm = torch.from_numpy(pos), torch.from_numpy(mass)
    ri, rv = p3m.take_rows(p3m.overflowing(p3m.cell_sort(tp, box, g), k)[1], m)
    rows, row_out, src, win, n_strips, s_cap, n_out, law = ppkernel._rr_pass(tp, tm, G, a, box, ri, rv, eps)
    n_live = int(rv.sum())
    item = ppkernel.THREADS * ppkernel.TARGETS
    assert n_strips == 1 and s_cap == m and win.shape[0] == -(-m // item)
    assert win[:, 1].tolist() == [max(0, min(item, n_live - ts)) for ts in range(0, m, item)]
    s, run = ppkernel.rr_runs(m)
    assert s > 1 and n_live > 0
    total = torch.zeros((n_out, 3))
    raw = law[:3] + (1.0,)
    for r in range(s):
        lo = min(n_live, r * run)
        w = win.clone()
        w[:, 2], w[:, 3] = lo, min(n_live, lo + run) - lo
        total = total + ppkernel.pp_short_reference(rows, row_out, src, w, 1, run, n_out, raw)
    want = ppkernel.pp_short_reference(rows, row_out, src, win, n_strips, s_cap, n_out, law)
    _close((total * G).numpy(), want.numpy())
