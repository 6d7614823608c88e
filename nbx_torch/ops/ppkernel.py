"""P3M short-range pair passes on the card: the kernels K4 and K5 and the
layouts that feed them (port of `nbx/ops/ppkernel.py`).

The JAX package's TPU kernels `_pp_kernel` (K4) and `_pp_react_kernel` (K5)
take materialised [C, K8, 8] target and [C, 8, 27 K8] source blocks built by
XLA gathers. Here the kernels read the bodies themselves. A pass of K4 is a
list of work items, one per thread block (`nbx_torch/csrc/pp_short.cu`):

    win[w] = (ts, tn, s0, l0, s1, l1, ...)   targets tgt[ts .. ts + tn),
                                              tn <= ITEM, against the source
                                              rows src[s .. s + l) of each
                                              strip

THREADS threads of TARGETS targets a block, and every target writes its row
straight to body order through `tgt_out`. The residual-residual block's one
strip is also split into `rr_runs` runs of whole tiles, a second grid
dimension, whose partials a second launch adds in run order.
K5 takes the affected cells' kept runs gathered into one array of rows
(`_kept_rows`), REACT_ROWS a block, against the live residuals in
REACT_SPLITS runs, one law evaluation a pair for both directions
(`nbx_torch/csrc/pp_react.cu`).
The layouts below are built with torch ops on the device, so the CPU tests
reach them, and keep the JAX package's contract:

  * kept set: the first K bodies of each cell in stable cell-sorted order;
  * main pass: each kept target against the kept bodies of its 27 neighbour
    cells (face cells see fewer), in the uniform layout or the
    occupancy-bucketed one (cells spill to the next bucket past a budget;
    only the last bucket drops, and the dropped cells' kept bodies and every
    cap truncation are counted in n_overflow);
  * residual-versus-table: each residual against the kept bodies of every
    affected cell, the 27-dilation of the overflowing cells, cut at
    affected_cap with n_missed counted;
  * residual-residual: each live residual against every live residual;
  * the law: G m_j [erfc(x)/s^3 + c_a e^(-x^2)/s^2] d, x = s/a,
    s = sqrt(r^2 + eps^2), masked r^2 > 0 and m_j > 0, erfc by the
    Abramowitz & Stegun 7.1.26 polynomial.

`pp_short` (K4) and `pp_react` (K5) launch the kernels on a CUDA tensor and
run their plain PyTorch versions on a CPU tensor; a CUDA call launches the
kernel or raises. Each counts its calls in `.launches` (a call of K5, and
one of K4 that splits its strip, is two launches, the pair kernel and its
combine). `pp_buckets_for` is host-side
numpy, once per scene.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from nbx_torch.config import f32
from nbx_torch.ops import _build
from nbx_torch.ops.p3m import _cell_coords, _dilate27, _host, _neighbors27, cell_sort, pp_law, take_rows
from nbx_torch.ops.pairwise import SPLIT_GRID, source_splits, split_tiles
from nbx_torch.profiling import spanned

LANE = 128  # the JAX package's lane width; only its sizing rules use it
THREADS = 128  # threads a block of K4 (kThreads in csrc/pp_short.cu)
TARGETS = 2  # targets a thread of K4 (kTargets; 4 ran slower, PERF.md)
ITEM = THREADS * TARGETS  # the most targets a work item of K4 holds
SOURCE_TILE = 256  # source rows K4 stages at a time (kTile), a run's unit
# The residual-residual block's blocks (items x runs) aim at RR_GRID, far
# more than the direct sums' SPLIT_GRID: its blocks have half their threads,
# and the runs come from M, so items and runs past the live residuals (a
# third of them at the 1M merger) exit at once. 2, 4, 8 and 16 x SPLIT_GRID
# ran the merger's block slower (PERF.md).
RR_GRID = 32 * SPLIT_GRID
REACT_ROWS = 1024  # kept rows a block of K5 (kRows in csrc/pp_react.cu)
REACT_SPLITS = 16  # K5's runs of the live residuals, its grid's second dimension (kSplits)

# Abramowitz & Stegun 7.1.26 erfc coefficients (x >= 0, abs err 1.5e-7)
_AS_P = 0.3275911
_AS_A = (0.254829592, -0.284496736, 1.421413741, -1.453152027, 1.061405429)


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _pair_budget(device) -> int:
    """Pair lanes per chunk of a plain version: small on the CPU, where the
    tests run several workers, larger on the card to cut launches."""
    return 1 << 22 if device.type == "cpu" else 1 << 24


# ---- host-side sizing (numpy) ------------------------------------------------

def pp_buckets_for(
    pos,
    box_size: float,
    n_cells: int,
    max_per_cell: int,
    split_quantile: float = 0.8,
    slack: float = 1.15,
    block_slack: float = 1.25,
) -> tuple[tuple[int, int, int], ...] | None:
    """Census this scene's per-cell kept occupancy and size a two-bucket
    configuration for short_range_acc_kernel(buckets=...):
    ((t_cap, s_cap, bmax_bulk), (K, K, bmax_tail)), the JAX package's tuple
    for the same positions. The bulk bucket takes every occupied cell whose
    kept count and 27-neighbourhood max kept count fit caps at
    `split_quantile` of the occupied distribution (with `slack` headroom);
    the tail runs at full K. None when bucketing cannot pay (near-uniform
    occupancy). Host-side numpy: call once per scene, or when n_overflow
    goes nonzero."""
    g = n_cells
    k = max_per_cell
    p = _host(pos)
    h = box_size / g
    ijk = np.clip((p / h).astype(np.int64), 0, g - 1)
    cid = (ijk[:, 0] * g + ijk[:, 1]) * g + ijk[:, 2]
    cnt = np.bincount(cid, minlength=g**3).reshape(g, g, g)
    kept = np.minimum(cnt, k)
    nbr = _dilate27(torch.from_numpy(kept)).numpy()
    occ = cnt > 0
    if not occ.any():
        return None
    kk = _round_up(max(k, 8), 8)

    def cap(v):
        c = max(8, int(np.ceil(v * slack)))
        return min(_round_up(c, 8), kk)

    t1 = cap(np.quantile(kept[occ], split_quantile))
    s1 = cap(np.quantile(nbr[occ], split_quantile))
    in1 = occ & (kept <= t1) & (nbr <= s1)
    n1, n2 = int(in1.sum()), int((occ & ~in1).sum())

    def budget(m):
        return max(8, _round_up(int(np.ceil(m * block_slack)), 8))

    uniform_lanes = int(occ.sum()) * kk * 27 * kk
    bucket_lanes = n1 * t1 * 27 * s1 + n2 * kk * 27 * kk
    if bucket_lanes > 0.85 * uniform_lanes:
        return None
    return ((t1, s1, budget(n1)), (kk, kk, budget(n2)))


# ---- device-side layouts -------------------------------------------------------

def _items(ts, tn, strip_start, strip_len, t_rows: int) -> torch.Tensor:
    """Work items [W ny, 2 + 2 ns] i32 from W target runs (ts, tn <= t_rows)
    and their strips [W, ns]: each run is cut into ny = ceil(t_rows / ITEM)
    items of at most ITEM targets, each with the run's strips."""
    ny = max(1, -(-t_rows // ITEM))
    y = torch.arange(ny, device=ts.device) * ITEM
    its = (ts[:, None].long() + y).reshape(-1, 1)
    itn = (tn[:, None].long() - y).clamp(0, ITEM).reshape(-1, 1)
    w, ns = strip_start.shape
    strips = torch.stack([strip_start.long(), strip_len.long()], dim=2).reshape(w, 2 * ns)
    return torch.cat([its, itn, strips.repeat_interleave(ny, 0)], dim=1).to(torch.int32).contiguous()


def _t_round(t_cap: int) -> int:
    """The JAX package's target rows of a bucket: a multiple of 8, past 128
    of 128."""
    t8 = _round_up(max(t_cap, 8), 8)
    return _round_up(t8, LANE) if t8 > LANE else t8


def _main_items(starts: torch.Tensor, g: int, k: int, buckets):
    """The main pass's work items (27 strips each) and n_overflow [] i32:
    bodies past K in their cells, plus, with buckets, the kept bodies of the
    cells the last bucket drops and every cap truncation."""
    c_total = g * g * g
    dev = starts.device
    cnt = starts[1:] - starts[:-1]
    n_overflow = torch.clamp(cnt - k, min=0).sum(dtype=torch.int32)
    ids, on_grid = _neighbors27(_cell_coords(g, dev), g)
    neigh = torch.where(on_grid, ids, c_total)  # [g^3, 27]; off the grid -> the dead cell
    keptc = torch.clamp(cnt, max=k)
    zero = torch.zeros(1, dtype=cnt.dtype, device=dev)
    kept_p = torch.cat([keptc, zero])
    base_p = torch.cat([starts[:c_total], zero])
    if buckets is None:
        return _items(starts[:c_total], keptc, base_p[neigh], kept_p[neigh], k), n_overflow

    # first covering bucket, with budget spill; only the last bucket drops
    nbrmax = kept_p[neigh].amax(1)
    remaining = cnt > 0
    sels = []
    for bi, (t_cap, s_cap, bmax) in enumerate(buckets):
        last = bi == len(buckets) - 1
        fl = remaining if last else remaining & (keptc <= t_cap) & (nbrmax <= s_cap)
        sel = fl & (torch.cumsum(fl.to(torch.int32), 0) - 1 < bmax)
        if last:
            n_overflow = n_overflow + torch.where(fl & ~sel, keptc, 0).sum(dtype=torch.int32)
        remaining = remaining & ~sel
        sels.append(sel)
    items = []
    for (t_cap, s_cap, bmax), sel in zip(buckets, sels):
        t8 = _t_round(min(t_cap, k))
        s8 = _round_up(max(min(s_cap, k), 8), 8)
        csel, cvalid = take_rows(sel, bmax)
        csel = csel.long()
        cnt_sel = torch.where(cvalid, keptc[csel], 0)
        kc_sel = torch.where(cvalid[:, None], kept_p[neigh[csel]], 0)
        # cap-truncation guards: 0 for buckets from pp_buckets_for, counted
        # where a mis-sized bucket would lose pairs
        n_overflow = n_overflow + torch.clamp(cnt_sel - t8, min=0).sum(dtype=torch.int32)
        n_overflow = n_overflow + torch.clamp(kc_sel - s8, min=0).sum(dtype=torch.int32)
        items.append(_items(starts[csel], torch.clamp(cnt_sel, max=t8), base_p[neigh[csel]],
                            torch.clamp(kc_sel, max=s8), t8))
    return torch.cat(items), n_overflow


def _sorted_rows(pos, mass, order) -> torch.Tensor:
    """[N, 4] float4 rows (x, y, z, m) in cell-sorted order."""
    return torch.cat([pos, mass[:, None]], dim=1)[order.long()].contiguous()


def _residual_rows(pos, mass, box_size: float, res_idx, res_valid):
    """The residual rows [M, 4] (x, y, z, m), invalid ones parked at 2 box
    with mass 0, and their output rows [M] i32 (-1 for the parked ones)."""
    n = pos.shape[0]
    park = torch.cat([pos.new_full((1, 3), f32(2.0 * box_size)), pos.new_zeros((1, 1))], dim=1)
    body = torch.cat([torch.cat([pos, mass[:, None]], dim=1), park])
    rows = body[torch.where(res_valid, res_idx, n).long()].contiguous()
    return rows, torch.where(res_valid, res_idx, -1).to(torch.int32).contiguous()


# ---- the pair law in PyTorch ------------------------------------------------------

def _law_base(r2: torch.Tensor, law) -> torch.Tensor:
    """(erfc(x)/s + c_a e^(-x^2)) / s^2 per pair, 0 where r^2 = 0: the kernels'
    law without the source mass, in the kernels' order of operations."""
    eps2, inv_a, c_a, _ = law
    s2 = r2 + eps2
    inv_s = torch.rsqrt(torch.where(s2 > 0.0, s2, 1.0))
    x = (s2 * inv_s) * inv_a
    ex2 = torch.exp(-x * x)
    tt = 1.0 / (1.0 + _AS_P * x)
    poly = torch.full_like(tt, _AS_A[4])
    for a_k in (_AS_A[3], _AS_A[2], _AS_A[1], _AS_A[0]):
        poly = poly * tt + a_k
    erfc_x = poly * tt * ex2
    return torch.where(r2 > 0.0, (erfc_x * inv_s + c_a * ex2) * (inv_s * inv_s), 0.0)


def _pairs(ti, sj):
    """Displacements (dx, dy, dz), each [..., T, S], and r^2 of targets
    ti [..., T, 4] against sources sj [..., S, 4]."""
    d = [sj[..., None, :, c] - ti[..., :, c:c + 1] for c in range(3)]
    return d, d[0] * d[0] + d[1] * d[1] + d[2] * d[2]


def _row_sums(w, d) -> torch.Tensor:
    """sum_j w_ij d_ij -> [..., T, 3]."""
    return torch.stack([(w * dc).sum(-1) for dc in d], dim=-1)


# ---- K4 ----------------------------------------------------------------------------

def pp_short_reference(tgt, tgt_out, src, win, n_strips: int, s_cap: int, n_out: int, law):
    """Plain PyTorch version of K4 on the same work items: [items, ITEM,
    n_strips s_cap] pair tensors in chunks of items (every item has at most
    ITEM targets and strips of at most s_cap rows, as the layouts here make
    them). Returns out [n_out, 3]: G sum_j w_ij d_ij on each target's row
    tgt_out, 0 elsewhere."""
    dev = tgt.device
    out = torch.zeros((n_out + 1, 3), dtype=torch.float32, device=dev)
    n_win = win.shape[0]
    s_all = n_strips * s_cap
    if n_win == 0 or s_all == 0:
        return out[:n_out]
    g = law[3]
    ar_t = torch.arange(ITEM, device=dev)
    ar_s = torch.arange(s_cap, device=dev)
    chunk = max(1, _pair_budget(dev) // (ITEM * s_all))
    for w0 in range(0, n_win, chunk):
        wd = win[w0:w0 + chunk].long()
        nw = wd.shape[0]
        vt = ar_t[None, :] < wd[:, 1:2]
        pt = torch.where(vt, wd[:, 0:1] + ar_t, 0)
        vs = ar_s < wd[:, 3::2, None]  # [nw, ns, s_cap]
        ps = torch.where(vs, wd[:, 2::2, None] + ar_s, 0).reshape(nw, s_all)
        sj = src[ps]
        mj = torch.where(vs.reshape(nw, s_all), sj[..., 3], 0.0)[:, None, :]
        d, r2 = _pairs(tgt[pt], sj)
        acc = _row_sums(torch.where(mj > 0.0, mj * _law_base(r2, law), 0.0), d)
        o = torch.where(vt, tgt_out[pt].long(), -1)
        out[torch.where(o >= 0, o, n_out).reshape(-1)] = g * acc.reshape(-1, 3)
    return out[:n_out]


def _check(name: str, t: torch.Tensor, dtype, shape: tuple, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if dtype == torch.float32 and t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned (rows are read as float4)")


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LAW = [_F] * 4  # pp_law's (eps^2, 1/a, c_a, G)


def _launch(symbol: str, argtypes: list, dev, *args) -> None:
    """Launch the entry `symbol` = nbx_<kernel> of csrc/<kernel>.cu on the
    device's current stream; raise on a refused launch."""
    kernel = symbol.removeprefix("nbx_")
    fn = getattr(_build.load(kernel), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes + [_P]
        fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError_t {err}")


def rr_runs(m: int) -> tuple[int, int]:
    """(S, run length) of K4's residual-residual block over M = m residual
    rows, from M alone (the live count never reaches the host): S runs of
    whole SOURCE_TILE tiles, as `source_splits` sizes a direct sum's split,
    aimed at RR_GRID blocks of ceil(M / ITEM) items x S runs; the last run
    holds what is left. Runs past the live residuals exit at once."""
    s = source_splits(m, m, ITEM, SOURCE_TILE, RR_GRID)
    return s, split_tiles(m, s, SOURCE_TILE) * SOURCE_TILE


def rr_partial_bytes(m: int) -> int:
    """Bytes of the residual-residual block's float32 partials [S, M, 3]
    (none for one run)."""
    s, _ = rr_runs(m)
    return s * m * 3 * 4 if s > 1 else 0


@spanned("nbx.p3m.k4")
def pp_short(tgt, tgt_out, src, win, n_strips: int, s_cap: int, n_out: int, law) -> torch.Tensor:
    """K4: every work item's targets against its strips of source rows
    (module docstring). tgt [Rt, 4] and src [Rs, 4] float32 rows
    (x, y, z, m), tgt_out [Rt] i32, win [W, 2 + 2 n_strips] i32; s_cap bounds
    a strip's length (the plain version's lane count); law = pp_law(eps, a,
    G). Returns out [n_out, 3] f32: G sum_j w_ij d_ij on row tgt_out[t] of
    each target t, 0 on rows no target maps to. A CPU tensor runs the plain
    version; a CUDA tensor launches the kernel, one block of THREADS threads
    per item; a pass of one strip (the residual-residual block) splits it
    into rr_runs(s_cap) runs, whose partials a second launch adds in run
    order: one call, counted once."""
    if tgt.device.type == "cpu":
        return pp_short_reference(tgt, tgt_out, src, win, n_strips, s_cap, n_out, law)
    if tgt.device.type != "cuda":
        raise ValueError(f"pp_short runs on CPU or CUDA tensors, got {tgt.device}")
    dev = tgt.device
    _check("tgt", tgt, torch.float32, (tgt.shape[0], 4), dev)
    _check("tgt_out", tgt_out, torch.int32, (tgt.shape[0],), dev)
    _check("src", src, torch.float32, (src.shape[0], 4), dev)
    _check("win", win, torch.int32, (win.shape[0], 2 + 2 * n_strips), dev)
    out = torch.zeros((n_out, 3), dtype=torch.float32, device=dev)
    if win.shape[0] == 0:
        return out
    runs, run_len = rr_runs(s_cap) if n_strips == 1 else (1, 0)
    part = torch.empty((runs, tgt.shape[0], 3), dtype=torch.float32, device=dev) if runs > 1 else None
    _launch("nbx_pp_short", [_P] * 6 + [_I] * 6 + _LAW, dev, tgt.data_ptr(), tgt_out.data_ptr(), src.data_ptr(),
            win.data_ptr(), out.data_ptr(), None if part is None else part.data_ptr(), tgt.shape[0], win.shape[0],
            n_strips, ITEM, runs, run_len, *law)
    pp_short.launches += 1
    return out


pp_short.launches = 0


# ---- K5 ----------------------------------------------------------------------------

def pp_react_reference(rows, row_out, feats, order, aff_start, aff_len, k: int, n_out: int, law):
    """Plain PyTorch version of K5 in the TPU kernel's column-sum form
    (nbx/ops/ppkernel.py:197-212): one pair evaluation per (residual row,
    affected kept lane) gives the forward force as a row sum and the
    reaction on the lane as a column sum, accumulated over chunks of rows.
    Rows past the live prefix are parked with mass 0 and add nothing.
    Arguments as pp_react."""
    dev = rows.device
    g = law[3]
    out = torch.zeros((n_out + 1, 3), dtype=torch.float32, device=dev)
    ar = torch.arange(k, device=dev)
    valid = (ar < aff_len[:, None]).reshape(-1)
    lanes = (aff_start[:, None].long() + ar).reshape(-1)
    lanes = torch.where(valid, lanes, 0)
    sj = feats[lanes]  # [S, 4]
    ms = torch.where(valid, sj[:, 3], 0.0)
    react = torch.zeros((lanes.shape[0], 3), dtype=torch.float32, device=dev)
    chunk = max(1, _pair_budget(dev) // max(lanes.shape[0], 1))
    for t0 in range(0, rows.shape[0], chunk):
        tr = rows[t0:t0 + chunk]
        d, r2 = _pairs(tr, sj)
        wbase = _law_base(r2, law)
        fwd = _row_sums(torch.where(ms > 0.0, wbase * ms, 0.0), d)
        o = row_out[t0:t0 + chunk].long()
        out[torch.where(o >= 0, o, n_out)] = g * fwd
        wr = wbase * tr[:, 3:4]
        react = react + torch.stack([-g * (wr * dc).sum(0) for dc in d], dim=-1)
    out[torch.where(valid, order[lanes].long(), n_out)] = react
    return out[:n_out]


def react_blocks(a: int, k: int) -> int:
    """K5's blocks for `a` affected cells of at most k kept bodies: the kept
    rows, a K, in blocks of REACT_ROWS."""
    return -(-a * k // REACT_ROWS)


def react_partial_bytes(m: int, a: int, k: int) -> tuple[int, int]:
    """Bytes of K5's float32 partials: the forward ones [react_blocks(a, k),
    m, 3] and the reactions' [REACT_SPLITS, react_blocks(a, k) REACT_ROWS,
    3]."""
    blocks = react_blocks(a, k)
    return blocks * m * 3 * 4, REACT_SPLITS * blocks * REACT_ROWS * 3 * 4


def _kept_rows(feats, order, aff_start, aff_len, k: int):
    """K5's kept rows: the affected cells' kept runs feats[aff_start[c] ..
    + aff_len[c]) one after another in cell order, then parked rows (mass 0,
    at the origin), react_blocks(A, k) REACT_ROWS of them, a size the host
    knows from the caps; their output rows (order[...], -1 for the parked
    ones) and the live count [] i32. Device ops alone: no count reaches the
    host."""
    n_rows = react_blocks(aff_start.shape[0], k) * REACT_ROWS
    lens = aff_len.long()
    ends = torch.cumsum(lens, 0)
    r = torch.arange(n_rows, device=feats.device)
    run = torch.searchsorted(ends, r, right=True).clamp(max=max(aff_start.shape[0] - 1, 0))
    n_live = lens.sum()
    live = r < n_live
    src = torch.where(live, aff_start.long()[run] + r - (ends - lens)[run], 0)
    kept = torch.where(live[:, None], feats[src], 0.0).contiguous()
    kept_out = torch.where(live, order[src].long(), -1).to(torch.int32).contiguous()
    return kept, kept_out, n_live.to(torch.int32)


@spanned("nbx.p3m.k5")
def pp_react(rows, row_out, feats, order, aff_start, aff_len, k: int, n_out: int, law):
    """K5: the residual rows against the kept runs of the affected cells,
    both directions. rows [M, 4] f32 (x, y, z, m) whose live rows are a
    prefix (the rest parked, mass 0), row_out [M] i32 (-1 past the prefix);
    feats [N, 4] the bodies in cell-sorted order, order [N] i32 (sorted
    position -> body); aff_start / aff_len [A] the affected cells' kept runs
    in that order (aff_len <= k, 0 for unused entries). Returns [n_out, 3]:
    the forward force on each live residual's row and the reaction
    -G sum_t wbase m_t d on each kept body's row. A CPU tensor runs the plain
    version; a CUDA tensor gathers the kept runs into one array
    (`_kept_rows`) and launches the kernel, one law evaluation a pair for
    both directions, and its combine (the forward partials in block order,
    the reactions in split order): one call, counted once."""
    if rows.device.type == "cpu":
        return pp_react_reference(rows, row_out, feats, order, aff_start, aff_len, k, n_out, law)
    if rows.device.type != "cuda":
        raise ValueError(f"pp_react runs on CPU or CUDA tensors, got {rows.device}")
    dev = rows.device
    m = rows.shape[0]
    _check("rows", rows, torch.float32, (m, 4), dev)
    _check("row_out", row_out, torch.int32, (m,), dev)
    out = torch.zeros((n_out, 3), dtype=torch.float32, device=dev)
    kept, kept_out, n_kept = _kept_rows(feats, order, aff_start, aff_len, k)
    if m == 0 or kept.shape[0] == 0:
        return out
    counts = torch.stack([(row_out >= 0).sum(dtype=torch.int32), n_kept])
    part = torch.empty((react_blocks(aff_start.shape[0], k), m, 3), dtype=torch.float32, device=dev)
    react = torch.empty((REACT_SPLITS, kept.shape[0], 3), dtype=torch.float32, device=dev)
    _launch("nbx_pp_react", [_P] * 8 + [_I] * 2 + _LAW, dev, rows.data_ptr(), row_out.data_ptr(), kept.data_ptr(),
            kept_out.data_ptr(), counts.data_ptr(), part.data_ptr(), react.data_ptr(), out.data_ptr(), m,
            kept.shape[0], *law)
    pp_react.launches += 1
    return out


pp_react.launches = 0


# ---- the passes -------------------------------------------------------------------
#
# Each pass is its inputs (`_main_pass`, `_rr_pass`, `_table_pass`: the
# arguments of one pp_short or pp_react call) and that call, so that a check
# on the card can hold the kernel against its plain version on the very
# arguments the pass gives it.

def _main_pass(pos, mass, G, a, box_size, n_cells, max_per_cell, eps, buckets, sort):
    """(pp_short arguments, n_overflow) of the main pass."""
    order, starts, _ = sort if sort is not None else cell_sort(pos, box_size, n_cells)
    feats = _sorted_rows(pos, mass, order)
    win, n_overflow = _main_items(starts, n_cells, max_per_cell, buckets)
    return (feats, order, feats, win, 27, max_per_cell, pos.shape[0], pp_law(eps, a, G)), n_overflow


def short_range_acc_kernel(pos, mass, G: float, a: float, box_size: float, n_cells: int,
                           max_per_cell: int = 16, eps: float = 0.0, buckets=None, sort=None):
    """The P3M main short-range pass on K4 (counterpart of the JAX package's
    `short_range_acc_pallas`): every kept body against the kept bodies of its
    27 neighbour cells, in the uniform layout or, with buckets (from
    pp_buckets_for), the occupancy-bucketed one, both in one launch. Returns
    ([N, 3] acc, n_overflow [] i32). `sort` reuses a `cell_sort` result."""
    args, n_overflow = _main_pass(pos, mass, G, a, box_size, n_cells, max_per_cell, eps, buckets,
                                  sort)
    return pp_short(*args), n_overflow


def _rr_pass(pos, mass, G, a, box_size, res_idx, res_valid, eps):
    """pp_short arguments of the residual-residual block."""
    rows, row_out = _residual_rows(pos, mass, box_size, res_idx, res_valid)
    m = rows.shape[0]
    n_live = res_valid.sum(dtype=torch.int32)
    ts = torch.arange(0, m, ITEM, device=pos.device)
    win = _items(ts, n_live - ts, torch.zeros_like(ts)[:, None], n_live.expand(ts.shape[0], 1), ITEM)
    return rows, row_out, rows, win, 1, m, pos.shape[0], pp_law(eps, a, G)


def residual_rr_dense_kernel(pos, mass, G: float, a: float, box_size: float, res_idx, res_valid,
                             eps: float = 0.0) -> torch.Tensor:
    """The exact dense residual-residual block on K4 (counterpart of the JAX
    package's `residual_rr_dense_pallas`): every live residual against every
    live residual (both ordered copies present, so no reaction term; self
    pairs masked by r^2 > 0). Returns an [N, 3] delta."""
    return pp_short(*_rr_pass(pos, mass, G, a, box_size, res_idx, res_valid, eps))


def _table_pass(pos, mass, G, a, box_size, n_cells, max_per_cell, res_idx, res_valid, eps,
                affected_cap, sort):
    """(pp_react arguments, n_missed) of the residual-versus-table pass."""
    g, k = n_cells, max_per_cell
    c_total = g * g * g
    order, starts, _ = sort if sort is not None else cell_sort(pos, box_size, g)
    cnt = starts[1:] - starts[:-1]

    aff = _dilate27((cnt > k).reshape(g, g, g)).reshape(-1)
    aff_idx, av = take_rows(aff, affected_cap)
    lost = aff & (torch.cumsum(aff.to(torch.int32), 0) - 1 >= affected_cap)
    kept = torch.clamp(cnt, max=k)
    near_lost = _dilate27(lost.reshape(g, g, g)).reshape(-1)
    n_missed = (torch.where(lost, kept, 0).sum(dtype=torch.int32)
                + torch.where(near_lost, torch.clamp(cnt - k, min=0), 0).sum(dtype=torch.int32))

    aff_c = torch.clamp(aff_idx, max=c_total - 1).long()
    rows, row_out = _residual_rows(pos, mass, box_size, res_idx, res_valid)
    args = (rows, row_out, _sorted_rows(pos, mass, order), order, starts[aff_c],
            torch.where(av, kept[aff_c], 0), k, pos.shape[0], pp_law(eps, a, G))
    return args, n_missed


def residual_table_acc_kernel(pos, mass, G: float, a: float, box_size: float, n_cells: int,
                              max_per_cell: int, res_idx, res_valid, eps: float = 0.0,
                              affected_cap: int = 256, sort=None):
    """Residual-versus-table short-range correction on K5 (counterpart of the
    JAX package's `residual_table_acc_pallas`): each residual against the
    kept bodies of every affected cell (the 27-dilation of the overflowing
    cells, a superset of its own neighbourhood whose extra pairs carry
    erfc(>3) ~ 2e-5 weights), and each such kept body the reaction.
    Affected cells past affected_cap lose both directions, counted in
    n_missed: their kept bodies plus the residuals of their 27-dilation.
    Returns ([N, 3] delta, n_missed [] i32)."""
    args, n_missed = _table_pass(pos, mass, G, a, box_size, n_cells, max_per_cell, res_idx,
                                 res_valid, eps, affected_cap, sort)
    return pp_react(*args), n_missed
