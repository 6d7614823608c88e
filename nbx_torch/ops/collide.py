"""Cell-binned collision pass at scale: every layout of the JAX package's
`binned_collision_pass` (`nbx/ops/collide.py`) on one fused collision kernel.

Physics per overlapping pair, as in `_collide_fused_body` of the JAX package:
restitution impulse and friction impulse through the reduced mass, Baumgarte
push (0.8), impact heating (0.2 E, E = mu/2 vn^2), bounce count, and each
target's deepest-overlap partner (largest depth, ties to the smallest body
id).

All N bodies, dead ones included, are cell-sorted with k minor
(`ops.p3m.cell_sort`), so a window of B cells of one (i, j) column, and the
guarded (B + 2)-cell source strip around it, are each one contiguous run of
the sorted order. A window is then one int32 descriptor (target start and
count, 9 neighbour-strip starts and lengths), and the kernel reads the sorted
bodies itself and writes each target's result straight to body order. The
layouts differ in which bodies they keep and what they count into
n_overflow; each keeps the JAX package's kept set and counters:

  * full column (band_cells=None, the TPU kernel K8) and banded per-cell caps
    (band_cells=B): the first max_per_cell bodies of each cell by the stable
    cell sort (`cell_bin`'s kept set) are copied into a kept-only sorted
    order, where a B-cell window and its guarded strips are contiguous runs
    again; a body past the cap is neither target nor source. n_overflow is
    the number of such bodies. Full column is B = g: the guarded strip
    clamps to the whole column, the pair set of K8's 9 column visits;
  * bucketed (buckets=...): each occupied window goes to the first bucket
    whose caps cover its target count and its largest neighbour-strip run; a
    window past a bucket's budget spills to the next bucket, and only the
    last bucket drops windows. Targets are the first min(count, t_rows)
    bodies of the window's run; sources are, per neighbour strip, the first
    min(run, s_capw) bodies, masked by the global symmetric-drop mask `t_ok`
    (a body without a target slot is no source either). n_overflow counts
    dropped windows' bodies, target rows past t_rows and source lanes past
    s_capw in each selected window's 9 strips;
  * occupancy-compacted (packed_caps and max_blocks): the one-bucket case of
    the bucketed layout, bucket (t_cap, s_cap, max_blocks);
  * band-packed (packed_caps alone): every window at caps (t_cap, s_cap); the
    same kept set as one bucket whose budget holds every window, but the
    source overflow is counted once per (column, band)'s own guarded strip,
    not once per use.

The spatial halo-exchange step's local entries (`packed_collision_blocks_local`,
`bucketed_collision_blocks_local`) run the band-packed and bucketed layouts on
a rank's local slab grid (`cell_sort_slabgrid`): target windows over its owned
columns, source strips over every local column, halo rows sources only. With
short gravity they launch the kernel's gravity-fused instantiation (the TPU
kernel K7), which also sums the P3M erfc short range over every lane of each
window. They return body-order rows like the pass here, so the JAX package's
slot arrays and its `epilogue_rows` gather have no counterpart. The
all-gather paths' column-slab entry (`packed_collision_blocks_slab`) runs
the band-packed layout over a slab of the whole grid's columns, every body
a source, with rows outside the slab left as the identity of the
reduction over the slabs.

What does not carry over from the TPU: the materialised [blocks, 16, S]
source blocks, K8's 9 scalar-prefetch-driven revisits of each column, the
whole-grid strips table, the "grid"/"slice" strip constructions (the
argument is accepted and changes nothing, as it changes no result in the
JAX package), the 128-lane padding and the dead padding row.

`collide_fused` (windowed layouts), `collide_full_column` (the full-column
layout), `collide_fused_multi` (windows_per_block > 1, the TPU kernel
K2m), `collide_fused_grav` (the spatial step's local entries with short
gravity, the TPU kernel K7) and `collide_fused_slab` (the column-slab
entry) launch the kernel of
`nbx_torch/csrc/collide_fused.cu` on CUDA tensors and run
`collide_fused_reference`, its plain PyTorch version, on CPU tensors; a CUDA
call launches the kernel or raises. Each counts its launches in `.launches`.
The kernel sums each target's pairs run by run (runs of RUN lanes of the
window's fused lane sequence, added in run order), so every launch shape
(`launch_shape`) gives each target the same bits.

Host-side sizing (`bucketed_layout_for`, `packed_caps_for`,
`packed_layout_for`, ...) is numpy and gives the same integers as the JAX
package for the same positions. Nothing on the device side reads a value
back to the host.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from nbx_torch.config import f32
from nbx_torch.ops import _build
from nbx_torch.ops.p3m import cell_size, cell_sort, pp_law, take_rows
from nbx_torch.ops.ppkernel import _law_base
from nbx_torch.profiling import span, spanned

LANE = 128  # the JAX package's lane width; only its sizing guards use it
CORRECTION = 0.8  # Baumgarte factor
HEAT_FRACTION = 0.2  # impact heating fraction
DEPTH_SENTINEL = -1e30
WIN_INTS = 20  # window descriptor: ts, tn, 9 x (strip start, strip length)
CONSTRUCTIONS = ("auto", "grid", "slice")  # the JAX package's strip constructions

_KERNEL = "collide_fused"
_PAIR_BUDGET = 1 << 22  # pair lanes per chunk of the plain version

# The kernel's launch shape (csrc/collide_fused.cu). RUN (kRun) is the fold's
# unit and never changes with the launch; the rest chooses how the units
# (window, group of 32 x targets_a_thread targets) spread over warps.
# The values are the fastest measured on an H100 (PERF.md, section 6).
RUN = 128  # lanes a run
WARPS = 8  # most warps a block (kMaxWarps)
TARGETS_A_THREAD = 2  # K2's R for windows of 33 to FULL_ROWS - 1 target rows
FULL_ROWS = 256  # from this many target rows (full columns) R = 1: more, shorter units
TEAMS = 4  # one-warp teams a block where a launch has many units
TAIL_UNITS = 1024  # below this many units a unit takes TAIL_WARPS warps
TAIL_WARPS = 4  # warps a unit in the tail: its runs spread over them


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


# ---- host-side sizing (numpy) ----------------------------------------------

def _host_starts(pos, box_size: float, n_cells: int) -> np.ndarray:
    """cell_sort's `starts` [g^3 + 1], computed on the host from the cell
    histogram (the order within a cell does not change any count)."""
    if isinstance(pos, torch.Tensor):
        pos = pos.detach().cpu().numpy()
    pos = np.asarray(pos, np.float32)
    g = n_cells
    h = np.float32(cell_size(box_size, g))
    ijk = np.clip((pos / h).astype(np.int32), 0, g - 1).astype(np.int64)
    cid = (ijk[:, 0] * g + ijk[:, 1]) * g + ijk[:, 2]
    counts = np.bincount(cid, minlength=g * g * g)
    return np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)


def _window_counts(pos, box_size: float, n_cells: int, band_cells: int):
    """Per-(column, band) occupancies of target windows and guarded source
    strips, numpy [n_cols, n_bands]."""
    g = n_cells
    b = band_cells
    n_bands = -(-g // b)
    st = _host_starts(pos, box_size, g)
    cols = np.arange(g * g, dtype=np.int64)
    w = np.arange(n_bands, dtype=np.int64)
    cnt_t = (
        st[cols[:, None] * g + np.minimum(w[None, :] * b + b, g)]
        - st[cols[:, None] * g + w[None, :] * b]
    )
    cnt_s = (
        st[cols[:, None] * g + np.minimum(w[None, :] * b + b + 1, g)]
        - st[cols[:, None] * g + np.maximum(w[None, :] * b - 1, 0)]
    )
    return cnt_t, cnt_s


def _window_max_strip_runs(pos, box_size: float, n_cells: int, band_cells: int,
                           cnt_s=None) -> np.ndarray:
    """Per-window largest guarded-strip run over the 9 neighbour columns,
    numpy [n_cols, n_bands]: what a bucket's per-strip source cap must
    cover."""
    g = n_cells
    if cnt_s is None:
        _, cnt_s = _window_counts(pos, box_size, n_cells, band_cells)
    n_bands = cnt_s.shape[1]
    cs = np.concatenate([cnt_s, np.zeros((1, n_bands), cnt_s.dtype)], axis=0)
    cc = np.arange(g * g)
    ci, cj = cc // g, cc % g
    m = np.zeros_like(cnt_s)
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            ni, nj = ci + di, cj + dj
            ok = (ni >= 0) & (ni < g) & (nj >= 0) & (nj < g)
            m = np.maximum(m, cs[np.where(ok, ni * g + nj, g * g)])
    return m


def bucket_flags_host(cnt_t, maxrun, caps):
    """First-covering-bucket window assignment, numpy bool arrays per bucket
    (budgets ignored): the rule `_bucket_windows` applies on the device."""
    occ = cnt_t > 0
    remaining = occ
    out = []
    for bi, (t, sc, _) in enumerate(caps):
        fl = remaining if bi == len(caps) - 1 else remaining & (cnt_t <= t) & (maxrun <= sc)
        remaining = remaining & ~fl
        out.append(fl)
    return out


def bucketed_layout_for(
    pos,
    box_size: float,
    n_cells: int,
    band_cells: int,
    split_quantile: float = 0.8,
    slack: float = 1.25,
    block_slack: float = 1.3,
    max_source_lanes: int = 8192,
    max_block_pair_lanes: int = 2 * 1024 * 1024,
) -> tuple[tuple[int, int, int], ...]:
    """Size a two-bucket layout for binned_collision_pass(buckets=...) from
    this frame's window occupancy: ((t_cap1, s_cap1, max_blocks1),
    (t_cap2, s_cap2, max_blocks2)). Bucket 1 takes every occupied window
    whose target count and largest neighbour-strip run fit caps at
    `split_quantile` of the occupied distribution; bucket 2 takes the tail at
    max-sized caps. Host-side, Python ints: call once per scene, or again
    when n_overflow goes nonzero. Raises where the JAX package raises (its
    bounds are TPU compile bounds, kept so both packages accept the same
    configurations)."""
    cnt_t, cnt_s = _window_counts(pos, box_size, n_cells, band_cells)
    maxrun = _window_max_strip_runs(pos, box_size, n_cells, band_cells, cnt_s=cnt_s)
    occ = cnt_t > 0
    if not occ.any():
        return ((8, 8, 8), (8, 8, 8))
    oc, orun = cnt_t[occ], maxrun[occ]

    def cap(v):
        return max(8, int(np.ceil(v * slack)))

    t1 = cap(np.quantile(oc, split_quantile))
    s1 = cap(np.quantile(orun, split_quantile))
    t2 = cap(oc.max())
    s2 = cap(orun.max())
    in1, in2 = bucket_flags_host(cnt_t, maxrun, ((t1, s1, 0), (t2, s2, 0)))
    if 9 * s2 > max_source_lanes:
        raise ValueError(
            f"bucketed tail caps ({t2}, {s2}) need {9 * s2} fused source"
            f" lanes (> {max_source_lanes}). Use a finer n_cells."
        )
    t2r = _round_up(max(t2, 8), 8)
    s2r = _round_up(9 * max(s2, 8), LANE)
    if t2r * s2r > max_block_pair_lanes:
        raise ValueError(
            f"bucketed tail block ({t2r} x {s2r}) exceeds"
            f" {max_block_pair_lanes} pair lanes per window. Use a finer n_cells."
        )

    def budget(k):
        return max(8, -(-int(np.ceil(k * block_slack)) // 8) * 8)

    return (
        (t1, s1, budget(int(in1.sum()))),
        (t2, s2, budget(int(in2.sum()))),
    )


def _cap_pick(cnt: np.ndarray, quantile: float, slack: float) -> int:
    """A cap covering the occupied entries of cnt (their max, or their
    `quantile`) with `slack` headroom, at least 8."""
    occ = cnt[cnt > 0]
    if occ.size == 0:
        return 8
    v = occ.max() if quantile >= 1.0 else np.quantile(occ, quantile)
    return max(8, int(np.ceil(v * slack)))


def packed_caps_for(
    pos,
    box_size: float,
    n_cells: int,
    band_cells: int,
    slack: float = 1.25,
    quantile: float = 1.0,
    max_source_lanes: int = 4096,
) -> tuple[int, int]:
    """packed_caps = (t_cap, s_cap) for the band-packed layout, covering this
    frame's target windows and guarded strips (their max, or their occupancy
    `quantile`: bounded work at the price of counted overflow) with `slack`
    headroom. Host-side, Python ints: call once per scene, or again when
    n_overflow goes nonzero. Raises, as the JAX package does, when the caps
    need more than max_source_lanes fused source lanes: occupancy too peaked
    for uniform window caps (use the banded per-cell-cap layout, a lower
    quantile or a finer n_cells)."""
    cnt_t, cnt_s = _window_counts(pos, box_size, n_cells, band_cells)
    t_cap, s_cap = _cap_pick(cnt_t, quantile, slack), _cap_pick(cnt_s, quantile, slack)
    if 9 * s_cap > max_source_lanes:
        occ_frac = float((cnt_t > 0).mean())
        raise ValueError(
            f"packed caps ({t_cap}, {s_cap}) need {9 * s_cap} fused source"
            f" lanes (> {max_source_lanes}): occupancy is too peaked for"
            f" uniform window caps ({occ_frac:.1%} of windows occupied)."
            " Use the banded per-cell-cap layout (band_cells without"
            " packed_caps), a lower quantile=, or a finer n_cells."
        )
    return t_cap, s_cap


def packed_layout_for(
    pos,
    box_size: float,
    n_cells: int,
    band_cells: int,
    slack: float = 1.25,
    quantile: float = 1.0,
    block_slack: float = 1.3,
    max_source_lanes: int = 8192,
    max_block_pair_lanes: int = 2 * 1024 * 1024,
) -> dict:
    """An occupancy-compacted configuration for this frame:
    dict(packed_caps=(t_cap, s_cap), max_blocks, occupied, occupied_frac).
    Caps as packed_caps_for; max_blocks covers the occupied windows with
    `block_slack` headroom for bodies moving into empty windows. Host-side,
    Python ints. Raises where the JAX package raises (its bounds are TPU
    compile bounds, kept so both packages accept the same configurations)."""
    cnt_t, cnt_s = _window_counts(pos, box_size, n_cells, band_cells)
    t_cap, s_cap = _cap_pick(cnt_t, quantile, slack), _cap_pick(cnt_s, quantile, slack)
    if 9 * s_cap > max_source_lanes:
        raise ValueError(
            f"compacted packed caps ({t_cap}, {s_cap}) need {9 * s_cap}"
            f" fused source lanes (> {max_source_lanes}). Use a finer n_cells"
            " or a lower quantile."
        )
    t_rows = _round_up(max(t_cap, 8), 8)
    s_rows = _round_up(max(9 * s_cap, 9 * 8), LANE)
    if t_rows * s_rows > max_block_pair_lanes:
        raise ValueError(
            f"compacted packed block ({t_rows} x {s_rows}) ="
            f" {t_rows * s_rows} pair lanes per window"
            f" (> {max_block_pair_lanes}). Use a finer n_cells (smaller"
            " windows) or a lower quantile."
        )
    occupied = int((cnt_t > 0).sum())
    max_blocks = max(8, -(-int(np.ceil(occupied * block_slack)) // 8) * 8)
    return dict(
        packed_caps=(t_cap, s_cap),
        max_blocks=max_blocks,
        occupied=occupied,
        occupied_frac=occupied / int(cnt_t.size),
    )


# ---- device-side layout -----------------------------------------------------

def _column_neighbors_of(cc: torch.Tensor, g: int) -> torch.Tensor:
    """9-neighbourhood column ids [..., 9] (int64) of column ids cc, in the
    JAX package's (di, dj) order; offsets off the grid -> g * g."""
    ci, cj = cc // g, cc % g
    neigh = []
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            ni, nj = ci + di, cj + dj
            ok = (ni >= 0) & (ni < g) & (nj >= 0) & (nj < g)
            neigh.append(torch.where(ok, ni * g + nj, g * g))
    return torch.stack(neigh, dim=-1)


def _bucket_block_geom(t_cap: int, s_cap: int) -> tuple[int, int]:
    """(t_rows, s_capw): target rows and per-strip source lanes a window of
    the bucket keeps."""
    return _round_up(max(t_cap, 8), 8), max(s_cap, 8)


class _Grid(NamedTuple):
    """The column grid of a cell sort and the columns that hold target
    windows: the whole g x g grid, or the spatial step's local slab grid,
    whose owned columns are targets and whose halo columns are sources only."""

    n_cols: int  # columns of the grid
    cols: torch.Tensor  # [n_tc] int64 target columns
    neigh: torch.Tensor  # [n_tc, 9] int64 their 9 neighbour columns, n_cols = off the grid
    rank: torch.Tensor  # [n_cols + 1] int64 a column's rank in `cols`, -1 if it holds no targets


def _whole_grid(g: int, dev) -> _Grid:
    cols = torch.arange(g * g, device=dev)
    return _Grid(g * g, cols, _column_neighbors_of(cols, g), torch.cat([cols, cols.new_full((1,), -1)]))


def _column_slab_grid(g: int, col_lo: int, n_slab_cols: int, dev) -> _Grid:
    """Target columns [col_lo, col_lo + n_slab_cols) of the whole g x g grid
    (column id i g + j), with their whole-grid neighbours: the other columns
    are sources only."""
    cols = col_lo + torch.arange(n_slab_cols, device=dev)
    rank = torch.full((g * g + 1,), -1, dtype=torch.int64, device=dev)
    rank[cols] = torch.arange(n_slab_cols, device=dev)
    return _Grid(g * g, cols, _column_neighbors_of(cols, g), rank)


def _column_neighbors_rect(gx: int, gy: int, device="cpu") -> torch.Tensor:
    """9-neighbourhood column ids [gx * gy, 9] (int64) on a rectangular
    (x, y) column grid, in the JAX package's (di, dj) order (the tie-break's
    layout invariance); offsets off the grid -> gx * gy."""
    cc = torch.arange(gx * gy, device=device)
    ci, cj = cc // gy, cc % gy
    neigh = []
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            ni, nj = ci + di, cj + dj
            ok = (ni >= 0) & (ni < gx) & (nj >= 0) & (nj < gy)
            neigh.append(torch.where(ok, ni * gy + nj, gx * gy))
    return torch.stack(neigh, dim=1)


def _slab_grid(w_x: int, w_y: int, gy: int, two_d: bool, dev) -> _Grid:
    """The local slab grid of `cell_sort_slabgrid`: [w_x + 2, gy] columns
    whose owned columns are x layers [1, w_x + 1), and with two_d y layers
    [1, w_y + 1) too (gy = w_y + 2), in the JAX package's order (x major)."""
    gx = w_x + 2
    if two_d:
        ox = 1 + torch.arange(w_x, device=dev)
        oy = 1 + torch.arange(w_y, device=dev)
        cols = (ox[:, None] * gy + oy[None, :]).reshape(-1)
    else:
        cols = gy + torch.arange(w_x * gy, device=dev)
    rank = torch.full((gx * gy + 1,), -1, dtype=torch.int64, device=dev)
    rank[cols] = torch.arange(cols.shape[0], device=dev)
    return _Grid(gx * gy, cols, _column_neighbors_rect(gx, gy, dev)[cols], rank)


def _window_tables(starts: torch.Tensor, g: int, b: int, grid: _Grid):
    """Every (column, band) window of the grid's target columns, for a
    cell-sorted order with cell runs starts [n_cols g + 1]: (ts [n_tc,
    n_bands] target start, cnt [n_tc, n_bands] target count, ss9 [n_tc,
    n_bands, 9] and run9 [n_tc, n_bands, 9] the start and length of each
    neighbour column's guarded strip), int64. Off-grid neighbours have empty
    strips."""
    dev = starts.device
    g3 = grid.n_cols * g
    n_bands = -(-g // b)
    st = starts.long()
    cols = grid.cols
    w_r = torch.arange(n_bands, device=dev)
    ts_tab = st[cols[:, None] * g + w_r[None, :] * b]
    cnt_t = st[cols[:, None] * g + torch.clamp(w_r[None, :] * b + b, max=g)] - ts_tab
    lo = torch.clamp(w_r * b - 1, min=0)  # guarded strip cells [lo, hi)
    hi = torch.clamp(w_r * b + b + 1, max=g)
    neigh = grid.neigh[:, None, :]  # [n_tc, 1, 9]
    okn = neigh < grid.n_cols
    ss9 = st[torch.where(okn, neigh * g + lo[None, :, None], g3)]
    run9 = st[torch.where(okn, neigh * g + hi[None, :, None], g3)] - ss9
    return ts_tab, cnt_t, ss9, run9


def _descriptors(ts, tn, ss9, run9) -> torch.Tensor:
    """Window descriptors [W, 20] i32 from per-window target starts and
    counts [W] and strip starts and lengths [W, 9]."""
    strips = torch.stack([ss9, run9], dim=-1).reshape(-1, 18)
    return torch.cat([ts.reshape(-1, 1), tn.reshape(-1, 1), strips], dim=1).to(torch.int32).contiguous()


@spanned("nbx.collide.windows")
def _bucket_windows(starts, cid_sorted, n: int, g: int, b: int, buckets, src_over: str = "uses",
                    grid: _Grid | None = None):
    """Window descriptors of every bucket over the target columns of `grid`
    (default: the whole g x g grid), the symmetric-drop mask and the
    overflow count. src_over says how source lanes past s_capw are counted:
    "uses", in each selected window's 9 strips (bucketed, compacted); "own",
    once per selected window's own strip (the spatial step's bucketed local
    layout); "own_all", once per (column, band)'s own strip, whether its
    window holds targets or not (band-packed, global and local). A row in a
    column without targets (the local grid's halo) is a source if its rank
    in its own (column, band) window is below the last bucket's t_rows, as
    the JAX package's local and slab entries decide it (for a column slab of
    the whole grid, that is its whole-grid window rank); rows parked past
    the grid are neither.

    Returns ([(win [bmax, 20] i32, t_rows, s_capw) per bucket],
    t_ok [n] bool over sorted positions, n_overflow [] i32)."""
    dev = starts.device
    if grid is None:
        grid = _whole_grid(g, dev)
    n_bands = -(-g // b)
    ts_tab, cnt_t, ss9, run9 = _window_tables(starts, g, b, grid)
    maxrun = run9.amax(2)

    # bucket assignment: first covering bucket; over-budget windows spill to
    # the next bucket, and only the last one drops
    sels, flags = [], []
    remaining = cnt_t > 0
    for bi, (t_cap, s_cap, bmax) in enumerate(buckets):
        if bi == len(buckets) - 1:
            fl = remaining
        else:
            fl = remaining & (cnt_t <= t_cap) & (maxrun <= s_cap)
        flf = fl.reshape(-1)
        wrank = torch.cumsum(flf.long(), 0) - 1
        sel = flf & (wrank < bmax)
        remaining = remaining & ~sel.reshape(cnt_t.shape)
        sels.append(sel)
        flags.append(flf)

    # symmetric-drop mask over sorted positions: a target row is a source
    # only if it holds a target slot in some bucket
    cs = cid_sorted.long()
    col_s = cs // g  # n_cols for parked rows
    w_own = torch.clamp(cs - col_s * g, max=g - 1) // b
    rel = grid.rank[col_s]
    owned = rel >= 0
    col_rel = rel.clamp(min=0)
    f_own = col_rel * n_bands + w_own
    p_r = torch.arange(n, device=dev)
    rank_t = p_r - ts_tab[col_rel, w_own]
    t_ok = torch.zeros(n, dtype=torch.bool, device=dev)
    for sel, (t_cap, s_cap, _) in zip(sels, buckets):
        t_rows, _ = _bucket_block_geom(t_cap, s_cap)
        t_ok = t_ok | (owned & sel[f_own] & (rank_t < t_rows))
    if grid.cols.shape[0] < grid.n_cols:  # source-only (halo, or other slabs') columns
        g3 = grid.n_cols * g
        rank_w = p_r - starts.long()[torch.clamp(col_s * g + w_own * b, max=g3)]
        t_last, _ = _bucket_block_geom(*buckets[-1][:2])
        t_ok = t_ok | (~owned & (col_s < grid.n_cols) & (rank_w < t_last))

    n_overflow = torch.zeros((), dtype=torch.int64, device=dev)
    cnt_flat = cnt_t.reshape(-1)
    out = []
    for bi, ((t_cap, s_cap, bmax), flf, sel) in enumerate(zip(buckets, flags, sels)):
        t_rows, s_capw = _bucket_block_geom(t_cap, s_cap)
        if bi == len(buckets) - 1:
            n_overflow = n_overflow + torch.where(flf & ~sel, cnt_flat, 0).sum()
        wsel, wvalid = take_rows(sel, bmax)
        wsel = wsel.long()
        col_sel = wsel // n_bands
        w_sel = wsel - col_sel * n_bands
        cnt_sel = torch.where(wvalid, cnt_t[col_sel, w_sel], 0)
        n_overflow = n_overflow + torch.clamp(cnt_sel - t_rows, min=0).sum()
        run_sel = torch.where(wvalid[:, None], run9[col_sel, w_sel], 0)
        if src_over == "own_all":  # the centre of the 9 neighbours is the window's own column
            n_overflow = n_overflow + torch.clamp(run9[..., 4] - s_capw, min=0).sum()
        elif src_over == "own":
            n_overflow = n_overflow + torch.clamp(run_sel[:, 4] - s_capw, min=0).sum()
        else:
            n_overflow = n_overflow + torch.clamp(run_sel - s_capw, min=0).sum()
        win = _descriptors(ts_tab[col_sel, w_sel], torch.clamp(cnt_sel, max=t_rows), ss9[col_sel, w_sel],
                           torch.clamp(run_sel, max=s_capw))
        out.append((win, t_rows, s_capw))
    return out, t_ok, n_overflow.to(torch.int32)


def _kept_windows(pos, box_size: float, g: int, b: int, k: int):
    """The per-cell-cap layouts' windows: the first k bodies of each cell by
    the stable cell sort are copied into a kept-only sorted order, and every
    (column, band) window of b cells gets a descriptor into it.

    Returns (order_k [n] i32 kept position -> body id (rows past the kept
    bodies are never read), win [n_cols * n_bands, 20] i32, t_rows, s_capw
    (the largest target count and strip length a window can hold),
    n_overflow [] i32 the bodies past k in their cells)."""
    n = pos.shape[0]
    order, starts, cid_sorted = cell_sort(pos, box_size, g)
    cid = cid_sorted.long()
    st = starts.long()
    kstarts = torch.cat([st.new_zeros(1), torch.cumsum(torch.clamp(st[1:] - st[:-1], max=k), 0)])
    rank = torch.arange(n, device=pos.device) - st[cid]
    keep = rank < k
    dest = torch.where(keep, kstarts[cid] + rank, n)
    order_k = order.new_zeros(n + 1)
    order_k[dest] = order  # dropped bodies all land on the spare row n
    ts_tab, cnt_t, ss9, run9 = _window_tables(kstarts, g, b, _whole_grid(g, pos.device))
    win = _descriptors(ts_tab, cnt_t, ss9, run9)
    return order_k[:n], win, b * k, min(b + 2, g) * k, n - keep.sum(dtype=torch.int32)


# ---- K2: the kernel and its plain version ----------------------------------

def collide_fused_reference(
    feats: torch.Tensor,  # [n, 8] f32 cell-sorted: x y z vx vy vz m r
    order: torch.Tensor,  # [n] i32 sorted position -> body id
    src_ok: torch.Tensor,  # [n] bool sorted position may be a source
    win: torch.Tensor,  # [W, 20] i32 window descriptors
    out_d: torch.Tensor,  # [n, 8] f32 body order, written for each target
    out_j: torch.Tensor,  # [n] i32 body order, written for each target
    restitution: float,
    friction: float,
    t_rows: int,
    s_capw: int,
    short_gravity: tuple[float, float, float] | None = None,  # (G, a, eps): K7's gravity sum
    out_g: torch.Tensor | None = None,  # [n, 3] f32 body order, written for each target
) -> None:
    """Plain PyTorch version of the kernel: the same windows, kept set and
    pair math, over [windows, T, 9 S] pair tensors in chunks of windows of at
    most _PAIR_BUDGET pair lanes, T and S the largest target count and strip
    length these windows hold (at most t_rows and s_capw; read on the host).
    Windows without targets are skipped. Writes each target's delta row (dvx
    dvy dvz dpx dpy dpz heat n_bounce) and partner (-1 = none) to body order;
    other rows are left as they are. With short_gravity = (G, a, eps), also
    writes each target's P3M short-range gravity G sum_j w_ij d_ij (K7) to
    out_g, summed over every lane where both masses are > 0, the ids differ
    and r^2 > 0."""
    n = feats.shape[0]
    win = win[win[:, 1] > 0]
    n_win = win.shape[0]
    if n_win == 0 or n == 0:
        return
    dev = feats.device
    t_rows = max(1, min(t_rows, int(win[:, 1].max())))
    s_capw = max(1, min(s_capw, int(win[:, 3::2].max())))
    s_all = 9 * s_capw
    one_e = f32(1.0 + f32(restitution))
    fric = f32(friction)
    ids = order.long()
    ar_t = torch.arange(t_rows, device=dev)
    ar_s = torch.arange(s_capw, device=dev)
    d_pad = torch.cat([out_d, out_d.new_zeros((1, 8))])
    j_pad = torch.cat([out_j, out_j.new_full((1,), -1)])
    if short_gravity is not None:
        G, a, eps = short_gravity
        law = pp_law(eps, a, G)  # (eps^2, 1/a, 2 / (a sqrt(pi)), G) in float32, as `_collide_par` forms them
        g_pad = torch.cat([out_g, out_g.new_zeros((1, 3))])
    chunk = max(1, _PAIR_BUDGET // (t_rows * s_all))
    for w0 in range(0, n_win, chunk):
        wd = win[w0:w0 + chunk].long()
        nw = wd.shape[0]
        vt = ar_t[None, :] < wd[:, 1:2]  # [nw, T]
        pt = torch.where(vt, wd[:, 0:1] + ar_t, 0)
        vs = ar_s[None, None, :] < wd[:, 3::2, None]  # [nw, 9, s_capw]
        ps = torch.where(vs, wd[:, 2::2, None] + ar_s, 0).reshape(nw, s_all)
        vs = vs.reshape(nw, s_all) & src_ok[ps]
        ti, sj = feats[pt], feats[ps]  # [nw, T, 8], [nw, S, 8]
        xi, yi, zi = ti[..., 0:1], ti[..., 1:2], ti[..., 2:3]
        vxi, vyi, vzi = ti[..., 3:4], ti[..., 4:5], ti[..., 5:6]
        mi, ri, gi = ti[..., 6:7], ti[..., 7:8], ids[pt][..., None]
        xj, yj, zj = sj[:, None, :, 0], sj[:, None, :, 1], sj[:, None, :, 2]
        vxj, vyj, vzj = sj[:, None, :, 3], sj[:, None, :, 4], sj[:, None, :, 5]
        mj = torch.where(vs, sj[..., 6], 0.0)[:, None, :]
        rj, gj = sj[:, None, :, 7], ids[ps][:, None, :]

        dx, dy, dz = xj - xi, yj - yi, zj - zi  # [nw, T, S], i -> j
        r2 = dx * dx + dy * dy + dz * dz
        min_d = ri + rj
        overlap = (mi > 0.0) & (mj > 0.0) & (gi != gj) & (r2 < min_d * min_d)
        inv_dist = torch.rsqrt(torch.where(r2 > 0.0, r2, 1.0))
        dist = r2 * inv_dist
        rvx, rvy, rvz = vxj - vxi, vyj - vyi, vzj - vzi
        vn = (rvx * dx + rvy * dy + rvz * dz) * inv_dist
        appr = overlap & (vn < 0.0)
        m_sum = mi + mj
        r_ms = 1.0 / torch.where(m_sum > 0.0, m_sum, 1.0)
        mu_g = torch.where(appr, mi * mj * r_ms, 0.0)
        tvn = vn * mu_g
        j_imp = -one_e * tvn
        ft = fric * mu_g
        a2 = (j_imp + ft * vn) * inv_dist
        c2 = (min_d - dist) * inv_dist * (CORRECTION * mu_g)
        sums = [
            (a2 * dx - ft * rvx).sum(-1), (a2 * dy - ft * rvy).sum(-1),
            (a2 * dz - ft * rvz).sum(-1),
            (c2 * dx).sum(-1), (c2 * dy).sum(-1), (c2 * dz).sum(-1),
            (0.5 * vn * tvn).sum(-1), appr.sum(-1).to(torch.float32),
        ]
        if short_gravity is not None:
            wg = torch.where((mi > 0.0) & (mj > 0.0) & (gi != gj), mj * _law_base(r2, law), 0.0)
            grav = torch.stack([(wg * dx).sum(-1), (wg * dy).sum(-1), (wg * dz).sum(-1)], dim=-1) * law[3]
        depth = torch.where(overlap, min_d - dist, DEPTH_SENTINEL)
        dm = depth.amax(-1)
        big = torch.iinfo(torch.int64).max
        js = torch.where(depth >= dm[..., None], gj, big).amin(-1)
        jsel = torch.where(dm > 0.0, js, -1)

        m_t = mi[..., 0]
        sc = torch.where(m_t > 0.0, 1.0 / torch.where(m_t > 0.0, m_t, 1.0), 0.0)
        delta = torch.stack(
            [-s * sc for s in sums[:6]] + [sums[6] * sc * HEAT_FRACTION, sums[7]], dim=-1
        )
        body = torch.where(vt, ids[pt], n).reshape(-1)
        d_pad[body] = delta.reshape(-1, 8)
        j_pad[body] = jsel.reshape(-1).to(torch.int32)
        if short_gravity is not None:
            g_pad[body] = grav.reshape(-1, 3)
    out_d.copy_(d_pad[:n])
    out_j.copy_(j_pad[:n])
    if short_gravity is not None:
        out_g.copy_(g_pad[:n])


class LaunchShape(NamedTuple):
    targets_a_thread: int  # R
    groups: int  # units a window: groups of 32 R targets
    windows_per_block: int  # windows of one group a block
    team_warps: int  # warps that share a unit, its runs spread over them
    teams: int  # teams a block
    blocks: int


def launch_shape(n_win: int, t_rows: int, windows_per_block: int = 1, grav: bool = False) -> LaunchShape:
    """How a launch of n_win windows of at most t_rows targets spreads over
    the card: R targets a thread (TARGETS_A_THREAD; 1 where a warp's 32
    hold every target, from FULL_ROWS target rows and for K7, grav), units
    of (window, group of 32 R targets), a block to one group of some
    windows. A launch of TAIL_UNITS units or more takes one-warp teams,
    TEAMS windows a block; one of fewer (the tail bucket's few windows) one
    team of TAIL_WARPS warps a block, one window, which spreads each unit's
    runs over its warps. The blocks of every window's last group come
    first, then the group before, ...: most windows leave the later groups
    empty. K2m (windows_per_block > 1): windows_per_block windows a block,
    a team each at once (at most WARPS teams, each then taking windows in
    turn), one-warp teams where the launch has many units and in the tail
    as many warps a team as WARPS leaves room for, at most TAIL_WARPS."""
    r = 1 if grav or t_rows <= 32 or t_rows >= FULL_ROWS else TARGETS_A_THREAD
    groups = max(1, -(-t_rows // (32 * r)))
    wpb = windows_per_block if windows_per_block > 1 else TEAMS
    teams = min(wpb, WARPS)
    team_warps = 1
    if n_win * groups < TAIL_UNITS:
        if windows_per_block > 1:
            team_warps = min(TAIL_WARPS, WARPS // teams)
        else:
            wpb, teams, team_warps = 1, 1, TAIL_WARPS
    return LaunchShape(r, groups, wpb, team_warps, teams, -(-n_win // wpb) * groups)


def _check(name: str, t: torch.Tensor, dtype, shape: tuple, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _entry(symbol: str, argtypes: list):
    """The C entry `symbol` of the kernel's library, with its C signature."""
    fn = getattr(_build.load(_KERNEL), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_FUSED_ARGS = [_P] * 6 + [_I] * 6 + [_F] * 2 + [_P]  # nbx_collide_fused
_GRAV_ARGS = [_P] * 7 + [_I] * 6 + [_F] * 6 + [_P]  # nbx_collide_fused_grav


@spanned("nbx.collide.kernel")
def _run(name, feats, order, src_ok, win, out_d, out_j, restitution, friction, t_rows, s_capw,
         windows_per_block: int, short_gravity=None, out_g=None) -> bool:
    """The plain version on CPU tensors, the kernel on CUDA tensors (at
    launch_shape's shape; windows_per_block windows a block for K2m; K7's
    instantiation with short_gravity); True if it launched."""
    if feats.device.type == "cpu":
        collide_fused_reference(feats, order, src_ok, win, out_d, out_j, restitution, friction, t_rows,
                                s_capw, short_gravity, out_g)
        return False
    if feats.device.type != "cuda":
        raise ValueError(f"{name} runs on CPU or CUDA tensors, got {feats.device}")
    n, n_win = feats.shape[0], win.shape[0]
    dev = feats.device
    _check("feats", feats, torch.float32, (n, 8), dev)
    _check("order", order, torch.int32, (n,), dev)
    _check("src_ok", src_ok, torch.bool, (n,), dev)
    _check("win", win, torch.int32, (n_win, WIN_INTS), dev)
    _check("out_d", out_d, torch.float32, (n, 8), dev)
    _check("out_j", out_j, torch.int32, (n,), dev)
    if short_gravity is not None:
        _check("out_g", out_g, torch.float32, (n, 3), dev)
    if feats.data_ptr() % 16:
        raise ValueError("feats must be 16-byte aligned (rows are read as float4)")
    if windows_per_block < 1:
        raise ValueError(f"windows_per_block must be >= 1, got {windows_per_block}")
    if n_win == 0 or n == 0:
        return False
    sh = launch_shape(n_win, t_rows, windows_per_block, short_gravity is not None)
    shape = (n_win, sh.groups, sh.windows_per_block, sh.team_warps, sh.teams, sh.targets_a_thread)
    ptrs = (feats.data_ptr(), order.data_ptr(), src_ok.data_ptr(), win.data_ptr(), out_d.data_ptr(),
            out_j.data_ptr())
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        if short_gravity is None:
            err = _entry("nbx_collide_fused", _FUSED_ARGS)(*ptrs, *shape, f32(restitution), f32(friction), stream)
        else:
            G, a, eps = short_gravity
            eps2, inv_a, c_a, g = pp_law(eps, a, G)
            err = _entry("nbx_collide_fused_grav", _GRAV_ARGS)(*ptrs, out_g.data_ptr(), *shape, f32(restitution),
                                                               f32(friction), g, inv_a, c_a, eps2, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")
    return True


def collide_fused(feats, order, src_ok, win, out_d, out_j, restitution: float, friction: float,
                  t_rows: int, s_capw: int) -> None:
    """One window set's collision pass (see collide_fused_reference for the
    arguments): writes every target's delta row and deepest partner to body
    order in out_d / out_j. A CPU tensor runs the plain version; a CUDA
    tensor launches the kernel at launch_shape's shape (the TPU kernel K2's
    launches: the bucketed, banded, band-packed and compacted layouts)."""
    if _run("collide_fused", feats, order, src_ok, win, out_d, out_j, restitution, friction, t_rows,
            s_capw, 1):
        collide_fused.launches += 1


def collide_full_column(feats, order, src_ok, win, out_d, out_j, restitution: float, friction: float,
                        t_rows: int, s_capw: int) -> None:
    """collide_fused over the full-column layout's windows, one block per
    (i, j) column against its 9 neighbour columns: the function of the TPU
    kernel K8, whose 9 revisits per column are one visit here. Counted
    apart from collide_fused."""
    if _run("collide_full_column", feats, order, src_ok, win, out_d, out_j, restitution, friction,
            t_rows, s_capw, 1):
        collide_full_column.launches += 1


def collide_fused_multi(feats, order, src_ok, win, out_d, out_j, restitution: float, friction: float,
                        t_rows: int, s_capw: int, windows_per_block: int) -> None:
    """collide_fused with windows_per_block windows a thread block, a warp
    each, at once (the TPU kernel K2m): the same pair set, arithmetic and
    runs, so on the card bitwise the result of windows_per_block = 1. The
    plain version is collide_fused's (windows are independent)."""
    if _run("collide_fused_multi", feats, order, src_ok, win, out_d, out_j, restitution, friction,
            t_rows, s_capw, windows_per_block):
        collide_fused_multi.launches += 1


def collide_fused_grav(feats, order, src_ok, win, out_d, out_j, restitution: float, friction: float,
                       t_rows: int, s_capw: int, short_gravity: tuple[float, float, float],
                       out_g: torch.Tensor) -> None:
    """collide_fused plus the P3M short-range gravity of every target, summed
    over every lane of its window, into out_g [n, 3] (body order):
    short_gravity = (G, a, eps), the TPU kernel K7 that the spatial step's
    local entries launch with force_impl="p3m". The collision outputs are
    collide_fused's."""
    if _run("collide_fused_grav", feats, order, src_ok, win, out_d, out_j, restitution, friction, t_rows,
            s_capw, 1, short_gravity, out_g):
        collide_fused_grav.launches += 1


def collide_fused_slab(feats, order, src_ok, win, out_d, out_j, restitution: float, friction: float,
                       t_rows: int, s_capw: int) -> None:
    """collide_fused over one column slab's windows (packed_collision_blocks_slab,
    the slab site of the TPU kernel K2 that the all-gather paths of
    `parallel.shard` launch). Counted apart from collide_fused."""
    if _run("collide_fused_slab", feats, order, src_ok, win, out_d, out_j, restitution, friction, t_rows,
            s_capw, 1):
        collide_fused_slab.launches += 1


collide_fused.launches = 0
collide_full_column.launches = 0
collide_fused_multi.launches = 0
collide_fused_grav.launches = 0
collide_fused_slab.launches = 0


# ---- the pass ---------------------------------------------------------------

@spanned("nbx.collide.pass")
def binned_collision_pass(
    pos: torch.Tensor,  # [N, 3] binning domain [0, box)^3 (outside clamps to faces)
    vel: torch.Tensor,  # [N, 3]
    mass: torch.Tensor,  # [N] (0 = dead)
    radius: torch.Tensor,  # [N]
    box_size: float,
    n_cells: int,
    restitution: float = 0.2,
    friction: float = 0.5,
    max_per_cell: int = 16,
    band_cells: int | None = None,
    packed_caps: tuple[int, int] | None = None,
    max_blocks: int | None = None,
    buckets: tuple[tuple[int, int, int], ...] | None = None,
    windows_per_block: int = 1,
    construction: str = "auto",
):
    """One fused collision sweep over the 27-cell neighbourhoods (module
    docstring for the layouts). One layout switch at a time, as in the JAX
    package:

      * buckets=((t_cap, s_cap, max_blocks), ...) (from bucketed_layout_for;
        needs band_cells): the occupancy-bucketed layout;
      * packed_caps=(t_cap, s_cap) with max_blocks (from packed_layout_for;
        needs band_cells): the occupancy-compacted layout;
      * packed_caps alone (from packed_caps_for; needs band_cells): the
        band-packed layout;
      * band_cells=B alone: the banded layout, max_per_cell bodies a cell;
      * none of them: the full-column layout, max_per_cell bodies a cell.

    max_per_cell is read by the last two only. windows_per_block=W > 1 runs W
    windows in each thread block of the bucketed layout (the other layouts
    ignore it, as the JAX package does). construction ("auto" | "grid" |
    "slice") names a JAX strip construction; every value computes the same.

    Returns (dvel [N, 3], dpos [N, 3], dtemp [N], best, n_bounces,
    n_overflow, cell_too_small): Jacobi deltas to add to the state, and
    `best`, each body's deepest-overlap partner record: dict(j [N] i32
    (-1 = none), vn, q, energy, m_j [N] f32, approaching [N] bool)."""
    if construction not in CONSTRUCTIONS:
        raise ValueError(f"construction must be one of {CONSTRUCTIONS}, got {construction!r}")
    run, layout, fused = _layout_call(n_cells, max_per_cell, band_cells, packed_caps, max_blocks, buckets,
                                      windows_per_block)
    return run(pos, vel, mass, radius, box_size, n_cells, *layout, restitution, friction, fused)


def _layout_call(g, max_per_cell, band_cells, packed_caps, max_blocks, buckets, windows_per_block=1):
    """(pass function, its layout arguments, kernel wrapper) of one layout
    switch, with the JAX package's argument checks: run(pos, vel, mass,
    radius, box_size, g, *layout, restitution, friction, fused) is the pass
    (fused = collide_fused_reference runs its plain version)."""
    if windows_per_block < 1:
        raise ValueError(f"windows_per_block must be >= 1, got {windows_per_block}")
    if buckets is not None:
        if band_cells is None:
            raise ValueError("buckets requires band_cells")
        if packed_caps is not None or max_blocks is not None:
            raise ValueError("buckets excludes packed_caps/max_blocks (one layout switch at a time)")
        fused = collide_fused if windows_per_block == 1 else functools.partial(
            collide_fused_multi, windows_per_block=windows_per_block)
        return _bucketed_pass, (band_cells, buckets), fused
    if max_blocks is not None:
        if packed_caps is None or band_cells is None:
            raise ValueError("max_blocks requires band_cells and packed_caps")
        return _bucketed_pass, (band_cells, ((*packed_caps, max_blocks),)), collide_fused
    if packed_caps is not None:
        if band_cells is None:
            raise ValueError("packed_caps requires band_cells")
        # every window in one bucket; the source overflow per own strip
        n_windows = g * g * -(-g // band_cells)
        return (functools.partial(_bucketed_pass, src_over="own_all"),
                (band_cells, ((*packed_caps, n_windows),)), collide_fused)
    if band_cells is None:
        return _per_cell_pass, (g, max_per_cell), collide_full_column
    if not 1 <= band_cells <= g:
        raise ValueError(f"band_cells must be in [1, {g}], got {band_cells}")
    return _per_cell_pass, (band_cells, max_per_cell), collide_fused


def _sorted_feats(pos, vel, mass, radius, order):
    """[n, 8] rows x y z vx vy vz m r in the given order."""
    return torch.cat([pos, vel, mass[:, None], radius[:, None]], dim=1)[order.long()]


def _outputs(n: int, dev):
    return (torch.zeros((n, 8), dtype=torch.float32, device=dev),
            torch.full((n,), -1, dtype=torch.int32, device=dev))


def _bucketed_pass(pos, vel, mass, radius, box_size, g, b, buckets, restitution, friction,
                   fused, src_over: str = "uses"):
    """binned_collision_pass's bucketed layout (and the compacted and
    band-packed layouts through it), with `fused` (a kernel wrapper, or
    collide_fused_reference to hold the kernel against it) run once per
    bucket."""
    cell_too_small = 2.0 * radius.max() > cell_size(box_size, g)
    out_d, out_j, n_overflow = _sorted_pass(pos, vel, mass, radius, box_size, g, b, buckets, src_over, None,
                                            restitution, friction, fused)
    return _epilogue_finish(out_d, out_j, pos, vel, mass, n_overflow, cell_too_small)


def _sorted_pass(pos, vel, mass, radius, box_size, g, b, buckets, src_over, grid, restitution, friction, fused):
    """The windows of `grid`'s target columns (None: the whole grid) over
    the whole-grid cell sort, run through `fused` once per bucket: (out_d,
    out_j, n_overflow) in body order."""
    n = pos.shape[0]
    with span("nbx.collide.sort"):
        order, starts, cid_sorted = cell_sort(pos, box_size, g)
    feats = _sorted_feats(pos, vel, mass, radius, order)
    windows, t_ok, n_overflow = _bucket_windows(starts, cid_sorted, n, g, b, buckets, src_over, grid)
    out_d, out_j = _outputs(n, pos.device)
    for win, t_rows, s_capw in windows:
        fused(feats, order, t_ok, win, out_d, out_j, restitution, friction, t_rows, s_capw)
    return out_d, out_j, n_overflow


def _per_cell_pass(pos, vel, mass, radius, box_size, g, b, k, restitution, friction, fused):
    """The banded layout (b < g) or the full-column layout (b = g) at k
    bodies a cell, with `fused` (a kernel wrapper, or
    collide_fused_reference)."""
    n = pos.shape[0]
    cell_too_small = 2.0 * radius.max() > cell_size(box_size, g)
    order_k, win, t_rows, s_capw, n_overflow = _kept_windows(pos, box_size, g, b, k)
    feats = _sorted_feats(pos, vel, mass, radius, order_k)
    src_ok = torch.ones(n, dtype=torch.bool, device=pos.device)  # every kept body is a source
    out_d, out_j = _outputs(n, pos.device)
    fused(feats, order_k, src_ok, win, out_d, out_j, restitution, friction, t_rows, s_capw)
    return _epilogue_finish(out_d, out_j, pos, vel, mass, n_overflow, cell_too_small)


@spanned("nbx.collide.epilogue")
def _epilogue_finish(out_d, out_j, pos, vel, mass, n_overflow, cell_too_small):
    """Split the per-body delta rows and rebuild the deepest-partner record
    (partner_record), O(N)."""
    dvel = out_d[:, 0:3]
    dpos = out_d[:, 3:6]
    dtemp = out_d[:, 6]
    n_bounces = (out_d[:, 7].sum() / 2.0).to(torch.int32)
    best = partner_record(out_j, pos, vel, mass)
    return dvel, dpos, dtemp, best, n_bounces, n_overflow, cell_too_small


def partner_record(out_j, pos, vel, mass, src=None) -> dict:
    """Each body's deepest-overlap partner record from the pass's partner
    ids out_j [n] (-1 = none) and the pre-pass state of the bodies: dict(j,
    vn, q, energy, m_j [n] f32, approaching [n] bool). The partners are rows
    of src = (pos, vel, mass) of every body when given (the all-gather paths
    of `parallel.shard`, whose rows are a rank's shard and whose partners
    are global ids), else of the bodies' own arrays."""
    pos_s, vel_s, mass_s = (pos, vel, mass) if src is None else src
    has = out_j >= 0
    jc = out_j.long().clamp(0, pos_s.shape[0] - 1)
    d = pos_s[jc] - pos
    r2b = (d * d).sum(-1)
    invb = torch.rsqrt(torch.where(r2b > 0.0, r2b, 1.0))
    vnb = ((vel_s[jc] - vel) * d).sum(-1) * invb
    m_j = mass_s[jc]
    m_sum = mass + m_j
    r_msb = 1.0 / torch.where(m_sum > 0.0, m_sum, 1.0)
    e_b = 0.5 * (mass * m_j * r_msb) * vnb * vnb
    return dict(
        j=out_j,
        vn=torch.where(has, vnb, 0.0),
        q=torch.where(has, e_b * r_msb, 0.0),
        energy=torch.where(has, e_b, 0.0),
        m_j=torch.where(has, m_j, 0.0),
        approaching=has & (vnb < 0.0),
    )


# ---- the all-gather paths' column-slab entry -----------------------------------

def packed_collision_blocks_slab(
    pos: torch.Tensor,  # [N] every body (the all-gathered state)
    vel: torch.Tensor,
    mass: torch.Tensor,
    radius: torch.Tensor,
    box_size: float,
    n_cells: int,
    band_cells: int,
    packed_caps: tuple[int, int],
    restitution: float,
    friction: float,
    col_lo: int,  # first (i, j) column of the slab, column id i g + j
    n_slab_cols: int,  # columns in the slab
    fused=None,
):
    """The band-packed layout over the column slab [col_lo, col_lo +
    n_slab_cols) of the whole g x g grid: the pass of one rank of the
    all-gather paths (`parallel.shard.make_sharded_binned_collision_pass`,
    `make_sharded_granular_step`), over every body. Target windows are the
    slab's (column, band) windows at caps (t_cap, s_cap); their source
    strips run over the whole grid's neighbour columns, so each window is
    the same window of the whole-grid band-packed pass, with the same
    kept set.

    The contract, as in the JAX package: target rows past t_rows are
    dropped; the source role masks out every body that is target-dropped
    in its own whole-grid window, whichever slab holds it; n_overflow counts
    target rows past t_rows in the slab's windows and source lanes past
    s_capw in each slab (column, band)'s own strip, so the sum over the
    slabs of a split is the whole grid's count.

    Returns (out_d [N, 8], out_j [N] i32, n_overflow [] i32) in body order:
    each slab target's deltas (dvx dvy dvz dpx dpy dpz heat n_bounce) and
    deepest partner (-1 = none; ties to the smallest body id); every other
    row is the identity of the reduction that follows, zero deltas and
    partner -1, so summing the deltas and taking the largest partner over
    the slabs of a split rebuilds the whole-grid pass exactly (one nonzero
    term a body). The kernel writes body order itself, so the JAX package's
    `body_slot` and `epilogue_rows` have no counterpart here. col_lo is a
    Python int: the slab's tables are built at its offset, with none of the
    cost the JAX package pays for a traced offset. `fused` runs the windows
    (default collide_fused_slab; collide_fused_reference to hold the kernel
    against its plain version)."""
    g, b = n_cells, band_cells
    if not 0 <= col_lo <= col_lo + n_slab_cols <= g * g or n_slab_cols < 1:
        raise ValueError(f"column slab [{col_lo}, {col_lo + n_slab_cols}) outside the {g * g} columns")
    grid = _column_slab_grid(g, col_lo, n_slab_cols, pos.device)
    buckets = ((*packed_caps, n_slab_cols * -(-g // b)),)  # every window of the slab
    return _sorted_pass(pos, vel, mass, radius, box_size, g, b, buckets, "own_all", grid, restitution, friction,
                        fused or collide_fused_slab)


# ---- the spatial step's local entries ------------------------------------------

def cell_sort_slabgrid(pos: torch.Tensor, alive: torch.Tensor, box_size: float, n_cells: int, x0_cell: int,
                       gx: int, y0_cell: int = 0, gy: int | None = None):
    """cell_sort over a LOCAL slab grid [gx, gy, g] whose x origin is the
    global cell layer x0_cell: local lx = clip-to-box(global cx) - x0_cell,
    y and z as in cell_sort. With gy (default: the whole g), the y axis is
    likewise a local window at origin y0_cell (the 2-D slab decomposition).
    Rows with lx or ly outside the local grid, or alive False, go to the
    overflow cell gx gy g, parked at the end of the sort: never targets,
    never sources. The sort is stable, as jnp.argsort is.

    Returns (order [N] i32, starts [gx gy g + 1] i32, cid_sorted [N] i32)."""
    g = n_cells
    if gy is None:
        gy = g
    # box / g as the JAX package forms it (a Python float rounded to
    # float32), divided as a 0-dim tensor (see cell_sort)
    h = torch.full((), f32(box_size / g), dtype=torch.float32, device=pos.device)
    ijk = (pos / h).to(torch.int32).clamp(0, g - 1)
    lx = ijk[:, 0] - x0_cell
    ly = ijk[:, 1] - y0_cell
    n_loc = gx * gy * g
    inside = alive & (lx >= 0) & (lx < gx) & (ly >= 0) & (ly < gy)
    cid = torch.where(inside, (lx * gy + ly) * g + ijk[:, 2], n_loc).to(torch.int32)
    order = torch.argsort(cid, stable=True).to(torch.int32)
    cid_sorted = cid[order.long()]
    cells = torch.arange(n_loc + 1, dtype=torch.int32, device=pos.device)
    starts = torch.searchsorted(cid_sorted, cells).to(torch.int32)
    return order, starts, cid_sorted


@spanned("nbx.collide.pass")
def _local_pass(pos, vel, mass, radius, box_size: float, g: int, b: int, buckets, src_over: str,
                restitution: float, friction: float, x0_cell: int, slab_x: int, y0_cell: int,
                slab_y: int | None, short_gravity, fused=None):
    """The local entries' pass (their docstrings), with `fused` run once per
    bucket: collide_fused, or collide_fused_grav with short_gravity, by
    default; collide_fused_reference to hold the kernels against it."""
    n = pos.shape[0]
    dev = pos.device
    two_d = slab_y is not None
    w_y = slab_y if two_d else g
    gy = w_y + 2 if two_d else g
    with span("nbx.collide.sort"):
        order, starts, cid_sorted = cell_sort_slabgrid(pos, mass > 0.0, box_size, g, x0_cell, slab_x + 2,
                                                       y0_cell if two_d else 0, gy)
    grid = _slab_grid(slab_x, w_y, gy, two_d, dev)
    windows, t_ok, n_overflow = _bucket_windows(starts, cid_sorted, n, g, b, buckets, src_over, grid)
    feats = _sorted_feats(pos, vel, mass, radius, order)
    out_d, out_j = _outputs(n, dev)
    if short_gravity is None:
        fused = fused or collide_fused
        for win, t_rows, s_capw in windows:
            fused(feats, order, t_ok, win, out_d, out_j, restitution, friction, t_rows, s_capw)
        return out_d, out_j, n_overflow
    fused = fused or collide_fused_grav
    out_g = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    for win, t_rows, s_capw in windows:
        fused(feats, order, t_ok, win, out_d, out_j, restitution, friction, t_rows, s_capw, short_gravity, out_g)
    return out_d, out_j, out_g, n_overflow


def packed_collision_blocks_local(
    pos: torch.Tensor,  # [n] local rows: this rank's slots, then its halo rows
    vel: torch.Tensor,
    mass: torch.Tensor,
    radius: torch.Tensor,
    box_size: float,
    n_cells: int,
    band_cells: int,
    packed_caps: tuple[int, int],
    restitution: float,
    friction: float,
    x0_cell: int,  # global x cell layer of local layer 0 (= slab start - 1)
    slab_x: int,  # owned x layers; the local grid is [slab_x + 2, g, g]
    y0_cell: int = 0,  # with slab_y: global y layer of local y 0
    slab_y: int | None = None,  # owned y layers: a 2-D slab grid [slab_x + 2, slab_y + 2, g]
    short_gravity: tuple[float, float, float] | None = None,  # (G, a, eps): K7's gravity sum
):
    """The band-packed layout over a LOCAL slab grid: the pass of one rank of
    the spatial halo-exchange step (`nbx_torch.parallel.spatial`). The rows
    are this rank's slots plus the halo rows its neighbours sent, in any
    order; global x layer x0_cell is local layer 0 (the left halo layer),
    owned layers are [1, slab_x + 1) and layer slab_x + 1 is the right halo
    (with slab_y, the y axis likewise). Target windows are the owned
    columns' (column, band) windows at caps (t_cap, s_cap); source strips run
    over every local column, so owned targets see their +-1 neighbours
    through the halo rows. Halo rows are never targets. Dead rows and rows
    outside the local grid are parked (`cell_sort_slabgrid`).

    Counters as in the JAX package: n_overflow counts target rows past
    t_rows in the owned windows and source lanes past s_capw in each owned
    (column, band)'s own strip, so a sum over ranks counts each window
    once. A halo row is a source if its rank in its own window is below
    t_rows (the owner's cut, as far as this rank can see it).

    Returns (out_d [n, 8], out_j [n] i32, n_overflow [] i32), with
    short_gravity (out_d, out_j, out_g [n, 3], n_overflow): the deltas
    (dvx dvy dvz dpx dpy dpz heat n_bounce), the deepest partner as a LOCAL
    row (-1 = none; ties to the smallest local row) and the P3M short-range
    gravity (K7), in body order, zero for rows that hold no target slot.
    The kernel writes body order itself, so the JAX package's slot arrays
    and `epilogue_rows` have no counterpart here."""
    n_windows = slab_x * (slab_y if slab_y is not None else n_cells) * -(-n_cells // band_cells)
    return _local_pass(pos, vel, mass, radius, box_size, n_cells, band_cells, ((*packed_caps, n_windows),),
                       "own_all", restitution, friction, x0_cell, slab_x, y0_cell, slab_y, short_gravity)


def bucketed_collision_blocks_local(
    pos: torch.Tensor,
    vel: torch.Tensor,
    mass: torch.Tensor,
    radius: torch.Tensor,
    box_size: float,
    n_cells: int,
    band_cells: int,
    buckets: tuple[tuple[int, int, int], ...],
    restitution: float,
    friction: float,
    x0_cell: int,
    slab_x: int,
    y0_cell: int = 0,
    slab_y: int | None = None,
    short_gravity: tuple[float, float, float] | None = None,
):
    """The occupancy-bucketed variant of packed_collision_blocks_local: each
    owned window runs in the first bucket whose caps cover it (per-rank
    budgets: `parallel.spatial.spatial_buckets_for`). n_overflow counts the
    last bucket's dropped windows, target rows past t_rows and, once per
    selected window, its own strip's lanes past s_capw. A halo row's
    symmetric-drop rank is held to the LAST bucket's t_rows (its owner's
    bucket depends on occupancy this rank cannot see): with zero overflow
    the masks agree exactly, as in the JAX package. Returns as
    packed_collision_blocks_local."""
    return _local_pass(pos, vel, mass, radius, box_size, n_cells, band_cells, buckets, "own", restitution,
                       friction, x0_cell, slab_x, y0_cell, slab_y, short_gravity)
