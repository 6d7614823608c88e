"""Cell-binned collision pass at scale: the occupancy-bucketed layout and the
fused collision kernel K2 (port of the bucketed path of `nbx/ops/collide.py`).

Physics per overlapping pair, as in `_collide_fused_body` of the JAX package:
restitution impulse and friction impulse through the reduced mass, Baumgarte
push (0.8), impact heating (0.2 E, E = mu/2 vn^2), bounce count, and each
target's deepest-overlap partner (largest depth, ties to the smallest body
id).

Layout (the JAX package's bucketed layout, same kept set and counters):

  * all N bodies, dead ones included, are cell-sorted with k minor
    (`ops.p3m.cell_sort`), so a window of B cells of one (i, j) column, and
    the guarded (B + 2)-cell source strip around it, are each one contiguous
    run of the sorted order;
  * each occupied window goes to the first bucket whose caps cover its
    target count and its largest neighbour-strip run; a window past a
    bucket's budget spills to the next bucket, and only the last bucket
    drops windows;
  * targets are the first min(count, t_rows) bodies of the window's run;
    sources are, per neighbour strip, the first min(run, s_capw) bodies,
    then masked by the global symmetric-drop mask `t_ok` (a body without a
    target slot is no source either);
  * n_overflow counts dropped windows' bodies, target rows past t_rows and
    source lanes past s_capw per strip.

What does not carry over from the TPU: the materialised [blocks, 16, S]
source blocks, the whole-grid strips table, the "grid"/"slice" strip
constructions, the 128-lane padding and the dead padding row. Here each
bucket hands the kernel one int32 descriptor per window (target start and
count, 9 source starts and lengths), and the kernel reads the cell-sorted
bodies itself and writes each target's result straight to body order.

`collide_fused` sends a CUDA tensor to the kernel of
`nbx_torch/csrc/collide_fused.cu` and a CPU tensor to
`collide_fused_reference`, its plain PyTorch version; a CUDA call launches the
kernel or raises. `collide_fused.launches` counts launches.

Host-side sizing (`bucketed_layout_for`, `bucket_flags_host`, ...) is numpy
and gives the same integer tuples as the JAX package for the same positions.
Nothing on the device side reads a value back to the host.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from nbx_torch.config import f32
from nbx_torch.ops import _build
from nbx_torch.ops.p3m import cell_size, cell_sort, take_rows

LANE = 128  # the JAX package's lane width; only its sizing guards use it
CORRECTION = 0.8  # Baumgarte factor
HEAT_FRACTION = 0.2  # impact heating fraction
DEPTH_SENTINEL = -1e30
WIN_INTS = 20  # window descriptor: ts, tn, 9 x (strip start, strip length)

_KERNEL = "collide_fused"
_PAIR_BUDGET = 1 << 22  # pair lanes per chunk of the plain version


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


def _bucket_windows(starts, cid_sorted, n: int, g: int, b: int, buckets):
    """Window descriptors of every bucket, the symmetric-drop mask and the
    overflow count.

    Returns ([(win [bmax, 20] i32, t_rows, s_capw) per bucket],
    t_ok [n] bool over sorted positions, n_overflow [] i32)."""
    dev = starts.device
    n_cols = g * g
    g3 = n_cols * g
    n_bands = -(-g // b)
    st = starts.long()

    cols = torch.arange(n_cols, device=dev)
    w_r = torch.arange(n_bands, device=dev)
    ts_tab = st[cols[:, None] * g + w_r[None, :] * b]  # [n_cols, n_bands]
    te_tab = st[cols[:, None] * g + torch.clamp(w_r[None, :] * b + b, max=g)]
    cnt_t = te_tab - ts_tab
    lo = torch.clamp(w_r * b - 1, min=0)  # guarded strip cells [lo, hi)
    hi = torch.clamp(w_r * b + b + 1, max=g)
    neigh = _column_neighbors_of(cols, g)[:, None, :]  # [n_cols, 1, 9]
    okn = neigh < n_cols
    ss9 = st[torch.where(okn, neigh * g + lo[None, :, None], g3)]  # [n_cols, n_bands, 9]
    se9 = st[torch.where(okn, neigh * g + hi[None, :, None], g3)]
    run9 = se9 - ss9
    maxrun = run9.amax(2)

    # bucket assignment: first covering bucket; over-budget windows spill to
    # the next bucket, and only the last one drops
    sels, flags, wranks = [], [], []
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
        wranks.append(wrank)

    # global symmetric-drop mask over sorted positions: a body is a source
    # only if it holds a target slot in some bucket
    cs = cid_sorted.long()
    col_s = cs // g
    w_own = (cs - col_s * g) // b
    f_own = col_s * n_bands + w_own
    rank_t = torch.arange(n, device=dev) - ts_tab[col_s, w_own]
    t_ok = torch.zeros(n, dtype=torch.bool, device=dev)
    for sel, (t_cap, s_cap, _) in zip(sels, buckets):
        t_rows, _ = _bucket_block_geom(t_cap, s_cap)
        t_ok = t_ok | (sel[f_own] & (rank_t < t_rows))

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
        n_overflow = n_overflow + torch.clamp(run_sel - s_capw, min=0).sum()
        strips = torch.stack(
            [ss9[col_sel, w_sel], torch.clamp(run_sel, max=s_capw)], dim=2
        ).reshape(-1, 18)
        win = torch.cat(
            [ts_tab[col_sel, w_sel][:, None], torch.clamp(cnt_sel, max=t_rows)[:, None], strips],
            dim=1,
        ).to(torch.int32).contiguous()
        out.append((win, t_rows, s_capw))
    return out, t_ok, n_overflow.to(torch.int32)


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
) -> None:
    """Plain PyTorch version of the kernel: the same windows, kept set and
    pair math, over [windows, t_rows, 9 s_capw] pair tensors in chunks of
    windows of at most _PAIR_BUDGET pair lanes. Writes each target's
    delta row (dvx dvy dvz dpx dpy dpz heat n_bounce) and partner (-1 =
    none) to body order; other rows are left as they are."""
    n = feats.shape[0]
    n_win = win.shape[0]
    if n_win == 0 or n == 0:
        return
    dev = feats.device
    s_all = 9 * s_capw
    one_e = f32(1.0 + f32(restitution))
    fric = f32(friction)
    ids = order.long()
    ar_t = torch.arange(t_rows, device=dev)
    ar_s = torch.arange(s_capw, device=dev)
    d_pad = torch.cat([out_d, out_d.new_zeros((1, 8))])
    j_pad = torch.cat([out_j, out_j.new_full((1,), -1)])
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
    out_d.copy_(d_pad[:n])
    out_j.copy_(j_pad[:n])


def _check(name: str, t: torch.Tensor, dtype, shape: tuple, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _entry():
    fn = _build.load(_KERNEL).nbx_collide_fused
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
            ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


def collide_fused(
    feats: torch.Tensor,
    order: torch.Tensor,
    src_ok: torch.Tensor,
    win: torch.Tensor,
    out_d: torch.Tensor,
    out_j: torch.Tensor,
    restitution: float,
    friction: float,
    t_rows: int,
    s_capw: int,
) -> None:
    """One bucket's collision pass (see collide_fused_reference for the
    arguments): writes every target's delta row and deepest partner to body
    order in out_d / out_j. A CPU tensor runs the plain version; a CUDA
    tensor launches the kernel, one thread block per window."""
    if feats.device.type == "cpu":
        collide_fused_reference(feats, order, src_ok, win, out_d, out_j,
                                restitution, friction, t_rows, s_capw)
        return
    if feats.device.type != "cuda":
        raise ValueError(f"collide_fused runs on CPU or CUDA tensors, got {feats.device}")
    n, n_win = feats.shape[0], win.shape[0]
    dev = feats.device
    _check("feats", feats, torch.float32, (n, 8), dev)
    _check("order", order, torch.int32, (n,), dev)
    _check("src_ok", src_ok, torch.bool, (n,), dev)
    _check("win", win, torch.int32, (n_win, WIN_INTS), dev)
    _check("out_d", out_d, torch.float32, (n, 8), dev)
    _check("out_j", out_j, torch.int32, (n,), dev)
    if feats.data_ptr() % 16:
        raise ValueError("feats must be 16-byte aligned (rows are read as float4)")
    if n_win == 0 or n == 0:
        return
    threads = min(256, _round_up(max(t_rows, 1), 32))
    with torch.cuda.device(dev):
        err = _entry()(
            feats.data_ptr(), order.data_ptr(), src_ok.data_ptr(), win.data_ptr(),
            out_d.data_ptr(), out_j.data_ptr(), n_win, threads,
            f32(restitution), f32(friction), torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"collide_fused launch failed: cudaError_t {err}")
    collide_fused.launches += 1


collide_fused.launches = 0


# ---- the pass ---------------------------------------------------------------

def _unported_layout(band_cells, packed_caps, max_blocks) -> str:
    if band_cells is None:
        return "the full-column layout (band_cells=None, kernel K8)"
    if max_blocks is not None:
        return "the occupancy-compacted layout (max_blocks)"
    if packed_caps is not None:
        return "the band-packed layout (packed_caps)"
    return "the banded per-cell-cap layout (band_cells without buckets)"


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
):
    """One fused collision sweep over the 27-cell neighbourhoods, in the
    occupancy-bucketed layout (buckets from bucketed_layout_for; band_cells
    required). max_per_cell is accepted for the JAX signature and unused, as
    there.

    Returns (dvel [N, 3], dpos [N, 3], dtemp [N], best, n_bounces,
    n_overflow, cell_too_small): Jacobi deltas to add to the state, and
    `best`, each body's deepest-overlap partner record: dict(j [N] i32
    (-1 = none), vn, q, energy, m_j [N] f32, approaching [N] bool)."""
    if buckets is None:
        raise NotImplementedError(
            f"{_unported_layout(band_cells, packed_caps, max_blocks)} is not ported"
            " yet (ROADMAP.md Queue 2); pass buckets= from bucketed_layout_for"
        )
    if band_cells is None:
        raise ValueError("buckets requires band_cells")
    if packed_caps is not None or max_blocks is not None:
        raise ValueError("buckets excludes packed_caps/max_blocks (one layout switch at a time)")
    del max_per_cell
    return _bucketed_pass(pos, vel, mass, radius, box_size, n_cells, band_cells, buckets,
                          restitution, friction, collide_fused)


def _bucketed_pass(pos, vel, mass, radius, box_size, g, b, buckets, restitution, friction,
                   fused):
    """binned_collision_pass's bucketed layout, with `fused` (collide_fused,
    or collide_fused_reference to hold the kernel against it) run once per
    bucket."""
    n = pos.shape[0]
    dev = pos.device
    cell_too_small = 2.0 * radius.max() > cell_size(box_size, g)
    order, starts, cid_sorted = cell_sort(pos, box_size, g)
    feats = torch.cat([pos, vel, mass[:, None], radius[:, None]], dim=1)[order.long()]
    windows, t_ok, n_overflow = _bucket_windows(starts, cid_sorted, n, g, b, buckets)

    out_d = torch.zeros((n, 8), dtype=torch.float32, device=dev)
    out_j = torch.full((n,), -1, dtype=torch.int32, device=dev)
    for win, t_rows, s_capw in windows:
        fused(feats, order, t_ok, win, out_d, out_j, restitution, friction, t_rows, s_capw)
    return _epilogue_finish(out_d, out_j, pos, vel, mass, n_overflow, cell_too_small)


def _epilogue_finish(out_d, out_j, pos, vel, mass, n_overflow, cell_too_small):
    """Split the per-body delta rows and rebuild the deepest-partner record:
    vn, Q, E, m_j and approaching follow from the pre-pass state and the
    partner id, O(N)."""
    n = pos.shape[0]
    dvel = out_d[:, 0:3]
    dpos = out_d[:, 3:6]
    dtemp = out_d[:, 6]
    n_bounces = (out_d[:, 7].sum() / 2.0).to(torch.int32)

    has = out_j >= 0
    jc = out_j.long().clamp(0, n - 1)
    d = pos[jc] - pos
    r2b = (d * d).sum(-1)
    invb = torch.rsqrt(torch.where(r2b > 0.0, r2b, 1.0))
    vnb = ((vel[jc] - vel) * d).sum(-1) * invb
    m_j = mass[jc]
    m_sum = mass + m_j
    r_msb = 1.0 / torch.where(m_sum > 0.0, m_sum, 1.0)
    e_b = 0.5 * (mass * m_j * r_msb) * vnb * vnb
    best = dict(
        j=out_j,
        vn=torch.where(has, vnb, 0.0),
        q=torch.where(has, e_b * r_msb, 0.0),
        energy=torch.where(has, e_b, 0.0),
        m_j=torch.where(has, m_j, 0.0),
        approaching=has & (vnb < 0.0),
    )
    return dvel, dpos, dtemp, best, n_bounces, n_overflow, cell_too_small
