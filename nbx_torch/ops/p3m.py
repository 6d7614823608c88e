"""P3M (particle-particle / particle-mesh) gravity (port of `nbx/ops/p3m.py`).

The Ewald-style split of 1/r into a long-range part on the mesh and a
short-range part summed pairwise within one cell of each body:

    1/r = erf(r / a) / r   +   erfc(r / a) / r
          \\__ long range __/    \\__ short range, ~0 beyond r_c = 3a __/

  * long range: the isolated PM solve of `nbx_torch.ops.pm` with the smoothed
    Green's function -erf(r/a)/r;
  * short range: bodies binned into cells of size r_c = box / n_cells
    (a = r_c / 3); each cell's first `max_per_cell` bodies in stable
    cell-sorted order (the kept set) interact with the kept bodies of the 27
    neighbouring cells; bodies past the cap (residuals) get an exact
    residual pass against the kept table and against each other, up to
    `max_residual` of them, and `n_uncorrected` counts what is left over.

    F_s(r) / (G m) = erfc(r/a) / r^2 + 2 / (a sqrt(pi)) exp(-(r/a)^2) / r,
    evaluated at s = sqrt(r^2 + eps^2).

The short-range passes come in two implementations (`pp_impl`):
  * "ops" (the JAX package's "xla"): tensor code, the 27-offset pair blocks
    of `short_range_acc` and `_residual_short_acc`, chunked over cells and
    residual rows by Python loops in place of `lax.map` / `lax.scan`;
  * "kernel" (the JAX package's "pallas"): the hand-written CUDA kernels K4
    and K5 of `nbx_torch.ops.ppkernel` on a CUDA tensor, their plain PyTorch
    versions on a CPU tensor.

The residual-residual term is exact (`residual_mode="dense"`) or solved on a
refined submesh over the residual set (`"twolevel"`, `_residual_rr_twolevel`),
whose size is a device value: `cell_sort`, `cell_bin_full`, `short_range_acc`
and PM's deposit and gather take a box given as a 0-dim tensor as well as a
Python float, with the same bits.

Every device function here returns fixed shapes sized by its static caps and
reads nothing back to the host. `p3m_tune_for` is host-side numpy, once per
scene.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from nbx_torch.config import f32
from nbx_torch.ops.pm import (
    _cic_window, _fftfreq, _i_times, _isolated_solve_r, _scalar, cic_deposit, cic_gather,
    isolated_green_hat, spacing,
)
from nbx_torch.profiling import span

_F32 = torch.float32


def cell_size(box_size: float, n_cells: int) -> float:
    """box / g in float32, as the JAX package computes it from its traced
    float32 box."""
    return float(np.float32(box_size) / np.float32(n_cells))


def smoothing_length(box_size: float, n_cells: int) -> float:
    """The split scale a = (box / n_cells) / 3 in float32."""
    return float(np.float32(cell_size(box_size, n_cells)) / np.float32(3.0))


def body_cells(pos: torch.Tensor, box_size, n_cells: int) -> torch.Tensor:
    """[N, 3] i32 cell coordinates (i, j, k) of each body on the
    n_cells^3 grid over [0, box)^3; bodies outside are clipped into the
    face cells."""
    # Divide by a 0-dim tensor on the same device: a CUDA division by a host
    # scalar multiplies by its reciprocal, which can move a body across a
    # cell face. Truncate toward zero, then clamp (negative coordinates
    # truncate to 0 first, as in the JAX package).
    h = spacing(box_size, n_cells, pos.device)
    return (pos / h).to(torch.int32).clamp(0, n_cells - 1)


def cell_sort(pos: torch.Tensor, box_size, n_cells: int):
    """Sort bodies by cell id, k (the z cell coordinate) minor within each
    (i, j) column, so any k-window of cells within a column is one contiguous
    run of the sorted order. box_size: a Python float or a 0-dim tensor (a
    box computed on the device), the same bits either way.

    Returns (order [N] i32, starts [g^3 + 1] i32, cid_sorted [N] i32): bodies
    of cell c are order[starts[c] : starts[c + 1]]. The sort is stable, so
    bodies of one cell keep their index order, as `jnp.argsort` keeps it.
    """
    g = n_cells
    ijk = body_cells(pos, box_size, g)
    cid = (ijk[:, 0] * g + ijk[:, 1]) * g + ijk[:, 2]
    order = torch.argsort(cid, stable=True).to(torch.int32)
    cid_sorted = cid[order.long()]
    cells = torch.arange(g * g * g + 1, dtype=torch.int32, device=pos.device)
    starts = torch.searchsorted(cid_sorted, cells).to(torch.int32)
    return order, starts, cid_sorted


def inverse_permutation(order: torch.Tensor) -> torch.Tensor:
    """inv [N] i32 with inv[order[p]] = p: body -> sorted position."""
    inv = torch.empty_like(order)
    inv[order.long()] = torch.arange(order.shape[0], dtype=order.dtype, device=order.device)
    return inv


def take_rows(mask: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """First k set rows of a [N] bool mask in index order -> (idx [k] i32,
    valid [k] bool); invalid entries hold N - 1. Binary search over the
    mask's cumsum, so the shape is k whatever the mask holds, and the valid
    entries are a prefix."""
    n = mask.shape[0]
    csum = torch.cumsum(mask.to(torch.int32), 0, dtype=torch.int32)
    want = torch.arange(1, k + 1, dtype=torch.int32, device=mask.device)
    idx = torch.searchsorted(csum, want).to(torch.int32)
    valid = want <= csum[-1]
    return idx.clamp(max=n - 1), valid


def cell_bin_full(pos: torch.Tensor, box_size, n_cells: int, max_per_cell: int,
                  sort=None):
    """Bin bodies into an [n_cells^3] grid of cubic cells.

    Returns (table [C, K] i32 body indices padded with N, counts [C] i32,
    n_overflow [] i32, dropped [N] bool). Bodies past max_per_cell in their
    cell are left out of the table and marked in `dropped`. `sort` reuses a
    `cell_sort` result of the same positions."""
    n = pos.shape[0]
    k = max_per_cell
    if sort is None:
        sort = cell_sort(pos, box_size, n_cells)
    order, starts, _ = sort
    counts = starts[1:] - starts[:-1]
    # table rows are consecutive runs of the sorted order: a gather
    ar = torch.arange(k, dtype=torch.int32, device=pos.device)
    valid = ar[None, :] < torch.clamp(counts, max=k)[:, None]
    order_p = torch.cat([order, order.new_full((1,), n)])
    take = torch.clamp(starts[:-1, None] + ar, max=n).long()
    table = torch.where(valid, order_p[take], n)
    return (table, counts, *overflowing(sort, k))


def overflowing(sort, max_per_cell: int):
    """(n_overflow [] i32, dropped [N] bool) of a `cell_sort` result: the
    bodies past the first max_per_cell of their cell."""
    order, starts, cid_sorted = sort
    n = order.shape[0]
    rank = torch.arange(n, dtype=torch.int32, device=order.device) - starts[cid_sorted.long()]
    ok = rank < max_per_cell
    return n - ok.sum(dtype=torch.int32), ~ok[inverse_permutation(order).long()]


def cell_bin(pos: torch.Tensor, box_size, n_cells: int, max_per_cell: int):
    """cell_bin_full without the per-body dropped mask."""
    table, counts, n_overflow, _ = cell_bin_full(pos, box_size, n_cells, max_per_cell)
    return table, counts, n_overflow


def _dilate27(grid: torch.Tensor) -> torch.Tensor:
    """The max over each cell's 3^3 neighbourhood of a [g, g, g] grid of
    bools or of counts below 2^24 (cells off the grid do not wrap): the
    dilation of a mask, or the largest count next to each cell. One max
    pool, on the grid's device."""
    out = torch.nn.functional.max_pool3d(grid.to(_F32)[None, None], 3, stride=1, padding=1)
    return out[0, 0].to(grid.dtype)


def _cell_coords(g: int, device) -> torch.Tensor:
    """[g^3, 3] int64 (i, j, k) of every cell id (i g + j) g + k."""
    cc = torch.arange(g * g * g, device=device)
    return torch.stack([cc // (g * g), (cc // g) % g, cc % g], dim=1)


def _neighbors27(ijk: torch.Tensor, g: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The 3^3 neighbourhood of the cells at ijk [..., 3] (int64), in the JAX
    package's (di, dj, dk) order: (ids [..., 27] with each coordinate clamped
    to the grid, on_grid [..., 27] true where the offset stays on it)."""
    i, j, k = ijk.unbind(-1)
    ids, on_grid = [], []
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            for dk in (-1, 0, 1):
                ni, nj, nk = i + di, j + dj, k + dk
                on_grid.append((ni >= 0) & (ni < g) & (nj >= 0) & (nj < g) & (nk >= 0) & (nk < g))
                ids.append((ni.clamp(0, g - 1) * g + nj.clamp(0, g - 1)) * g + nk.clamp(0, g - 1))
    return torch.stack(ids, -1), torch.stack(on_grid, -1)


def p3m_tune_for(
    pos,
    box_size: float,
    g_candidates: tuple[int, ...] = (64, 96, 128),
    cells_candidates: tuple[int, ...] = (8, 10, 12, 16, 20, 24, 28, 32, 40),
    k_max: int = 768,
    residual_budget: int = 49152,
    affected_budget: int = 4096,
    k_quantile: float = 0.98,
    pair_budget: float = 8.0e10,
) -> dict:
    """Host-side P3M configuration census: pick (g, n_cells, max_per_cell,
    max_residual, affected_cap) for this scene's occupancy, as the JAX
    package's `p3m_tune_for` picks them (numpy, the same dict).

    Maximises the mesh accuracy a/h = g / (3 n_cells), clamped at 1.78,
    subject to: K = the `k_quantile` occupancy (rounded to 8, past 128 to
    128, at most k_max); residuals (bodies past K) <= residual_budget;
    affected cells (the 27-dilation of overflowing cells) <= affected_budget;
    main-pass pair lanes N * 27 * K8 <= pair_budget; ties go to the cheaper
    tune. Returns dict(g, n_cells, max_per_cell, max_residual, affected_cap,
    a_over_h, n_residual, n_affected, pair_lanes, pp_buckets). Raises
    ValueError if no candidate fits. Call per scene, or again when
    n_uncorrected goes nonzero."""
    from nbx_torch.ops.ppkernel import pp_buckets_for

    p = _host(pos)
    best = None
    best_score = None
    for n_cells in cells_candidates:
        h = box_size / n_cells
        ijk = np.clip((p / h).astype(np.int64), 0, n_cells - 1)
        cid = (ijk[:, 0] * n_cells + ijk[:, 1]) * n_cells + ijk[:, 2]
        cnt = np.bincount(cid, minlength=n_cells**3)
        occ = cnt[cnt > 0]
        k = int(np.quantile(occ, k_quantile)) if occ.size else 8
        k = min(max(8, -(-k // 128) * 128 if k > 128 else -(-k // 8) * 8), k_max)
        n_res = int(np.maximum(cnt - k, 0).sum())
        if n_res > residual_budget:
            continue
        over = (cnt > k).reshape(n_cells, n_cells, n_cells)
        n_aff = int(_dilate27(torch.from_numpy(over)).sum()) if n_res else 0
        if n_aff > affected_budget:
            continue
        k8 = -(-max(k, 8) // 8) * 8
        if k8 > 128:
            k8 = -(-k8 // 128) * 128
        lanes = p.shape[0] * 27 * k8
        if lanes > pair_budget:
            continue
        for g in g_candidates:
            if g < 3 * n_cells:
                continue
            a_over_h = g / (3.0 * n_cells)
            cost = lanes / 3.0e10 + ((2 * g) ** 3 * np.log2(2 * g)) / 2.2e9
            score = (min(a_over_h, 1.78), -cost)
            if best_score is not None and score <= best_score:
                continue
            best_score = score
            best = dict(
                g=g, n_cells=n_cells, max_per_cell=k,
                max_residual=max(256, -(-int(n_res * 1.5) // 256) * 256),
                affected_cap=max(64, -(-int(n_aff * 1.3) // 64) * 64),
                a_over_h=a_over_h, n_residual=n_res, n_affected=n_aff,
                pair_lanes=lanes,
            )
    if best is None:
        raise ValueError(
            "no P3M tune fits the budgets: the scene is denser than "
            f"residual_budget={residual_budget} allows at every candidate "
            "n_cells — raise the budgets or use direct/PM gravity"
        )
    best["pp_buckets"] = pp_buckets_for(p, box_size, best["n_cells"], best["max_per_cell"])
    return best


def _host(pos) -> np.ndarray:
    if isinstance(pos, torch.Tensor):
        return pos.detach().cpu().numpy()
    return np.asarray(pos)


def pp_law(eps: float, a: float, G: float) -> tuple[float, float, float, float]:
    """(eps^2, 1/a, 2 / (a sqrt(pi)), G) in float32, formed as the JAX
    package forms the PP kernels' parameter row."""
    a32, one = np.float32(a), np.float32(1.0)
    return (
        float(np.float32(eps) * np.float32(eps)),
        float(one / a32),
        float(np.float32(2.0) / (a32 * np.sqrt(np.float32(math.pi)))),
        f32(G),
    )


# sqrt(pi) in float32, as the JAX package forms it (jnp.sqrt(jnp.pi))
_SQRT_PI = f32(np.sqrt(np.float32(math.pi)))


def _eps2(eps: float) -> float:
    return f32(np.float32(eps) * np.float32(eps))


def _short_force_mag(s: torch.Tensor, a, G: float) -> torch.Tensor:
    """|F| / m_j at softened distance s (module docstring), with erfc from
    `torch.special`. a: a Python float or a 0-dim tensor on s's device (the
    two-level submesh's scale), the same bits either way."""
    if isinstance(a, torch.Tensor):
        c_a, x = 2.0 / (a * _SQRT_PI), s / a
    else:
        c_a, x = pp_law(0.0, a, G)[2], s / _scalar(f32(a), s.device)
    return f32(G) * (torch.special.erfc(x) / (s * s) + c_a * torch.exp(-x * x) / s)


def _far_corner(box_size, device) -> torch.Tensor:
    """[1, 3] at 2 box, where padding bodies park (no pair reaches them)."""
    if isinstance(box_size, torch.Tensor):
        return (2.0 * box_size.to(device=device, dtype=_F32)).expand(1, 3)
    return torch.full((1, 3), f32(2.0 * box_size), device=device)


def _short_weight(d: torch.Tensor, a: float, G: float, eps2: float) -> torch.Tensor:
    """F(s) / s per pair for displacement rows d [..., 3]; 0 at r = 0."""
    r2 = (d * d).sum(-1)
    s2 = r2 + eps2
    s = torch.sqrt(torch.where(s2 > 0, s2, 1.0))
    return torch.where(r2 > 0, _short_force_mag(s, a, G) / s, 0.0)


def short_range_acc(
    pos: torch.Tensor, mass: torch.Tensor, G: float, a, box_size, n_cells: int,
    max_per_cell: int = 16, eps: float = 0.0, chunk: int | None = None,
    table: torch.Tensor | None = None, n_overflow: torch.Tensor | None = None,
):
    """Pairwise short-range force within the 27-cell neighbourhood, tensor
    code (port of the JAX package's `short_range_acc`): one [chunk, K, K, 3]
    pair block per neighbour offset, chunk cells at a time (K-adaptive so a
    block stays near 2^28 lanes). Cell size box/n_cells must be >= 3a.
    Returns ([N, 3] acc, n_overflow); pass `table`/`n_overflow` to reuse a
    `cell_bin`. a and box_size: Python floats or 0-dim tensors (the
    two-level submesh passes its device-valued scale and box), the same bits
    either way."""
    n = pos.shape[0]
    g = n_cells
    k = max_per_cell
    dev = pos.device
    if chunk is None:
        chunk = max(8, min(512, (1 << 28) // max(27 * k * k, 1)))
    if table is None:
        table, _, n_overflow = cell_bin(pos, box_size, g, k)
    c_total = g * g * g
    pos_p = torch.cat([pos, _far_corner(box_size, dev)])
    mass_p = torch.cat([mass, mass.new_zeros(1)])
    table = table.long()
    neigh, on_grid = _neighbors27(_cell_coords(g, dev), g)  # clamped duplicates masked out
    eps2 = _eps2(eps)

    acc = torch.zeros((n + 1, 3), dtype=_F32, device=dev)
    for c0 in range(0, c_total, chunk):
        cs = torch.arange(c0, min(c0 + chunk, c_total), device=dev)
        tgt_idx = table[cs]  # [c, K]
        tgt_pos = pos_p[tgt_idx]
        acc_c = torch.zeros((cs.shape[0], k, 3), dtype=_F32, device=dev)
        for o in range(27):
            src_idx = torch.where(on_grid[cs, o][:, None], table[neigh[cs, o]], n)
            src_pos, src_mass = pos_p[src_idx], mass_p[src_idx]
            d = src_pos[:, None, :, :] - tgt_pos[:, :, None, :]  # [c, K, K, 3]
            r2 = (d * d).sum(-1)
            s2 = r2 + eps2
            s = torch.sqrt(torch.where(s2 > 0, s2, 1.0))
            m_j = src_mass[:, None, :]
            w = torch.where((r2 > 0) & (m_j > 0), _short_force_mag(s, a, G) * m_j / s, 0.0)
            acc_c = acc_c + torch.einsum("ckj,ckjd->ckd", w, d)
        acc.index_add_(0, tgt_idx.reshape(-1), acc_c.reshape(-1, 3))
    return acc[:n], n_overflow


def _residual_short_acc(
    pos: torch.Tensor, mass: torch.Tensor, G: float, a: float, eps: float, box_size: float,
    n_cells: int, table: torch.Tensor, res_idx: torch.Tensor, res_valid: torch.Tensor,
    chunk: int = 256, include_rr: bool = True, sort=None,
) -> torch.Tensor:
    """Short-range correction for the bodies dropped from the cell table
    (port of the JAX package's `_residual_short_acc`), tensor code.

      * each residual against its 27-neighbourhood's table bodies, the
        reaction folded per (neighbour cell, table slot) into a
        [g^3 + 1, K, 3] grid that reaches the table bodies by a gather
        (a kept body's slot is cid * K + rank);
      * with include_rr, each residual against every other residual (both
        ordered copies present, so no reaction term).

    Every chunk of max_residual rows is computed: rows past the live count
    are parked (mass 0, neighbours the junk cell) and add exactly 0, so the
    JAX package's skip of those chunks, which would need the live count on
    the host, is left out. Returns an [N, 3] delta."""
    n = pos.shape[0]
    g = n_cells
    g3 = g * g * g
    k = table.shape[1]
    m = res_idx.shape[0]
    dev = pos.device
    eps2 = pp_law(eps, a, G)[0]
    h = torch.full((), cell_size(box_size, g), dtype=_F32, device=dev)

    pos_p = torch.cat([pos, torch.full((1, 3), f32(2.0 * box_size), device=dev)])
    mass_p = torch.cat([mass, mass.new_zeros(1)])
    ridx_p = torch.where(res_valid, res_idx, n).long()
    pr, mr = pos_p[ridx_p], mass_p[ridx_p]  # [M, 3], [M]

    ijk = (pr / h).to(torch.int64).clamp(0, g - 1)
    ids, on_grid = _neighbors27(ijk, g)
    neigh = torch.where(on_grid & res_valid[:, None], ids, g3)  # [M, 27]
    table_p = torch.cat([table.long(), torch.full((1, k), n, dtype=torch.int64, device=dev)])

    acc_cells = torch.zeros((g3 + 1, k, 3), dtype=_F32, device=dev)
    acc_r = torch.zeros((m, 3), dtype=_F32, device=dev)
    for m0 in range(0, m, chunk):
        rows = torch.arange(m0, min(m0 + chunk, m), device=dev)
        c = rows.shape[0]
        p_c, m_c = pr[rows], mr[rows]
        src = table_p[neigh[rows]].reshape(c, 27 * k)
        d = pos_p[src] - p_c[:, None, :]  # [c, 27K, 3]
        w = _short_weight(d, a, G, eps2)
        a_r = torch.einsum("ck,ckd->cd", w * mass_p[src], d)
        react = (-(w * m_c[:, None])[..., None] * d).reshape(c * 27, k, 3)
        if include_rr:
            drr = pr[None, :, :] - p_c[:, None, :]  # [c, M, 3]
            a_r = a_r + torch.einsum("ck,ckd->cd", _short_weight(drr, a, G, eps2) * mr[None, :], drr)
        acc_cells.index_add_(0, neigh[rows].reshape(-1), react)
        acc_r[m0:m0 + c] = a_r

    order, starts, cid_sorted = sort if sort is not None else cell_sort(pos, box_size, g)
    cs = cid_sorted.long()
    rank_s = torch.arange(n, device=dev) - starts.long()[cs]
    slot_s = torch.where(rank_s < k, cs * k + rank_s, g3 * k)
    flat = torch.cat([acc_cells[:g3].reshape(g3 * k, 3), acc_cells.new_zeros((1, 3))])
    acc = torch.zeros((n + 1, 3), dtype=_F32, device=dev)
    acc[:n] = flat[slot_s[inverse_permutation(order).long()]]
    acc.index_add_(0, ridx_p, acc_r)
    return acc[:n]


def _check_submesh(sub_g: int, sub_cells: int) -> None:
    """The two-level submesh's resolution rules (the JAX package's checks)."""
    if sub_cells < 4:
        # the size factor's margin sub_cells / (sub_cells - 2.5) assumes at
        # least ~1.25 cells of boundary padding
        raise ValueError(f"sub_cells must be >= 4, got {sub_cells}")
    if sub_g < 3 * sub_cells:
        # a1 = l1 / sub_cells / 3 must be resolved by the submesh (h1 = l1 /
        # sub_g <= a1), the level-0 rule g >= 3 n_cells
        raise ValueError(
            f"sub_g={sub_g} under-resolves a1: need sub_g >= 3*sub_cells "
            f"(= {3 * sub_cells}) so the submesh band term is accurate"
        )


def _over(x: torch.Tensor, k: float) -> torch.Tensor:
    """x / k, divided on x's device (a CUDA division by a host scalar
    multiplies by its reciprocal)."""
    return x / _scalar(f32(k), x.device)


def _residual_rr_twolevel(
    pos: torch.Tensor, mass: torch.Tensor, G: float, eps: float, a0: float, res_idx: torch.Tensor,
    res_valid: torch.Tensor, sub_g: int = 64, sub_cells: int = 16, sub_k: int = 64, out_cap: int = 1024,
):
    """The residual-residual short-range term on a refined submesh, the
    two-level P3M that replaces the dense [M, M] block for large overflows
    (port of the JAX package's `_residual_rr_twolevel`). The level-0 short
    kernel splits once more at the submesh scale a1:

        erfc(r/a0)/r = [erf(r/a1) - erf(r/a0)]/r   (band: submesh FFT)
                     + erfc(r/a1)/r                (short1: fine binned PP)

    The submesh is a cube on the residuals' per-axis median, its half-width
    6 interquartile half-widths (at least 1e-3), widened by sub_cells /
    (sub_cells - 2.5) so real rows stay a cell from its faces. Its size is a
    device value: the deposit, the binning and the pair pass take it as a
    0-dim tensor, and the vacuum Hockney solve scales its wave numbers by the
    device-valued spacing h1, so nothing is read back to the host. Residuals
    outside the submesh (up to out_cap of them) get the exact level-0 term
    against every residual row, with reactions on the in-submesh rows only;
    rows past out_cap and rows the fine binning drops are counted.

    The level-1 pair pass is always `short_range_acc`, the tensor path.
    Returns ([N, 3] delta, n_sub_uncorrected [] i32)."""
    _check_submesh(sub_g, sub_cells)
    n = pos.shape[0]
    m = res_idx.shape[0]
    dev = pos.device
    pos_p = torch.cat([pos, pos.new_zeros((1, 3))])
    mass_p = torch.cat([mass, mass.new_zeros(1)])
    ridx_p = torch.where(res_valid, res_idx, n).long()
    pr = pos_p[ridx_p]  # [M, 3]
    mr = torch.where(res_valid, mass_p[ridx_p], 0.0)

    # robust extent: per-axis median +- 6 interquartile half-widths of the
    # live rows (dead rows sort last behind +BIG)
    n_live = res_valid.sum(dtype=torch.int32)
    live_f = torch.clamp(n_live.to(_F32), min=1.0)
    qs = torch.sort(torch.where(res_valid[:, None], pr, 3.0e38), dim=0).values

    def at(f):
        return qs.gather(0, (f * live_f).to(torch.int64).clamp(0, m - 1).expand(1, 3))[0]

    q25, c, q75 = at(0.25), at(0.50), at(0.75)
    half = torch.clamp((3.0 * (q75 - q25)).max(), min=1e-3)
    l1 = 2.0 * half * (sub_cells / (sub_cells - 2.5))
    half_in = 0.5 * l1 - _over(l1, sub_cells)  # in-submesh: at least a cell from the faces
    in_sub = res_valid & ((pr - c).abs() <= half_in).all(1)
    mr_sub = torch.where(in_sub, mr, 0.0)
    q = pr - c + 0.5 * l1
    # park dead and out-of-box rows spread over the (real-free) far x face
    t = torch.arange(m, dtype=_F32, device=dev)
    park = torch.stack([torch.full_like(t, 0.9995) * l1, torch.remainder(t * 0.6180339887, 1.0) * l1,
                        torch.remainder(t * 0.3819660113, 1.0) * l1], dim=1)
    q = torch.where(in_sub[:, None], q, park)
    a1 = _over(_over(l1, sub_cells), 3.0)  # a = cell / 3, as at level 0

    # band term on the submesh: vacuum Hockney solve, device-valued size
    rho = cic_deposit(q, mr_sub, l1, sub_g, periodic=False)
    gp = 2 * sub_g
    h1 = spacing(l1, sub_g, dev)
    rho_p = torch.zeros((gp, gp, gp), dtype=_F32, device=dev)
    rho_p[:sub_g, :sub_g, :sub_g] = rho
    idx = torch.arange(gp, device=dev)
    d1 = torch.minimum(idx, gp - idx).to(_F32) * h1
    r = torch.sqrt(d1[:, None, None] ** 2 + d1[None, :, None] ** 2 + d1[None, None, :] ** 2)
    safe_r = torch.where(r > 0, r, 1.0)
    a0_t = _scalar(f32(a0), dev)
    band0 = (float(np.float32(2.0) / np.float32(_SQRT_PI))
             * (1.0 / a1 - float(np.float32(1.0) / np.float32(a0))))
    green = torch.where(r > 0, -(torch.special.erf(r / a1) - torch.special.erf(r / a0_t)) / safe_r, -band0)
    phi_hat = torch.fft.fftn(rho_p) * torch.fft.fftn(green) * f32(G)
    k1 = (2.0 * math.pi * _fftfreq(gp, 1.0, dev)) / h1  # the unit frequencies over the device spacing
    phi_hat = phi_hat / _cic_window(gp, dev) ** 2
    ks = (k1[:, None, None], k1[None, :, None], k1[None, None, :])
    acc_grid = -torch.stack([torch.fft.ifftn(_i_times(k, phi_hat)).real for k in ks], dim=-1)
    acc_band = cic_gather(acc_grid[:sub_g, :sub_g, :sub_g], q, l1, sub_g, periodic=False)

    # short1: fine binned PP among the in-submesh rows (always the tensor path)
    table1, _, _, dropped1 = cell_bin_full(q, l1, sub_cells, sub_k)
    acc_s1, _ = short_range_acc(q, mr_sub, G, a1, l1, sub_cells, sub_k, eps, table=table1,
                                n_overflow=torch.zeros((), dtype=torch.int32, device=dev))
    n_sub = (dropped1 & in_sub).sum(dtype=torch.int32)

    # outlier rows: the exact level-0 term against every residual row;
    # reactions on in-submesh rows only (out-out pairs appear once per
    # ordered copy across the block's rows)
    out = res_valid & ~in_sub
    oi, o_valid = take_rows(out, out_cap)
    oi = oi.long()
    po = pr[oi]
    mo = torch.where(o_valid, mr[oi], 0.0)
    eps2 = _eps2(eps)
    d_o = pr[None, :, :] - po[:, None, :]  # [out_cap, M, 3]
    r2o = (d_o * d_o).sum(-1)
    s_o = torch.sqrt(torch.where(r2o + eps2 > 0, r2o + eps2, 1.0))
    w_o = torch.where((r2o > 0) & o_valid[:, None], _short_force_mag(s_o, a0, G) / s_o, 0.0)
    acc_out = torch.einsum("om,omd->od", w_o * mr[None, :], d_o)
    w_in = w_o * torch.where(in_sub[None, :], 1.0, 0.0)
    acc_react = -torch.einsum("om,omd->md", w_in * mo[:, None], d_o)
    n_sub = n_sub + out.sum(dtype=torch.int32) - o_valid.sum(dtype=torch.int32)

    total = torch.where(in_sub[:, None], acc_band + acc_s1, 0.0) + acc_react
    total = total.index_add(0, oi, torch.where(o_valid[:, None], acc_out, 0.0))
    acc = torch.zeros((n + 1, 3), dtype=_F32, device=dev)
    acc.index_add_(0, ridx_p, torch.where(res_valid[:, None], total, 0.0))
    return acc[:n], n_sub


def p3m_acceleration(
    pos: torch.Tensor,  # [N, 3] in [0, box/2)^3 (isolated convention)
    mass: torch.Tensor,
    G: float,
    box_size: float,
    g: int = 64,
    n_cells: int = 16,
    max_per_cell: int = 32,
    eps: float = 0.0,
    max_residual: int = 2048,
    deconvolve: bool = True,
    residual_mode: str = "dense",
    sub_g: int = 64,
    sub_cells: int = 16,
    sub_k: int = 64,
    pp_impl: str = "ops",
    affected_cap: int = 256,
    green_hat: torch.Tensor | None = None,
    pp_buckets: tuple[tuple[int, int, int], ...] | None = None,
):
    """Isolated-boundary P3M acceleration. Returns (acc [N, 3],
    n_uncorrected [] i32).

    a = (box / n_cells) / 3, so the short-range force vanishes (erfc(3) ~
    2e-5) beyond one cell and the 27-neighbourhood holds every pair. Up to
    `max_residual` bodies that overflow their cells get an exact residual
    pass; n_uncorrected counts the bodies past that cap, and, with
    pp_impl="kernel", the bodies the bucketed main pass dropped and those
    losing correction past `affected_cap` affected cells. It is the value to
    gate on: 0 means every body got its full short-range term.

    pp_impl (the JAX package's name in brackets):
      "ops"    ("xla")    the tensor path: `short_range_acc` and
                          `_residual_short_acc`;
      "kernel" ("pallas") K4 for the main pass (`short_range_acc_kernel`,
                          optionally in the occupancy-bucketed layout
                          `pp_buckets`) and the residual-residual block
                          (`residual_rr_dense_kernel`), K5 for the residuals
                          against the kept bodies of every affected cell,
                          the 27-dilation of overflowing cells
                          (`residual_table_acc_kernel`, a superset of the
                          tensor path's per-residual neighbourhoods).

    residual_mode picks the residual-residual solver: "dense", the exact
    [M, M] block (K4's residual-residual launch with "kernel"); or
    "twolevel", a refined submesh over the residual set
    (`_residual_rr_twolevel`: a band FFT and a fine binned pair pass, O(M)),
    sized by sub_g (its mesh), sub_cells (its cells a side, >= 4, with
    sub_g >= 3 sub_cells, else ValueError) and sub_k (its kept bodies a
    cell); n_uncorrected then also counts the residuals its fine binning
    drops and the out-of-submesh residuals past its outlier block. With
    "kernel", "twolevel" runs K4's main pass and K5's residual table and no
    residual-residual launch. Pass green_hat =
    isolated_green_hat(box, g, smoothing_length(box, n_cells), smoothed=True)
    from a frame loop to build the Green's function once."""
    if residual_mode not in ("dense", "twolevel"):
        raise ValueError(f"residual_mode must be dense|twolevel, got {residual_mode!r}")
    if residual_mode == "twolevel":
        _check_submesh(sub_g, sub_cells)
    if pp_impl not in ("ops", "kernel"):
        raise ValueError(f"pp_impl must be ops|kernel, got {pp_impl!r}")
    a = smoothing_length(box_size, n_cells)

    # long range: PM with the erf-smoothed free-space Green's function
    rho = cic_deposit(pos, mass, box_size, g, periodic=False)
    if green_hat is None:
        green_hat = isolated_green_hat(box_size, g, a, smoothed=True, device=pos.device)
    acc_grid = _isolated_solve_r(rho, G, box_size, g, green_hat, deconvolve)
    acc_long = cic_gather(acc_grid, pos, box_size, g, periodic=False)

    # short range: one cell sort serves the binning and every pass
    sort = cell_sort(pos, box_size, n_cells)
    n_overflow, dropped = overflowing(sort, max_per_cell)
    res_idx, res_valid = take_rows(dropped, max_residual)
    n_uncorrected = torch.clamp(n_overflow - max_residual, min=0)
    if pp_impl == "ops":
        table = cell_bin_full(pos, box_size, n_cells, max_per_cell, sort)[0]
        acc_short, _ = short_range_acc(pos, mass, G, a, box_size, n_cells, max_per_cell, eps,
                                       table=table, n_overflow=n_overflow)
        acc_res = _residual_short_acc(pos, mass, G, a, eps, box_size, n_cells, table,
                                      res_idx, res_valid, include_rr=residual_mode == "dense", sort=sort)
    else:
        from nbx_torch.ops.ppkernel import (
            residual_rr_dense_kernel, residual_table_acc_kernel, short_range_acc_kernel,
        )

        acc_short, pp_ovf = short_range_acc_kernel(pos, mass, G, a, box_size, n_cells, max_per_cell,
                                                   eps, buckets=pp_buckets, sort=sort)
        if pp_buckets is not None:
            # bodies the bucketed main pass dropped have no residual backstop
            n_uncorrected = n_uncorrected + torch.clamp(pp_ovf - n_overflow, min=0)
        acc_res, n_missed = residual_table_acc_kernel(
            pos, mass, G, a, box_size, n_cells, max_per_cell, res_idx, res_valid, eps,
            affected_cap=affected_cap, sort=sort)
        n_uncorrected = n_uncorrected + n_missed
        if residual_mode == "dense":
            acc_res = acc_res + residual_rr_dense_kernel(pos, mass, G, a, box_size, res_idx, res_valid, eps)
    if residual_mode == "twolevel":
        acc_rr, n_sub = _residual_rr_twolevel(pos, mass, G, eps, a, res_idx, res_valid, sub_g, sub_cells, sub_k)
        acc_res = acc_res + acc_rr
        n_uncorrected = n_uncorrected + n_sub
    return acc_long + acc_short + acc_res, n_uncorrected


def p3m_kdk_scan(
    pos: torch.Tensor, vel: torch.Tensor, mass: torch.Tensor, G: float, box_size: float,
    h: float, n_steps: int, g: int = 64, n_cells: int = 16, max_per_cell: int = 32,
    eps: float = 0.0,
):
    """KDK leapfrog with P3M forces (the tensor path, as the JAX package's
    default), n_steps steps of size h. Returns (pos, vel,
    max_uncorrected_seen): nonzero means some step dropped short-range
    corrections (size max_per_cell or max_residual up)."""
    green_hat = isolated_green_hat(box_size, g, smoothing_length(box_size, n_cells),
                                   smoothed=True, device=pos.device)

    def force(p):
        return p3m_acceleration(p, mass, G, box_size, g, n_cells, max_per_cell, eps,
                                green_hat=green_hat)

    half = f32(0.5 * f32(h))
    acc, unc = force(pos)
    for _ in range(n_steps):
        with span("nbx.substep"):
            vel = vel + acc * half
            pos = pos + vel * f32(h)
            acc, u = force(pos)
            vel = vel + acc * half
            unc = torch.maximum(unc, u)
    return pos, vel, unc
