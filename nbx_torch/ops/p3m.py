"""Cell binning helpers of the P3M module (port of `cell_sort` and `take_rows`
of `nbx/ops/p3m.py`). The collision layout (`nbx_torch.ops.collide`) and the
scaled event code (`nbx_torch.collisions_scaled`) are built on them; the rest
of P3M waits for its own slice.

Neither reads a value back to the host, and both return fixed shapes.
"""

from __future__ import annotations

import numpy as np
import torch


def cell_size(box_size: float, n_cells: int) -> float:
    """box / g in float32, as the JAX package computes it from its traced
    float32 box."""
    return float(np.float32(box_size) / np.float32(n_cells))


def cell_sort(pos: torch.Tensor, box_size: float, n_cells: int):
    """Sort bodies by cell id, k (the z cell coordinate) minor within each
    (i, j) column, so any k-window of cells within a column is one contiguous
    run of the sorted order.

    Returns (order [N] i32, starts [g^3 + 1] i32, cid_sorted [N] i32): bodies
    of cell c are order[starts[c] : starts[c + 1]]. The sort is stable, so
    bodies of one cell keep their index order, as `jnp.argsort` keeps it.
    """
    g = n_cells
    # Divide by a 0-dim tensor on the same device: a CUDA division by a host
    # scalar multiplies by its reciprocal, which can move a body across a
    # cell face. Truncate toward zero, then clamp (negative coordinates
    # truncate to 0 first, as in the JAX package).
    h = torch.full((), cell_size(box_size, g), dtype=torch.float32, device=pos.device)
    ijk = (pos / h).to(torch.int32).clamp(0, g - 1)
    cid = (ijk[:, 0] * g + ijk[:, 1]) * g + ijk[:, 2]
    order = torch.argsort(cid, stable=True).to(torch.int32)
    cid_sorted = cid[order.long()]
    cells = torch.arange(g * g * g + 1, dtype=torch.int32, device=pos.device)
    starts = torch.searchsorted(cid_sorted, cells).to(torch.int32)
    return order, starts, cid_sorted


def take_rows(mask: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """First k set rows of a [N] bool mask in index order -> (idx [k] i32,
    valid [k] bool); invalid entries hold N - 1. Binary search over the
    mask's cumsum, so the shape is k whatever the mask holds."""
    n = mask.shape[0]
    csum = torch.cumsum(mask.to(torch.int32), 0, dtype=torch.int32)
    want = torch.arange(1, k + 1, dtype=torch.int32, device=mask.device)
    idx = torch.searchsorted(csum, want).to(torch.int32)
    valid = want <= csum[-1]
    return idx.clamp(max=n - 1), valid
