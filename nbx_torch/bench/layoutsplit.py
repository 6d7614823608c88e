"""Stage split of the bucketed collision pass's bulk bucket at two N (port of
`nbx/bench/layoutsplit.py`).

Bucket 0 (the bulk bucket of `bucketed_layout_for(..., split_quantile=0.8)`)
of the bucketed pass, built by hand from the port's own pieces and timed
stage by stage; each stage's time is that of a chain of steps through it:

  sort    cell_sort
  feats   the cell-sorted body rows (x y z vx vy vz m r)
  tables  every (column, band) window's target run and 9 guarded strips
  select  the first bmax occupied windows (take_rows) and their descriptors
  mask    t_ok, the symmetric-drop mask of the sources
  kernel  K2 (`ops.collide.collide_fused`), which writes body order

The JAX probe's "strips", "transpose", "fused", "tgt" and "epilogue" stages
have no counterpart: the kernel reads the cell-sorted rows through the
window descriptors, so no [bmax, 16, S] source blocks, no target blocks and
no epilogue gather back to body order are built. The JSON line names them
under "no_counterpart" rather than print zeros.

The probe's pair set is its own, not the pass's, and is kept as the JAX
probe keeps it: the windows are the first bmax occupied (column, band)
windows, whatever their counts; the targets the first min(count, t_rows) of
each; the sources, per neighbour strip, the first min(run, s_capw), masked
by t_ok = (rank in its own window < t_rows) over every body, its window
selected or not; restitution 0.2, friction 0.5.

Each step nudges the positions by (order % 7) 1e-7 and adds the stage's
scalar times 1e-20 (the data chain of the JAX probe's scan); a chain of
`steps` steps runs between two CUDA events after a warm-up chain. One JSON
line per N with the cumulative ms_<stage> and the increments d_<stage>.

    python -m nbx_torch.bench.layoutsplit [N1,N2] [cfg1] [cfg2]
    # defaults: 131072,262144 32,8 40,8   (g,B per N; caps via u0.8)
"""

from __future__ import annotations

import json
import sys
from typing import NamedTuple

import torch

from nbx_torch.bench import timing
from nbx_torch.bench.collsplit import _time as time_chain
from nbx_torch.bench.granular import BOX, granular_cloud
from nbx_torch.config import CUDA, SimConfig, body_radius
from nbx_torch.ops.collide import (_bucket_block_geom, _descriptors, _outputs, _sorted_feats, _whole_grid,
                                   _window_tables, bucketed_layout_for, collide_fused)
from nbx_torch.ops.p3m import cell_sort, take_rows

STAGES = ("sort", "feats", "tables", "select", "mask", "kernel")
NO_COUNTERPART = ("strips", "transpose", "fused", "tgt", "epilogue")
PAR = (0.2, 0.5)  # restitution, friction
DEFAULT_NS = "131072,262144"
DEFAULT_CONFIGS = ("32,8", "40,8")


class Bucket0(NamedTuple):
    """The kernel's inputs for bucket 0 (see collide_fused_reference)."""

    feats: torch.Tensor  # [n, 8] cell-sorted rows
    order: torch.Tensor  # [n] i32 sorted position -> body id
    t_ok: torch.Tensor  # [n] bool sorted position may be a source
    win: torch.Tensor  # [bmax, 20] i32 window descriptors
    t_rows: int
    s_capw: int


def scene(n: int, g: int, band: int, device):
    """The JAX probe's scene: `granular_cloud(n)` in a box of the 131,072-body
    cloud's density, radii from `body_radius`, buckets from
    `bucketed_layout_for(..., split_quantile=0.8)`. Returns (pos, vel, mass,
    radius, box, buckets)."""
    box = BOX * (n / 131072.0) ** (1.0 / 3.0)
    pos, vel, mass = granular_cloud(n, box=box)
    buckets = bucketed_layout_for(pos, box, g, band, split_quantile=0.8)
    pos, vel, mass = (torch.from_numpy(x).to(device) for x in (pos, vel, mass))
    radius = body_radius(mass, torch.zeros(n, dtype=torch.int64, device=device), SimConfig().to(device).materials)
    return pos, vel, mass, radius, box, buckets


def build(pos, vel, mass, radius, box: float, g: int, band: int, bucket, stop: str | None = None):
    """Bucket 0's kernel inputs for bucket = (t_cap, s_cap, bmax), built
    stage by stage. With stop = one of STAGES before "kernel", returns
    (a scalar that depends on everything that stage built, the cell-sort
    order) there instead."""
    n, dev = pos.shape[0], pos.device
    t_cap, s_cap, bmax = bucket
    t_rows, s_capw = _bucket_block_geom(t_cap, s_cap)
    n_bands = -(-g // band)
    order, starts, cid_sorted = cell_sort(pos, box, g)
    if stop == "sort":
        return starts.sum(), order
    feats = _sorted_feats(pos, vel, mass, radius, order)
    if stop == "feats":
        return feats[:, 0].sum(), order
    ts_tab, cnt_t, ss9, run9 = _window_tables(starts, g, band, _whole_grid(g, dev))
    if stop == "tables":
        return ts_tab.sum() + cnt_t.sum() + ss9.sum() + run9.sum(), order
    wsel, wvalid = take_rows((cnt_t > 0).reshape(-1), bmax)
    col_sel = wsel.long() // n_bands
    w_sel = wsel.long() - col_sel * n_bands
    cnt_sel = torch.where(wvalid, cnt_t[col_sel, w_sel], 0)
    run_sel = torch.where(wvalid[:, None], run9[col_sel, w_sel], 0)
    win = _descriptors(ts_tab[col_sel, w_sel], torch.clamp(cnt_sel, max=t_rows), ss9[col_sel, w_sel],
                       torch.clamp(run_sel, max=s_capw))
    if stop == "select":
        return win.sum(), order
    cs = cid_sorted.long()
    col_s = cs // g
    rank_t = torch.arange(n, device=dev) - ts_tab[col_s, (cs - col_s * g) // band]
    t_ok = rank_t < t_rows  # every body, its window selected or not
    if stop == "mask":
        return t_ok.sum(), order
    return Bucket0(feats, order, t_ok, win, t_rows, s_capw)


def launch(b: Bucket0, n: int, fused=collide_fused):
    """K2 (or `fused`, e.g. collide_fused_reference) on bucket 0's inputs
    for n bodies: (out_d [n, 8], out_j [n]) in body order, zeros and -1 for
    non-targets. The wrapper's outputs have the rows of its input (at least
    n); body order is their first n."""
    out_d, out_j = _outputs(b.feats.shape[0], b.feats.device)
    fused(b.feats, b.order, b.t_ok, b.win, out_d, out_j, *PAR, b.t_rows, b.s_capw)
    return out_d[:n], out_j[:n]


def nudge(pos, order, s):
    """The JAX probe's data chain: positions moved by (order % 7) 1e-7, then
    by the stage's scalar times 1e-20."""
    return (pos + (order % 7).to(torch.float32)[:, None] * 1e-7) + s.to(torch.float32) * 1e-20


def chain(pos, vel, mass, radius, box: float, g: int, band: int, bucket, stage: str, steps: int,
          layout=lambda b: b):
    """`steps` chained steps through `stage`; returns the last positions.
    Through "kernel", `layout` may recast the kernel's inputs (layoutvar's
    "blocks")."""
    for _ in range(steps):
        if stage == "kernel":
            b = build(pos, vel, mass, radius, box, g, band, bucket)
            out_d, _ = launch(layout(b), pos.shape[0])
            s, order = out_d[:, 0].sum(), b.order
        else:
            s, order = build(pos, vel, mass, radius, box, g, band, bucket, stop=stage)
        pos = nudge(pos, order, s)
    return pos


def configs(ns, cfgs):
    """[(n, g, band)] from the CLI's "N1,N2" and "g,B" tokens."""
    sizes = [int(x) for x in str(ns).split(",")]
    return [(n, *(int(x) for x in c.split(","))) for n, c in zip(sizes, cfgs or DEFAULT_CONFIGS)]


def main(ns=DEFAULT_NS, *cfgs, steps: int = 16, warmup: int = 4, device=CUDA) -> list:
    """Time every stage at each (N, g, B); print one JSON line per N and
    return the result dicts."""
    device = timing.require(device)
    name = timing.device_name(device)
    out = []
    for n, g, band in configs(ns, cfgs):
        pos, vel, mass, radius, box, buckets = scene(n, g, band, device)
        r = dict(n=n, g=g, band=band, bucket0=list(buckets[0]), n_buckets=len(buckets))
        prev = 0.0
        for st in STAGES:
            ms = time_chain(lambda s: chain(pos, vel, mass, radius, box, g, band, buckets[0], st, s), device,
                            steps, warmup)
            r[f"ms_{st}"], r[f"d_{st}"] = ms, ms - prev
            prev = ms
        r.update(no_counterpart=list(NO_COUNTERPART), device=name)
        print(json.dumps(r), flush=True)
        out.append(r)
    return out


if __name__ == "__main__":
    main(*sys.argv[1:])
