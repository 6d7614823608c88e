"""A/B probe of the bucketed pass's bulk-bucket construction at two N (port
of `nbx/bench/layoutvar.py`).

The JAX probe's five variants ("cur", "ds", "dsT", "dsTb", "dsb") all
materialise the same [bmax, 16, 9 s_capw] source blocks and differ only in
how XLA gathers them. On the card one advanced-index gather builds such
blocks, so the port's variants are the two layouts the kernel can read:

  desc    window descriptors into the cell-sorted rows: the port's shipped
          layout (`nbx_torch.bench.layoutsplit.build`)
  blocks  the TPU's layout: each selected window's targets and its 9 strips
          copied into one contiguous buffer (rows, ids and the source mask
          gathered alike), then the same kernel on descriptors into that
          copy

Both visit the same pairs in the same lane order, so their deltas and
partners are bitwise equal; that is asserted once per N before timing, as
the JAX probe asserts its variants' identity, and a mismatch is counted in
`mismatch_<variant>`. Each timing is a chain of steps (the JAX probe's data
chain) of the whole bucket-0 pass, construction and kernel, between two CUDA
events after a warm-up chain. One cumulative JSON line per variant.

    python -m nbx_torch.bench.layoutvar [N1,N2] [cfg1] [cfg2]
    # defaults: 131072,262144 32,8 40,8
"""

from __future__ import annotations

import json
import sys

import torch

from nbx_torch.bench import timing
from nbx_torch.bench.collsplit import _time as time_chain
from nbx_torch.bench.layoutsplit import DEFAULT_NS, Bucket0, build, chain, configs, launch, scene
from nbx_torch.config import CUDA
from nbx_torch.ops.collide import _descriptors


def blocks(b: Bucket0) -> Bucket0:
    """Bucket 0's inputs in the TPU's layout: window w's t_rows target rows
    and then its 9 strips of s_capw rows each, at rows w (t_rows + 9 s_capw)
    on, gathered from the cell-sorted rows (lanes past a window's counts hold
    row 0 and are never read), with descriptors into the copy. The copy has
    at least n rows, since the kernel's wrapper writes body order into
    outputs of its input's rows."""
    n = b.feats.shape[0]
    w = b.win.long()
    dev = w.device
    bmax = w.shape[0]
    width = b.t_rows + 9 * b.s_capw
    ar_t = torch.arange(b.t_rows, device=dev)
    ar_s = torch.arange(b.s_capw, device=dev)
    t_idx = torch.where(ar_t < w[:, 1:2], w[:, 0:1] + ar_t, 0)  # [bmax, t_rows]
    s_idx = torch.where(ar_s < w[:, 3::2, None], w[:, 2::2, None] + ar_s, 0)  # [bmax, 9, s_capw]
    idx = torch.cat([t_idx, s_idx.reshape(bmax, -1)], dim=1).reshape(-1)
    idx = torch.cat([idx, idx.new_zeros(max(n - idx.shape[0], 0))])
    base = torch.arange(bmax, device=dev) * width
    strips = base[:, None] + b.t_rows + torch.arange(9, device=dev) * b.s_capw
    win = _descriptors(base, w[:, 1], strips, w[:, 3::2])
    return Bucket0(b.feats[idx], b.order[idx], b.t_ok[idx], win, b.t_rows, b.s_capw)


LAYOUTS = {"desc": lambda b: b, "blocks": blocks}
VARIANTS = tuple(LAYOUTS)


def once(pos, vel, mass, radius, box: float, g: int, band: int, bucket, variant: str):
    """One bucket-0 pass in `variant`'s layout: (out_d [n, 8], out_j [n]) in
    body order."""
    return launch(LAYOUTS[variant](build(pos, vel, mass, radius, box, g, band, bucket)), pos.shape[0])


def main(ns=DEFAULT_NS, *cfgs, steps: int = 16, warmup: int = 4, device=CUDA) -> list:
    """Check each variant bitwise against "desc" and time it at each
    (N, g, B); print a cumulative JSON line after each variant and return
    the last line of each N."""
    device = timing.require(device)
    name = timing.device_name(device)
    out = []
    for n, g, band in configs(ns, cfgs):
        pos, vel, mass, radius, box, buckets = scene(n, g, band, device)
        r = dict(n=n, g=g, band=band, bucket0=list(buckets[0]), n_buckets=len(buckets), ref_variant=VARIANTS[0],
                 device=name)
        ref = None
        for v in VARIANTS:
            got = once(pos, vel, mass, radius, box, g, band, buckets[0], v)
            if ref is None:
                ref = got
            elif not all(torch.equal(a, b) for a, b in zip(ref, got)):
                r[f"mismatch_{v}"] = int(sum((a != b).sum() for a, b in zip(ref, got)))
            r[f"ms_{v}"] = time_chain(lambda s: chain(pos, vel, mass, radius, box, g, band, buckets[0], "kernel", s,
                                                      LAYOUTS[v]), device, steps, warmup)
            print(json.dumps(r), flush=True)
        out.append(r)
    return out


if __name__ == "__main__":
    main(*sys.argv[1:])
