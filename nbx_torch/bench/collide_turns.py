"""The collision kernel's launches at the shapes `chip_smoke.py` holds them
at, timed by CUDA events, one JSON line a case.

    python nbx_torch/bench/collide_turns.py [--reps N] [case ...]

Cases: k2 (phase 6: the 131,072-body cloud of the live server, g = 40,
B = 12, its two buckets, each bucket's launch alone and both), k2m (phase
16: the same windows at 4 windows a block), k8 (phase 15: the granular
bench's debris disk at 32,16, full columns), slab (phase 21: bench
spatial's cloud at 32,8,96,104 as 1 slab), k7 (phase 18: K7 and K2 on
D = 1's windows of that cloud) and probe (phase 26: bucket 0 of the cloud
at 32,8, the "desc" and "blocks" layouts); default: all. Each line gives
the case, the launches timed, the windows, the ms of one pass (the mean of
--reps passes after one), the card's name and power limit, and a digest of
the outputs (sha1 of out_d's and out_j's bytes): two runs whose digests
agree wrote the same bits. The k2 and k2m lines also count the pairs
(targets x source lanes) and the warp-lanes the kernel walks (each
window's lanes once a warp's group of targets: the slots times lanes over
32), from the windows.

The script calls only the wrappers of `nbx_torch.ops.collide`, the passes
that record their launches and the benches' scene helpers, whatever
checkout of the port comes first on PYTHONPATH, so one command can time two
checkouts in turns (parent, change, change, parent). The cases record the
launches of the passes whose outputs `chip_smoke.py` checks in the phases
named above; phase 6 takes its launches from `cloud_calls` here. It needs a
card and raises without one.
"""

from __future__ import annotations

import argparse
import functools
import hashlib
import json

import torch

from nbx_torch.bench import granular, layoutsplit, layoutvar, timing
from nbx_torch.bench.granular import BOX, granular_cloud
from nbx_torch.config import SimConfig, body_radius
from nbx_torch.ops import collide

CASES = ("k2", "k2m", "k8", "slab", "k7", "probe")
N = 131_072
SPATIAL_CFG = (32, 8, 96, 104)  # bench spatial's g, B, Tc, Sc
PAR = (0.2, 0.5)  # restitution, friction


def _inputs(pos, vel, mass, dev):
    t = [torch.as_tensor(x, device=dev) for x in (pos, vel, mass)]
    radius = body_radius(t[2], torch.zeros_like(t[2], dtype=torch.int32), SimConfig().to(dev).materials)
    return (*t, radius)


def _recorder(fused):
    """fused, keeping each call's arguments for the replays."""
    calls = []

    def rec(*args):
        calls.append(args)
        fused(*args)

    return rec, calls


def _time(fused, calls, reps: int) -> tuple[float, str]:
    """ms of one pass of the recorded calls through fused, into copies of
    their outputs; the digest of those outputs after the passes."""
    calls = [(*c[:4], c[4].clone(), c[5].clone(), *c[6:]) for c in calls]

    def once():
        for c in calls:
            fused(*c)

    once()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        once()
    end.record()
    end.synchronize()
    h = hashlib.sha1()
    for c in calls:
        h.update(c[4].cpu().numpy().tobytes())
        h.update(c[5].cpu().numpy().tobytes())
    return start.elapsed_time(end) / reps, h.hexdigest()[:16]


def cloud_calls(inputs, box: float, g: int, b: int, buckets) -> list[tuple]:
    """The launches of one bucketed pass (phase 6) over inputs (pos, vel,
    mass, radius on the card) at g cells, bands of b, with buckets: one
    [(feats, order, t_ok, win, out_d, out_j, restitution, friction, t_rows,
    s_capw)] a bucket, into shared output buffers."""
    p, v, m, r = inputs
    n = p.shape[0]
    order, starts, cid = collide.cell_sort(p, box, g)
    feats = torch.cat([p, v, m[:, None], r[:, None]], dim=1)[order.long()]
    windows, t_ok, _ = collide._bucket_windows(starts, cid, n, g, b, buckets)
    out_d = torch.zeros((n, 8), device=p.device)
    out_j = torch.full((n,), -1, dtype=torch.int32, device=p.device)
    return [(feats, order, t_ok, w, out_d, out_j, *PAR, t_rows, s_capw) for w, t_rows, s_capw in windows]


def _cloud_calls(dev):
    """Phase 6's launches: the live server's cloud at g = 40, B = 12."""
    pos, vel, mass = granular_cloud(N, seed=0, box=BOX)
    return cloud_calls(_inputs(pos, vel, mass, dev), BOX, 40, 12, collide.bucketed_layout_for(pos, BOX, 40, 12))


def _warp_lanes(win, t_rows: int) -> int:
    """The lanes the kernel's warps walk: each window's lanes once for each
    group of targets a warp holds (32 R; this checkout's launch_shape, or
    32 where it has none: one target a thread)."""
    shape = getattr(collide, "launch_shape", None)
    per_warp = 32 * (shape(win.shape[0], t_rows).targets_a_thread if shape else 1)
    w = win.long()
    return int(((w[:, 1] + per_warp - 1) // per_warp * w[:, 3::2].sum(1)).sum())


def _bucket_lines(case: str, fused, calls, reps: int):
    out = []
    for name, sel in [(f"bucket {i}", [c]) for i, c in enumerate(calls)] + [("both", calls)]:
        ms, digest = _time(fused, sel, reps)
        out.append(dict(case=case, part=name, ms=ms, launches=len(sel), windows=[int(c[3].shape[0]) for c in sel],
                        t_rows=[c[8] for c in sel], digest=digest,
                        pairs=sum(int((c[3][:, 1].long() * c[3][:, 3::2].long().sum(1)).sum()) for c in sel),
                        warp_lanes=sum(_warp_lanes(c[3], c[8]) for c in sel)))
    return out


def case_k2(dev, reps):
    return _bucket_lines("k2", collide.collide_fused, _cloud_calls(dev), reps)


def case_k2m(dev, reps):
    fused = functools.partial(collide.collide_fused_multi, windows_per_block=4)
    return _bucket_lines("k2m W=4", fused, _cloud_calls(dev), reps)


def case_k8(dev, reps):
    pos, vel, mass, box = granular.scene_arrays(N, "disk")
    inputs = _inputs(pos, vel, mass, dev)
    g, k, band, packed, max_blocks = granular.parse_config("32,16")
    lay, _ = granular.size_layout(pos, box, g, band, packed, max_blocks)
    run, layout, fused = collide._layout_call(g, k, band, lay["packed"], lay["max_blocks"], lay["buckets"],
                                              lay["windows"])
    rec, calls = _recorder(fused)
    run(*inputs, box, g, *layout, *PAR, rec)
    ms, digest = _time(fused, calls, reps)
    return [dict(case="k8 disk 32,16", part="full columns", ms=ms, launches=len(calls),
                 windows=[int(c[3].shape[0]) for c in calls], t_rows=[c[8] for c in calls], digest=digest)]


def _spatial_cloud(dev):
    pos, vel, mass = granular_cloud(N, seed=0, box=BOX)
    return _inputs(pos, vel, mass, dev)


def case_slab(dev, reps):
    g, b, tc, sc = SPATIAL_CFG
    rec, calls = _recorder(collide.collide_fused_slab)
    collide.packed_collision_blocks_slab(*_spatial_cloud(dev), BOX, g, b, (tc, sc), *PAR, 0, g * g, fused=rec)
    ms, digest = _time(collide.collide_fused_slab, calls, reps)
    return [dict(case="slab", part="1 slab", ms=ms, launches=len(calls), windows=[int(c[3].shape[0]) for c in calls],
                 t_rows=[c[8] for c in calls], digest=digest)]


def case_k7(dev, reps):
    g, b, tc, sc = SPATIAL_CFG
    sg = (0.5, BOX / g / 3.0, 0.5)
    args = (*_spatial_cloud(dev), BOX, g, b, ((tc, sc, g * g * -(-g // b)),), "own_all", *PAR, -1, g, 0, None)
    rec7, calls7 = _recorder(collide.collide_fused_grav)
    collide._local_pass(*args, sg, fused=rec7)
    rec2, calls2 = _recorder(collide.collide_fused)
    collide._local_pass(*args, None, fused=rec2)
    calls7 = [(*c[:10], c[10], c[11].clone()) for c in calls7]
    out = []
    for name, fused, calls in (("K7", collide.collide_fused_grav, calls7), ("K2", collide.collide_fused, calls2)):
        ms, digest = _time(fused, calls, reps)
        out.append(dict(case="k7 D=1", part=name, ms=ms, launches=len(calls),
                        windows=[int(c[3].shape[0]) for c in calls], t_rows=[c[8] for c in calls], digest=digest))
    return out


def case_probe(dev, reps):
    g, band = 32, 8
    pos, vel, mass, radius, box, buckets = layoutsplit.scene(N, g, band, dev)
    b = layoutsplit.build(pos, vel, mass, radius, box, g, band, buckets[0])
    out = []
    for name, layout in (("desc", b), ("blocks", layoutvar.blocks(b))):
        rec, calls = _recorder(collide.collide_fused)
        layoutsplit.launch(layout, N, rec)
        ms, digest = _time(collide.collide_fused, calls, reps)
        out.append(dict(case="probe bucket 0", part=name, ms=ms, launches=len(calls),
                        windows=[int(c[3].shape[0]) for c in calls], t_rows=[c[8] for c in calls], digest=digest))
    return out


def main(cases=CASES, reps: int = 20) -> list[dict]:
    if not torch.cuda.is_available():
        raise RuntimeError("collide_turns needs a CUDA device")
    unknown = set(cases) - set(CASES)
    if unknown:
        raise ValueError(f"unknown cases {sorted(unknown)}; choose from {CASES}")
    dev = torch.device("cuda", 0)
    card = timing.device_name(dev)
    rows = []
    for case in cases:
        for row in globals()[f"case_{case}"](dev, reps):
            row.update(device=card)
            print(json.dumps(row), flush=True)
            rows.append(row)
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("cases", nargs="*", default=list(CASES), help=" ".join(CASES))
    ap.add_argument("--reps", type=int, default=20)
    a = ap.parse_args()
    main(a.cases, a.reps)
