"""The 1M-body full-physics rendered galaxy merger (port of
`examples/merger_full.py`, BASELINE config 5 as one program): P3M gravity at
the scene-census tune (kernels K4 and K5), the occupancy-bucketed collision
pass (K2) with bounces, merges, fractures and timers, thermal decay, and the
at-scale frame renderer (splats, 64 impostors, 512 ribbon trails, event
flashes, bloom).

    python -m nbx_torch demo merger_full [n] [n_frames] [out_dir] [steps_per_frame]

Two reference-recipe galaxies on a bound grazing course
(`scene.galaxy_merger_3d`). One change from the example: it clamps the
collision grid at 64 cells, where both packages' `bucketed_layout_for`
rejects every band at n = 1,048,576; here the grid is the finest whose cells
hold 2.2 r_max (`merger_setup`). The example shrinks itself to 2,048 bodies
off a TPU; here n is only what the caller passes. Prints one JSON line of
results, the example's keys.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from nbx_torch import collisions_scaled, scene
from nbx_torch.config import CUDA, SimConfig, body_radius
from nbx_torch.ops import collide, p3m
from nbx_torch.ops.pm import isolated_green_hat

MERGER_CFG = dict(G=0.5, dt=0.35, sub_steps=1, softening=0.5, merge_time=0.5,
                  fracture_threshold=25.0, max_fractures=32)
COUNTERS = ("n_bounces", "n_merges", "n_fractures", "n_dropped")


def merger_setup(dev, n: int, tune: dict | None = None):
    """The example's scene and configuration on `dev`: the scene-census P3M
    tune (or an explicit one with p3m_tune_for's keys), the collision grid
    from the largest radius, buckets from
    bucketed_layout_for, the smoothed Green's function once per scene.
    Returns (state, cfg, box, the keywords of granular_full_kdk_scan).

    The example clamps the collision grid at 64 cells, and at n = 1,048,576
    bucketed_layout_for (the JAX package's as the port's) rejects every band
    at 64 (the tail windows of the cores need 20,763 to 45,828 fused source
    lanes, over its 8,192). Here the grid is the finest whose cells still
    hold 2.2 r_max: 204 cells at n = 1,048,576, where band 8 fits."""
    sc, box = scene.galaxy_merger_3d(n=n, seed=0)
    cfg = SimConfig(**MERGER_CFG).to(dev)
    r_max = float(body_radius(torch.from_numpy(sc["mass"]), torch.from_numpy(sc["mat"]),
                              SimConfig().materials).max())
    g_c = int(box / (2.2 * r_max))
    g_c = max(8, g_c - g_c % 2)
    band = 8 if g_c >= 16 else 2
    if tune is None:
        tune = p3m.p3m_tune_for(sc["pos"], box, residual_budget=131072, affected_budget=2048, k_max=1536)
    kw = dict(n_cells=g_c, band_cells=band, buckets=collide.bucketed_layout_for(sc["pos"], box, g_c, band),
              force_impl="p3m", log_events=True, pm_grid=tune["g"], p3m=tune,
              green_hat=isolated_green_hat(box, tune["g"], p3m.smoothing_length(box, tune["n_cells"]),
                                           smoothed=True, device=dev))
    st = collisions_scaled.make_granular_state(sc["pos"], sc["vel"], sc["mass"], mat=sc["mat"],
                                               temp=sc["temp"], seed=0, device=dev)
    return st, cfg, box, kw


def main(n: int = 1_048_576, n_frames: int = 180, out_dir: str | None = None, steps_per_frame: int = 2,
         width: int = 640, height: int = 360, device=CUDA) -> dict:
    """Run n_frames of steps_per_frame steps, render every frame, write the
    PNGs to out_dir (default: nbx_torch_merger_full in the temporary
    directory) and print the result line. Returns its dict."""
    from nbx_torch.render import viewer
    from nbx_torch.render.pipeline import FrameState, render_granular, starfield_directions
    from nbx_torch.render.splat import Camera

    out_dir = out_dir or os.path.join(tempfile.gettempdir(), "nbx_torch_merger_full")
    dev = torch.device(device)
    os.makedirs(out_dir, exist_ok=True)
    st, cfg, box, kw = merger_setup(dev, n)
    tune = kw["p3m"]
    print(f"[merger_full] p3m tune: {tune}", file=sys.stderr)
    print(f"[merger_full] collisions: g={kw['n_cells']} band={kw['band_cells']} buckets={kw['buckets']}",
          file=sys.stderr)

    # the renderer: tiered trails on the heaviest bodies
    n_trails = min(512, n)
    trail_idx = torch.from_numpy(np.argsort(-st.mass.cpu().numpy())[:n_trails].astype(np.int32)).to(dev)
    frame = FrameState.create(capacity=n_trails, trail_length=40, device=dev)
    stars = starfield_directions(device=dev)
    cam = Camera(eye=torch.tensor([0.5 * box, 0.92 * box, 1.55 * box], dtype=torch.float32, device=dev),
                 target=torch.full((3,), 0.5 * box, dtype=torch.float32, device=dev),
                 up=torch.tensor([0.0, 1.0, 0.0], device=dev))

    t_total0 = time.perf_counter()
    step_ms, render_ms = [], []
    counters = dict.fromkeys(COUNTERS, 0)
    ovf = unc = 0
    frames = []
    for k in range(n_frames):
        t0 = time.perf_counter()
        st, totals, ev = collisions_scaled.granular_full_kdk_scan(st, cfg, box, steps_per_frame, **kw)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        frame, img = render_granular(frame, st, cfg, ev, cam, trail_idx, width=width, height=height, stars=stars,
                                     exposure=2.0, n_impostors=64)
        frames.append(viewer.to_u8(img))  # the read back waits for the frame
        t2 = time.perf_counter()
        step_ms.append((t1 - t0) * 1e3 / steps_per_frame)
        render_ms.append((t2 - t1) * 1e3)
        for key in counters:
            counters[key] += int(totals[key])
        ovf = max(ovf, int(totals["n_overflow"]))
        unc = max(unc, int(totals["n_uncorrected"]))
        if k % 10 == 0 or k == n_frames - 1:
            print(f"[merger_full] frame {k}: step {step_ms[-1]:.0f} ms render {render_ms[-1]:.0f} ms  "
                  f"merges={counters['n_merges']} fractures={counters['n_fractures']} "
                  f"bounces={counters['n_bounces']} ovf={ovf} unc={unc}", file=sys.stderr, flush=True)
    wall = time.perf_counter() - t_total0

    viewer.write_frames(out_dir, frames)
    # warm per-frame numbers: the first frame (kernel loads) dropped
    s_ms = np.asarray(step_ms[1:] or step_ms)
    r_ms = np.asarray(render_ms[1:] or render_ms)
    result = dict(
        n=n, n_frames=n_frames, steps_per_frame=steps_per_frame, box=box,
        p3m=dict(g=tune["g"], n_cells=tune["n_cells"], k=tune["max_per_cell"], a_over_h=round(tune["a_over_h"], 3)),
        collisions=dict(g=kw["n_cells"], band=kw["band_cells"]),
        ms_per_step_p50=float(np.median(s_ms)),
        ms_per_render_p50=float(np.median(r_ms)),
        s_per_frame_p50=float(np.median(s_ms)) * steps_per_frame / 1e3 + float(np.median(r_ms)) / 1e3,
        wall_s=wall, n_overflow_max=ovf, n_uncorrected_max=unc, device=str(dev), **counters,
    )
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    a = sys.argv[1:]
    main(int(a[0]) if a else 1_048_576, int(a[1]) if len(a) > 1 else 180, a[2] if len(a) > 2 else None,
         int(a[3]) if len(a) > 3 else 2)
