"""Granular-dynamics demo at scale (port of `examples/granular_demo.py`): a
self-gravitating debris disk around a hot m = 2000 core with the full
collision physics (bounce, friction, heating, contact-timer merges,
fractures) through the fused collision pass (K2), direct-sum gravity (K1),
rendered by the splat renderer to PNG frames.

    python -m nbx_torch demo granular [n] [n_frames] [out_dir] [steps_per_frame]

The disk is a peaked scene (a thin annulus), so the banded per-cell-cap
layout runs it: g = 28, K = 12, B = 6 (`bench.granular.DEMO_LAYOUT`), 4
steps a frame. The disk comes from `bench.granular.demo_state`, whose
masses scale as 32768 / n above 32,769 bodies (the JAX bench's rule) where
the example keeps them; at the default n the two are the same arrays.
"""

from __future__ import annotations

import os
import sys
import tempfile
import time

import torch

from nbx_torch.bench import granular
from nbx_torch.collisions_scaled import granular_full_kdk_scan
from nbx_torch.config import CUDA, body_radius
from nbx_torch.render import viewer
from nbx_torch.render.colormap import tonemap
from nbx_torch.render.splat import Camera, splat_bodies_hdr

COUNTERS = ("n_bounces", "n_merges", "n_fractures")


def camera(device) -> Camera:
    """The example's camera: above and in front of the disk's centre."""
    return Camera(eye=torch.tensor([50.0, 90.0, 120.0], device=device),
                  target=torch.tensor([50.0, 50.0, 50.0], device=device),
                  up=torch.tensor([0.0, 1.0, 0.0], device=device))


def main(n: int = granular.DEMO_N, n_frames: int = 60, out_dir: str | None = None,
         steps_per_frame: int = granular.DEMO_STEPS_PER_FRAME, device=CUDA) -> dict:
    """Run n_frames of steps_per_frame steps, write each frame's PNG to
    out_dir (default: nbx_torch_granular in the temporary directory) and
    print the totals. Returns the totals."""
    out_dir = out_dir or os.path.join(tempfile.gettempdir(), "nbx_torch_granular")
    os.makedirs(out_dir, exist_ok=True)
    dev = torch.device(device)
    cfg = granular.bench_config().to(dev)
    st = granular.demo_state(n, device=dev)
    cam = camera(dev)
    mats = cfg.materials
    sums = {k: torch.zeros((), dtype=torch.int64, device=dev) for k in COUNTERS}
    rb = viewer.AsyncReadback()
    frames = []
    t0 = time.perf_counter()
    for f in range(n_frames):
        st, totals = granular_full_kdk_scan(st, cfg, granular.BOX, steps_per_frame, **granular.DEMO_LAYOUT)
        for k in COUNTERS:
            sums[k] = sums[k] + totals[k]
        alive = st.mass > 0
        hdr = splat_bodies_hdr(st.pos, body_radius(st.mass, st.mat, mats), st.temp, st.mat, alive,
                               mats.color1, mats.color2, cam, width=640, height=360)
        ready = rb.push(viewer.to_u8_device(tonemap(hdr, exposure=2.5)))
        if ready is not None:
            frames.append(ready)
        if f % 10 == 0:
            print(f"frame {f}: alive={int(alive.sum())} bounces={int(sums['n_bounces'])} "
                  f"merges={int(sums['n_merges'])} fractures={int(sums['n_fractures'])}", flush=True)
    last = rb.flush()
    if last is not None:
        frames.append(last)
    dt = time.perf_counter() - t0
    viewer.write_frames(out_dir, frames)
    totals_sum = {k: int(v) for k, v in sums.items()}
    print(f"{n_frames} frames x {steps_per_frame} steps at N={n}: {dt / max(n_frames, 1) * 1e3:.0f} ms/frame -> "
          f"{out_dir} (totals: {totals_sum})")
    return totals_sum


if __name__ == "__main__":
    a = sys.argv[1:]
    main(*(int(x) if x.isdigit() else x for x in a))
