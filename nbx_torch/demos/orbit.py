"""Orbit movie (port of `examples/orbit_movie.py`): the reference galaxy under
full physics with a scripted camera, an eased orbit sweep that dollies in
while the disk evolves (`render.campath.orbit_path` driving the full render
pipeline: impostors, trails, particles, flashes, stars, bloom).

    python -m nbx_torch demo orbit [n_frames] [out_dir] [steps_per_frame]

Every frame's PNG is written; stitch them with, for example,
`ffmpeg -r 30 -i frame_%05d.png -pix_fmt yuv420p orbit.mp4`.
"""

from __future__ import annotations

import dataclasses
import math
import os
import sys
import tempfile
import time

import torch

from nbx_torch import scene, sim
from nbx_torch.config import CUDA, SimConfig
from nbx_torch.render import pipeline, viewer
from nbx_torch.render.campath import orbit_path
from nbx_torch.render.splat import Camera


def cameras(n_frames: int, device) -> list:
    """The example's camera path: 1.5 turns of yaw, -0.25 rad of pitch, a
    zoom to 0.45, eased."""
    return list(orbit_path(Camera.default(device), n_frames, d_yaw=1.5 * math.pi, d_pitch=-0.25, zoom=0.45,
                           ease=True))


def flatten_events(evs):
    """[steps, substeps, ...] stacked Events -> [steps * substeps, ...], so
    every substep's merges and flashes render, not only the last step's."""
    return dataclasses.replace(evs, **{f.name: getattr(evs, f.name).flatten(0, 1)
                                       for f in dataclasses.fields(evs)})


def main(n_frames: int = 90, out_dir: str | None = None, steps_per_frame: int = 2, device=CUDA) -> list:
    """Render n_frames of steps_per_frame steps each along the camera path
    and write every frame's PNG to out_dir (default: nbx_torch_orbit in the
    temporary directory). Returns the PNG paths."""
    out_dir = out_dir or os.path.join(tempfile.gettempdir(), "nbx_torch_orbit")
    os.makedirs(out_dir, exist_ok=True)
    dev = torch.device(device)
    cfg = SimConfig().to(dev)
    st = scene.make_state(cfg, scene.reference_galaxy(seed=0), dev, seed=0)
    frame = pipeline.FrameState.create(cfg.capacity, cfg.trail_length, device=dev)
    stars = pipeline.starfield_directions(device=dev)
    rb = viewer.AsyncReadback()
    frames = []
    t0 = time.perf_counter()
    for f, cam in enumerate(cameras(n_frames, dev)):
        st, evs = sim.run(st, cfg, steps_per_frame)
        frame, img = pipeline.render_and_advance(frame, st, cfg, flatten_events(evs), cam, width=640, height=360,
                                                 stars=stars)
        ready = rb.push(viewer.to_u8_device(img))
        if ready is not None:
            frames.append(ready)
        if f % 30 == 0:
            print(f"frame {f}", flush=True)
    last = rb.flush()
    if last is not None:
        frames.append(last)
    dt = time.perf_counter() - t0
    paths = viewer.write_frames(out_dir, frames)
    print(f"{n_frames} frames: {dt / max(n_frames, 1) * 1e3:.0f} ms/frame -> {out_dir}")
    return paths


if __name__ == "__main__":
    a = sys.argv[1:]
    main(*(int(x) if x.isdigit() else x for x in a))
