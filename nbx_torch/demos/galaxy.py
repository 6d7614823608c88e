"""Galaxy demo (port of `examples/galaxy_demo.py`): the reference's startup
scene with full physics and the composite renderer, written as PNG frames
and a self-contained HTML player.

    python -m nbx_torch demo galaxy [n_frames] [out_dir]

The reference's opening, headless: a hot metal core, a 150-body disk, live
merges and bounces, trails, particles, flash lights, bloom. Every fourth
frame is written (frames 0, 4, 8, ...). Each image is read back a frame late
(`viewer.AsyncReadback`), the trajectory once at the end.
"""

from __future__ import annotations

import os
import sys
import tempfile

import torch

from nbx_torch import scene, sim
from nbx_torch.config import CUDA, SimConfig
from nbx_torch.render import viewer
from nbx_torch.render.pipeline import FrameState, render_and_advance
from nbx_torch.render.splat import Camera


def main(n_frames: int = 240, out_dir: str | None = None, device=CUDA) -> list:
    """Run n_frames and write every fourth frame's PNG, trajectory.json and
    player.html to out_dir (default: nbx_torch_galaxy in the temporary
    directory). Returns the PNG paths."""
    out_dir = out_dir or os.path.join(tempfile.gettempdir(), "nbx_torch_galaxy")
    device = torch.device(device)
    cfg = SimConfig().to(device)
    st = scene.make_state(cfg, scene.reference_galaxy(seed=0), device, seed=0)
    fr = FrameState.create(cfg.capacity, cfg.trail_length, device=device)
    cam = Camera.default(device)
    os.makedirs(out_dir, exist_ok=True)

    rb = viewer.AsyncReadback()
    frames, traj, temps = [], [], []
    for k in range(n_frames):
        st, ev = sim.step(st, cfg)
        fr, img = render_and_advance(fr, st, cfg, ev, cam, width=640, height=360)
        if k % 4 == 0:
            ready = rb.push(viewer.to_u8_device(img))
            if ready is not None:
                frames.append(ready)
        traj.append(st.pos.clone())
        temps.append(st.temp.clone())
    last = rb.flush()
    if last is not None:
        frames.append(last)

    paths = viewer.write_frames(out_dir, frames)
    tj = os.path.join(out_dir, "trajectory.json")
    viewer.record_trajectory(tj, torch.stack(traj), st.radius(cfg), torch.stack(temps), st.mat, stride=2)
    viewer.write_html_player(os.path.join(out_dir, "player.html"), tj)
    print(f"{len(paths)} frames + player.html -> {out_dir}")
    print(f"final bodies alive: {int(st.n_alive)}")
    return paths


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 240, sys.argv[2] if len(sys.argv) > 2 else None)
