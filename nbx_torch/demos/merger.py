"""Galaxy-merger demo (port of `examples/merger_demo.py`): two disk galaxies
on a collision course, gravity-only KDK at scale (the direct sum, kernel K1),
splat rendering on the device.

    python -m nbx_torch demo merger [n] [n_frames] [out_dir]

In a process group of several ranks (`parallel.multihost.initialize`) the
step shards the bodies over the ranks (`parallel.shard`; n must divide over
them) and the frame is composited by `render_sharded`. Alone, one device
runs the step and the splat. Rank 0 writes every second frame.
"""

from __future__ import annotations

import os
import sys
import tempfile
import time

import torch
import torch.distributed as dist

from nbx_torch import scene
from nbx_torch.bench.latency import kdk_scan
from nbx_torch.config import CUDA, default_materials
from nbx_torch.render import viewer
from nbx_torch.render.colormap import tonemap
from nbx_torch.render.splat import Camera, splat_bodies_hdr


def main(n: int = 131072, n_frames: int = 120, out_dir: str | None = None, steps_per_frame: int = 4,
         device=CUDA) -> list:
    """Run n_frames of steps_per_frame steps at N = n and write every second
    frame (default out_dir: nbx_torch_merger in the temporary directory).
    Returns the PNG paths (on rank 0; none on the others)."""
    out_dir = out_dir or os.path.join(tempfile.gettempdir(), "nbx_torch_merger")
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n % world:
        raise ValueError(f"N={n} bodies do not divide over {world} ranks")
    leader = not dist.is_initialized() or dist.get_rank() == 0
    sc = scene.galaxy_merger(n=n, separation=260.0, approach_speed=0.8, seed=0)
    G, eps, h = 0.5, 0.5, 0.02
    if world > 1:
        from nbx_torch.parallel import shard

        mesh = shard.make_mesh(world, device_type="cuda" if dist.get_backend() == "nccl" else "cpu")
        dev = shard.mesh_device(mesh)
        cam = _camera(dev)
        st = shard.shard_state(mesh, sc["pos"], sc["vel"], sc["mass"])
        step = shard.make_sharded_step(mesh)

        def advance(st):
            for _ in range(steps_per_frame):
                st = step(st, G, eps, h)
            return st

        def render(st):
            return shard.render_sharded(mesh, st, cam, width=640, height=360)
    else:
        dev = torch.device(device)
        cam = _camera(dev)
        mass = torch.from_numpy(sc["mass"]).to(dev)
        st = (torch.from_numpy(sc["pos"]).to(dev), torch.from_numpy(sc["vel"]).to(dev))
        st = (*st, torch.zeros_like(st[0]))
        mats = default_materials(dev)
        radius = torch.full((n,), 0.8, device=dev)
        temp = torch.zeros(n, device=dev)
        mat = torch.zeros(n, dtype=torch.int32, device=dev)
        alive = torch.ones(n, dtype=torch.bool, device=dev)

        def advance(st):
            return kdk_scan(st[0], st[1], mass, G, eps, h, steps_per_frame, acc0=st[2])

        def render(st):
            hdr = splat_bodies_hdr(st[0], radius, temp, mat, alive, mats.color1, mats.color2, cam, width=640,
                                   height=360)
            return tonemap(hdr, 4.0)

    t0 = time.time()
    rb = viewer.AsyncReadback()
    frames = []
    for k in range(n_frames):
        st = advance(st)
        if k % 2 == 0:
            ready = rb.push(viewer.to_u8_device(render(st)))
            if ready is not None:
                frames.append(ready)
    last = rb.flush()
    if last is not None:
        frames.append(last)
    wall = time.time() - t0
    if not leader:
        return []
    paths = viewer.write_frames(out_dir, frames)
    rate = n * n * steps_per_frame * n_frames / wall
    print(f"{len(frames)} frames -> {out_dir}; {wall:.1f}s ({rate:.2e} pairs/s sustained incl. render+readback)")
    return paths


def _camera(dev) -> Camera:
    return Camera(eye=torch.tensor([0.0, 220.0, 420.0], device=dev), target=torch.zeros(3, device=dev),
                  up=torch.tensor([0.0, 1.0, 0.0], device=dev))


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 131072, int(sys.argv[2]) if len(sys.argv) > 2 else 120,
         sys.argv[3] if len(sys.argv) > 3 else None)
