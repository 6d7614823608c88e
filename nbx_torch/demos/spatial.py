"""Spatial halo-exchange demo (port of `examples/spatial_demo.py`): the
O(N/D)-memory sharded granular path.

    python -m nbx_torch demo spatial [n_bodies] [n_steps] [out_dir]
    # defaults: 8192 60

A converging debris cloud under PM gravity (64^3) with the full collision
physics (bounces, timers, merges, fractures) on the spatially owned step
(`parallel.spatial.make_spatial_granular_step`): each rank owns an x-slab of
the collision grid, bodies migrate when they cross a slab face, and
neighbours are seen through boundary-layer halo exchanges. It runs over the
ranks of the process group (`parallel.multihost.initialize`, one rank a
card); where none is set up, over a group of this process alone (D = 1),
which still runs the whole protocol. About every sixth step a snapshot is
rendered from the slab-owned state (`render_spatial`: each rank splats its
own bodies, one all-reduce composites the image; no body is gathered), and
rank 0 writes the first six side by side as spatial_strip.png. (The example
skips the strip where `imageio` is missing; the port writes its own PNGs.)
"""

from __future__ import annotations

import math
import os
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from nbx_torch.config import CUDA, SimConfig

BOX = 100.0


def cloud(n: int):
    """The example's converging cloud: (pos, vel, mass) numpy float32."""
    rng = np.random.default_rng(0)
    pos = rng.uniform(15, 85, (n, 3)).astype(np.float32)
    vel = ((50.0 - pos) * 0.03 + rng.normal(0, 0.4, (n, 3))).astype(np.float32)
    mass = rng.uniform(0.2, 1.0, n).astype(np.float32)
    return pos, vel, mass


def config() -> SimConfig:
    return SimConfig(G=0.5, dt=0.016, sub_steps=1, merge_time=0.1, fracture_threshold=6.0)


def layout(n: int, d: int) -> dict:
    """The example's step parameters for n bodies over d ranks: g = lcm(16,
    d) (any rank count divides it), B = 4, packed caps (96, 256), the halo
    and migration caps, PM on a 64^3 mesh."""
    g = 16 * d // math.gcd(16, d)
    return dict(n_cells=g, band_cells=4, packed_caps=(96, 256), halo_cap=max(256, 4 * n // g),
                mig_cap=max(128, n // 32), force_impl="pm", pm_grid=64)


def main(n: int = 8192, n_steps: int = 60, out_dir: str | None = None, device=CUDA) -> str | None:
    """Run n_steps on the spatial step and write the snapshot strip to
    out_dir (default: nbx_torch_spatial in the temporary directory) on rank
    0. Returns its path on rank 0, None on the others."""
    from nbx_torch.parallel import shard

    dev = torch.device(device)
    with shard.local_world("cpu:gloo,cuda:nccl" if dev.type == "cuda" else "gloo"):
        return _run(n, n_steps, out_dir or os.path.join(tempfile.gettempdir(), "nbx_torch_spatial"), dev)


def _run(n: int, n_steps: int, out_dir: str, dev: torch.device) -> str | None:
    from nbx_torch.parallel import shard, spatial
    from nbx_torch.render import viewer
    from nbx_torch.render.splat import Camera

    d = dist.get_world_size()
    leader = dist.get_rank() == 0
    mesh = shard.make_mesh(d, device_type=dev.type)
    cfg = config()
    kw = layout(n, d)
    g = kw.pop("n_cells")
    step = spatial.make_spatial_granular_step(mesh, cfg, BOX, g, **kw)
    pos, vel, mass = cloud(n)
    st = spatial.spatial_state_for(mesh, pos, vel, mass, BOX, g)
    cfg = cfg.to(shard.mesh_device(mesh))
    cam = Camera.default(shard.mesh_device(mesh))
    every = max(1, n_steps // 6)
    shots = []
    t0 = time.perf_counter()
    for i in range(n_steps):
        st, c = step(st, cfg.dt)
        if i % every == 0 or i == n_steps - 1:
            live = (st.mass > 0).sum()
            dist.all_reduce(live)
            print(f"step {i:4d}: alive={int(live)} bounces={int(c['n_bounces'])} merges={int(c['n_merges'])} "
                  f"fractures={int(c['n_fractures'])} transit={int(c['in_transit'])} "
                  f"overflow={int(c['n_overflow'])}", flush=True)
            img = spatial.render_spatial(mesh, st, cfg, cam, width=480, height=270)
            shots.append(viewer.to_u8(img))
    dt = time.perf_counter() - t0
    if not leader:
        return None
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "spatial_strip.png")
    viewer.write_png(path, np.concatenate(shots[:6], axis=1))
    print(f"{n_steps} steps at N={n}, D={d}: {dt / max(n_steps, 1) * 1e3:.0f} ms/step (snapshots included); "
          f"wrote {path}")
    return path


if __name__ == "__main__":
    a = sys.argv[1:]
    main(int(a[0]) if a else 8192, int(a[1]) if len(a) > 1 else 60, a[2] if len(a) > 2 else None)
