"""The rank program of tests/test_torch_multihost.py: one process of a gloo
world started the way a launcher starts one (MASTER_ADDR, MASTER_PORT,
WORLD_SIZE, RANK, LOCAL_RANK, GROUP_RANK in the environment), driving
`nbx_torch.parallel.multihost`.

    python tests/torch_multihost_ranks.py CASE OUTDIR

CASE "d4" (four ranks, two "hosts" of two) and "d2" (two ranks, one a host):
`initialize` (twice: it is idempotent), `make_host_mesh`,
`shard_state_multihost` from this rank's rows of the scene of
tests/multihost_worker.py, 3 sharded KDK steps and the all-reduced energy,
`render_sharded`, `render_spatial` of this rank's slab of the spatial scene,
the merger demo (`demos.merger.main`, into OUTDIR/merger_<CASE>, and at an N
that does not divide over the ranks), and `save_sharded` into
OUTDIR/ck_<CASE>. "d2" then waits for OUTDIR/ck_d4 and loads it onto its
mesh of 2 (`load_sharded` re-shards). Each rank writes
OUTDIR/<CASE>_r<RANK>.npz. Imports no jax.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

N, G, EPS, H, STEPS = 128, 0.5, 0.5, 0.01, 3
W, HT = 64, 48


def scene():
    """tests/multihost_worker.py's global scene."""
    rng = np.random.default_rng(0)
    pos = rng.normal(0, 10, (N, 3)).astype(np.float32)
    vel = rng.normal(0, 1, (N, 3)).astype(np.float32)
    mass = rng.uniform(1, 5, N).astype(np.float32)
    return pos, vel, mass


def camera(device="cpu"):
    from nbx_torch import convert

    return convert.camera_from_fields([0.0, 30.0, 60.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0], device=device)


SPATIAL_BOX, SPATIAL_CELLS = 100.0, 8


def spatial_scene():
    """The scene moved into the spatial step's box, and a camera on it."""
    from nbx_torch import convert

    pos, vel, mass = scene()
    cam = convert.camera_from_fields([50.0, 90.0, 160.0], [50.0, 50.0, 50.0], [0.0, 1.0, 0.0], device="cpu")
    return pos * 2.0 + 50.0, vel, mass, cam


def main(case: str, outdir: str) -> None:
    import torch
    import torch.distributed as dist

    from nbx_torch import checkpoint
    from nbx_torch.config import SimConfig
    from nbx_torch.demos import merger
    from nbx_torch.parallel import multihost, shard, spatial

    torch.set_num_threads(1)
    multihost.initialize(device="cpu")
    multihost.initialize(device="cpu")  # idempotent
    try:
        mesh = multihost.make_host_mesh(device_type="cpu")
        rank, world = dist.get_rank(), dist.get_world_size()
        coord = mesh.get_coordinate()[0]
        pos, vel, mass = scene()
        nl = N // world
        rows = slice(coord * nl, (coord + 1) * nl)
        st = multihost.shard_state_multihost(mesh, pos[rows], vel[rows], mass[rows])
        step = shard.make_sharded_step(mesh)
        st, _ = shard.run_sharded(st, step, G, EPS, H, STEPS)
        ke, pe = shard.sharded_energy(mesh, st, G, EPS)
        img = shard.render_sharded(mesh, st, camera(), width=W, height=HT)
        spos, svel, smass, scam = spatial_scene()
        sst = spatial.spatial_state_for(mesh, spos, svel, smass, SPATIAL_BOX, SPATIAL_CELLS)
        img_spatial = spatial.render_spatial(mesh, sst, SimConfig(), scam, width=W, height=HT)
        paths = merger.main(n=N, n_frames=2, out_dir=os.path.join(outdir, f"merger_{case}"), steps_per_frame=1,
                            device="cpu")
        try:
            merger.main(n=N + 1, n_frames=2, out_dir=os.path.join(outdir, f"merger_{case}_uneven"), device="cpu")
            uneven = "ran"
        except ValueError as e:
            uneven = str(e)
        out = dict(mesh=mesh.mesh.numpy(), coord=coord, energy=torch.stack([ke, pe]).numpy(), img=img.numpy(),
                   img_spatial=img_spatial.numpy(), n_spatial=int((sst.mass > 0).sum()),
                   merger_paths=np.array(paths, dtype=str), merger_uneven=np.str_(uneven),
                   **{f: getattr(st, f).numpy() for f in st._fields})
        ck = os.path.join(outdir, f"ck_{case}")
        checkpoint.save_sharded(ck, st, mesh)
        if case == "d2":  # re-shard the four-rank run's checkpoint onto this mesh of 2
            manifest = os.path.join(outdir, "ck_d4", checkpoint.MANIFEST)
            deadline = time.time() + 240
            while not os.path.exists(manifest):
                if time.time() > deadline:
                    raise TimeoutError(f"no {manifest}")
                time.sleep(0.2)
            back = checkpoint.load_sharded(os.path.join(outdir, "ck_d4"), mesh)
            out.update({f"from_d4_{f}": getattr(back, f).numpy() for f in back._fields})
        np.savez(os.path.join(outdir, f"{case}_r{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
