"""The scenes of tests/test_spatial.py, and the rank body that runs them
through the port's spatial step (`nbx_torch.parallel.spatial`) on a gloo
process group, for tests/test_torch_spatial.py.

    python tests/torch_spatial_ranks.py KIND RANK WORLD PORT OUTDIR

runs every scene of KIND ("1d": a 1-D mesh of 8 ranks, "2d": a 2x4 mesh,
"d1": one rank) as rank RANK of WORLD, meeting the other ranks at
tcp://127.0.0.1:PORT, and writes OUTDIR/KIND/<scene>_r<RANK>.npz: the
rank's slots after spatial_state_for (step 0) and after each step, and the
step's counters. Fracture uniforms come from OUTDIR/draws.npz when a scene
has them there (the JAX step's per-rank streams, rebuilt by the test). This
file imports no jax; tests/torch_spatial_jax_worker.py runs the same scenes
through the JAX package.

With a KIND of NCCL_KINDS (one rank a card: "nccl_1d2", a 1-D mesh of 2
whose two neighbours are one peer; "nccl_1d4"; "nccl_2x2") each rank runs
its mesh's scenes twice, on a CUDA mesh (NCCL) and on a CPU mesh (gloo) of
one process group, with the same seeded fracture uniforms, and writes
<scene>_r<RANK>_cuda.npz and _cpu.npz (tests/test_torch_cuda.py compares
them).
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np

BOX = 100.0
G8 = 8  # collision grid: 8 x layers, one a rank on the 1-D mesh of 8

SPATIAL_FIELDS = ("pos", "vel", "acc", "mass", "mat", "temp", "uid", "partner_uid", "contact_t")
COUNTERS = ("n_merges", "n_fractures", "n_bounces", "n_overflow", "n_dropped", "cell_too_small",
            "n_mig_wait", "n_halo_over", "in_transit")


def _cloud(n=512, seed=9, lo=20.0, hi=60.0, vsig=2.0):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    vel = rng.normal(0, vsig, (n, 3)).astype(np.float32)
    mass = rng.uniform(2.0, 8.0, n).astype(np.float32)
    return pos, vel, mass


def _stream(n, seed, lo, hi, v):
    """Tiny contact-free bodies streaming at velocity v (the migration
    scenes): x in [lo[0], hi[0]), and so on."""
    rng = np.random.default_rng(seed)
    pos = np.stack([rng.uniform(lo[c], hi[c], n) for c in range(3)], axis=1).astype(np.float32)
    vel = np.zeros((n, 3), np.float32)
    vel[:] = v
    return pos, vel, np.full(n, 0.01, np.float32)


def _pair(p0, p1, v0, v1, m=(5.0, 4.0)):
    return (np.asarray([p0, p1], np.float32), np.asarray([v0, v1], np.float32), np.asarray(m, np.float32))


def scene_arrays(name: str):
    """(pos, vel, mass) of a scene, numpy float32."""
    sc = SCENES[name]
    if name.startswith("distribution"):
        pos, vel, mass = _cloud()
        if name == "distribution":
            mass[-10:] = 0.0  # dead input rows are dropped, not distributed
        return pos, vel, mass
    if name in ("parity", "parity_2d", "bucketed"):
        return _cloud(n=512, seed=9)
    if name == "migration":
        return _stream(64, 3, (5.0, 10.0, 10.0), (20.0, 90.0, 90.0), (6.0, 0.0, 0.0))
    if name == "diagonal":
        return _stream(32, 6, (5.0, 5.0, 10.0), (20.0, 15.0, 90.0), (6.0, 6.0, 0.0))
    if name == "merge":
        return _pair([12.0, 50.0, 50.0], [13.0, 50.0, 50.0], [0.2, 0.0, 0.0], [-0.2, 0.0, 0.0])
    if name == "fracture":
        return _pair([11.2, 50.0, 50.0], [13.8, 50.0, 50.0], [40.0, 0.0, 0.0], [-40.0, 0.0, 0.0])
    if name == "merge_2d":
        return _pair([49.4, 24.4, 50.0], [50.6, 25.6, 50.0], [0.2, 0.2, 0.0], [-0.2, -0.2, 0.0])
    if name == "fracture_2d":
        return _pair([48.8, 23.8, 50.0], [51.2, 26.2, 50.0], [30.0, 30.0, 0.0], [-30.0, -30.0, 0.0])
    if name == "no_self_clones":
        return _pair([1.0, 50.0, 50.0], [2.0, 50.0, 50.0], [0.2, 0.0, 0.0], [-0.2, 0.0, 0.0])
    if name == "caps":
        pos, vel, mass = _cloud(n=256, seed=5)
        vel[:, 0] += 8.0  # everyone marches +x across slab boundaries
        return pos, vel, mass
    if name == "bucketed_2d":
        return _cloud(n=256, seed=4)
    return _cloud(**sc["cloud"])


_MERGE_RICH = dict(merge_time=0.005, fracture_threshold=1e9)
_MERGE = dict(merge_time=0.01, fracture_threshold=1e9)
_FRACTURE = dict(merge_time=1e9, fracture_threshold=0.5, min_fragment_mass=0.2)
_QUIET = dict(merge_time=1e9, fracture_threshold=1e9)

# name -> the scene's mesh kind, steps, step size, key, SimConfig fields
# (fat: materials at a tenth of the default densities), layout and caps, as
# tests/test_spatial.py runs them
SCENES = {
    "distribution": dict(kind="1d", steps=0),
    "parity": dict(kind="1d", steps=4, h=0.016, key=7, cfg=dict(_MERGE_RICH, fat=True), band=2,
                   caps=(96, 160), halo=192, mig=128),
    "migration": dict(kind="1d", steps=8, h=1.0, key=0, cfg={}, band=2, caps=(64, 96), halo=64, mig=64, nl=64),
    "merge": dict(kind="1d", steps=6, h=0.016, key=1, cfg=dict(_MERGE, fat=True), band=2, caps=(16, 32),
                  halo=8, mig=8, nl=8),
    "fracture": dict(kind="1d", steps=4, h=0.016, key=2, cfg=dict(_FRACTURE, fat=True), band=2, caps=(16, 32),
                     halo=8, mig=8, nl=32),
    "caps": dict(kind="1d", steps=3, h=1.0, key=4, cfg=dict(_QUIET, fat=True), band=2, caps=(96, 160), halo=2,
                 mig=2),
    "pm": dict(kind="1d", steps=3, h=0.008, key=0, cfg=dict(_QUIET, G=2.0), band=2, caps=(96, 160), halo=128,
               mig=64, force="pm", pm_grid=32, acc0=True, cloud=dict(n=512, seed=13, vsig=0.5)),
    "bucketed": dict(kind="1d", steps=3, h=0.016, key=7, cfg=dict(_MERGE_RICH, fat=True), band=2, caps=(8, 8),
                     halo=192, mig=128, buckets=0.6),
    "p3m": dict(kind="1d", steps=1, h=0.0, key=0, cfg=_QUIET, band=2, caps=(96, 160), halo=192, mig=128,
                force="p3m", pm_grid=32, cloud=dict(n=384, seed=3)),
    "no_self_clones": dict(kind="d1", steps=6, h=0.016, key=1, cfg=dict(_MERGE, fat=True), band=2,
                           caps=(16, 32), halo=8, mig=8, nl=8),
    "distribution_2d": dict(kind="2d", steps=0),
    "parity_2d": dict(kind="2d", steps=4, h=0.016, key=7, cfg=dict(_MERGE_RICH, fat=True), band=2,
                      caps=(96, 160), halo=256, mig=128),
    "diagonal": dict(kind="2d", steps=8, h=1.0, key=0, cfg={}, band=2, caps=(64, 96), halo=64, mig=64, nl=64),
    "merge_2d": dict(kind="2d", steps=6, h=0.016, key=1, cfg=dict(_MERGE, fat=True), band=2, caps=(16, 32),
                     halo=8, mig=8, nl=8),
    "fracture_2d": dict(kind="2d", steps=4, h=0.016, key=2, cfg=dict(_FRACTURE, fat=True), band=2,
                        caps=(16, 32), halo=8, mig=8, nl=32),
    "bucketed_2d": dict(kind="2d", steps=3, h=0.016, key=3, cfg=dict(_MERGE, fat=True), band=2, caps=(8, 8),
                        halo=192, mig=64, buckets=0.7),
    "pm_2d": dict(kind="2d", steps=2, h=0.008, key=0, cfg=dict(_QUIET, G=2.0), band=2, caps=(96, 160), halo=128,
                  mig=64, force="pm", pm_grid=32, acc0=True, cloud=dict(n=256, seed=15, vsig=0.5)),
    "p3m_2d": dict(kind="2d", steps=1, h=0.0, key=0, cfg=_QUIET, band=2, caps=(96, 160), halo=192, mig=128,
                   force="p3m", pm_grid=32, cloud=dict(n=256, seed=5)),
}

KINDS = {"1d": (8, ("b",)), "2d": (8, ("bx", "by")), "d1": (1, ("b",))}
# kind -> (world, mesh axes, the kind whose scenes it runs): one rank a card
NCCL_KINDS = {"nccl_1d2": (2, ("b",), "1d"), "nccl_1d4": (4, ("b",), "1d"), "nccl_2x2": (4, ("bx", "by"), "2d")}


def scenes_of(kind: str) -> list:
    return [name for name, sc in SCENES.items() if sc["kind"] == kind]


def fractures_on(name: str) -> bool:
    """Whether a scene's config lets fractures fire (then the test rebuilds
    the JAX step's per-rank fracture uniforms for it)."""
    sc = SCENES[name]
    return sc["steps"] > 0 and sc["cfg"].get("fracture_threshold", 25.0) < 1e9


def draws_key(name: str, step: int, rank: int) -> str:
    return f"{name}/{step}/{rank}"


def port_config(name: str):
    from nbx_torch.config import Materials, SimConfig, default_materials

    fields = dict(SCENES[name]["cfg"])
    dm = default_materials()
    mats = Materials(dm.density * 0.1, dm.color1, dm.color2) if fields.pop("fat", False) else dm
    return SimConfig(materials=mats, **fields)


def _rows(st, i: int) -> dict:
    """The rank's slots and uid_next after step i, keyed i/field."""
    from nbx_torch.convert import spatial_state_to_arrays

    return {f"{i}/{k}": v for k, v in spatial_state_to_arrays(st).items()}


def _run_scene(name: str, mesh, rank: int, draws) -> dict:
    import torch

    from nbx_torch.collisions import Draws
    from nbx_torch.ops.pm import pm_acceleration
    from nbx_torch.parallel import spatial

    sc = SCENES[name]
    pos, vel, mass = scene_arrays(name)
    st = spatial.spatial_state_for(mesh, pos, vel, mass, BOX, G8, nl=sc.get("nl"))
    out = _rows(st, 0)
    if sc["steps"] == 0:
        return out
    cfg = port_config(name)
    buckets = None
    if "buckets" in sc:
        buckets = spatial.spatial_buckets_for(mesh, pos, BOX, G8, sc["band"], split_quantile=sc["buckets"])
        out["buckets"] = np.asarray(buckets)
    step = spatial.make_spatial_granular_step(mesh, cfg, BOX, G8, sc["band"], sc["caps"], halo_cap=sc["halo"],
                                              mig_cap=sc["mig"], force_impl=sc.get("force", "zero"),
                                              pm_grid=sc.get("pm_grid", 128), buckets=buckets)
    if sc.get("acc0"):
        # the scan's first half-kick uses acc0 = force(pos0): the live rows'
        a0 = pm_acceleration(torch.from_numpy(pos), torch.from_numpy(mass), cfg.G, BOX, g=sc["pm_grid"],
                             isolated=True).to(st.acc.device)
        acc = torch.zeros_like(st.acc)
        live = st.uid >= 0
        acc[live] = a0[st.uid[live].long()]
        st = st.replace(acc=acc)
    for i in range(sc["steps"]):
        d = None
        if draws is not None and f"{draws_key(name, i, rank)}/u0" in draws:
            key = draws_key(name, i, rank)
            d = Draws(*(torch.from_numpy(draws[f"{key}/{f}"]).to(st.pos.device)
                        for f in ("u0", "u_mass", "u_dir", "u_off", "u_speed")))
        st, c = step(st, sc["h"], d)
        out.update(_rows(st, i + 1))
        out.update({f"{i + 1}/c/{k}": np.asarray(c[k].cpu().numpy()) for k in COUNTERS})
    return out


def _bad_config(mesh) -> dict:
    """The errors of tests/test_spatial.py's bad-config test."""
    from nbx_torch.config import SimConfig
    from nbx_torch.parallel import spatial

    got = {}
    for what, kw in (("divide", dict(n_cells=12)), ("all-gather", dict(force_impl="pallas"))):
        args = dict(n_cells=G8, force_impl="pm")
        args.update(kw)
        try:
            spatial.make_spatial_granular_step(mesh, SimConfig(), BOX, args["n_cells"], 2, (16, 32), halo_cap=8,
                                               mig_cap=8, force_impl=args["force_impl"])
            got[what] = "no error"
        except ValueError as e:
            got[what] = str(e)
    return {f"msg/{k}": np.asarray(v) for k, v in got.items()}


def main(kind: str, rank: int, world: int, port: int, outdir: str) -> None:
    import torch
    import torch.distributed as dist

    from nbx_torch.parallel import shard

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=world)
    try:
        mesh = shard.make_mesh(world, KINDS[kind][1], device_type="cpu")
        path = os.path.join(outdir, "draws.npz")
        draws = dict(np.load(path)) if os.path.exists(path) else None
        os.makedirs(os.path.join(outdir, kind), exist_ok=True)
        for name in scenes_of(kind):
            np.savez(os.path.join(outdir, kind, f"{name}_r{rank}.npz"), **_run_scene(name, mesh, rank, draws))
        if kind == "1d":
            np.savez(os.path.join(outdir, kind, f"bad_config_r{rank}.npz"), **_bad_config(mesh))
    finally:
        dist.destroy_process_group()


def _seeded_draws(names, rank: int) -> dict:
    """Fracture uniforms for every step of the scenes that fracture, from
    generators seeded by (step, rank), keyed as draws.npz is."""
    import torch

    from nbx_torch.collisions import draw_fracture_uniforms

    out = {}
    for name in names:
        if fractures_on(name):
            for i in range(SCENES[name]["steps"]):
                gen = torch.Generator().manual_seed(1000 * i + rank)
                d = draw_fracture_uniforms(port_config(name), gen, "cpu")
                out.update({f"{draws_key(name, i, rank)}/{f.name}": getattr(d, f.name).numpy()
                            for f in dataclasses.fields(d)})
    return out


def main_nccl(kind: str, rank: int, world: int, port: int, outdir: str) -> None:
    import torch
    import torch.distributed as dist

    from nbx_torch.parallel import shard

    torch.set_num_threads(1)
    torch.cuda.set_device(rank)
    dist.init_process_group("cpu:gloo,cuda:nccl", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    try:
        _, axes, scene_kind = NCCL_KINDS[kind]
        meshes = {dt: shard.make_mesh(world, axes, device_type=dt) for dt in ("cuda", "cpu")}
        names = scenes_of(scene_kind)
        draws = _seeded_draws(names, rank)
        os.makedirs(os.path.join(outdir, kind), exist_ok=True)
        for name in names:
            for dt, mesh in meshes.items():
                np.savez(os.path.join(outdir, kind, f"{name}_r{rank}_{dt}.npz"),
                         **_run_scene(name, mesh, rank, draws))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    run = main_nccl if sys.argv[1] in NCCL_KINDS else main
    run(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
