"""The scenes of tests/test_shard.py, and the rank body that runs them through
the port's all-gather paths (`nbx_torch.parallel.shard`) on a gloo process
group, for tests/test_torch_shard.py.

    python tests/torch_shard_ranks.py KIND RANK WORLD PORT OUTDIR

runs every scene of KIND ("d8": a world of 8 ranks with a 1-D mesh of 8 and
a 2x4 mesh; "d1": one rank, the 1-D and the 1x1 mesh) as rank RANK of WORLD,
meeting the other ranks at tcp://127.0.0.1:PORT, and writes
OUTDIR/KIND/<scene>_r<RANK>.npz: the rank's rows of the state after placement
(step 0) and after each step, each step's counters, and what else the scene
computes (energies, the binned pass's outputs, error messages). Fracture
uniforms come from OUTDIR/draws.npz (the JAX steps' streams, rebuilt by the
test). This file imports no jax; tests/torch_shard_jax_worker.py runs the
same scenes through the JAX package.

With a KIND of NCCL_KINDS (one rank a card: "nccl_d2", a 1-D mesh of 2 whose
ring neighbours are one peer; "nccl_d4", a 1-D mesh of 4 and a 2x2 mesh)
each rank runs the scenes twice, on a CUDA mesh (NCCL) and on a CPU mesh
(gloo) of one process group, with the same fracture uniforms, and writes
<scene>_r<RANK>_cuda.npz and _cpu.npz (tests/test_torch_cuda.py compares
them).
"""

from __future__ import annotations

import os
import sys

import numpy as np

G, EPS = 0.5, 0.5
BOX = 100.0
BODY_FIELDS = ("pos", "vel", "acc", "mass", "mat", "temp", "partner", "contact_t")
GRAVITY_FIELDS = ("pos", "vel", "acc", "mass")
PHYSICS_COUNTERS = ("n_merges", "n_bounces", "n_fractures", "n_dropped")
GRANULAR_COUNTERS = ("n_merges", "n_fractures", "n_bounces", "n_overflow", "n_dropped", "cell_too_small")
PASS_KEYS = ("dvel", "dpos", "dtemp", "j", "vn", "q", "energy", "m_j", "approaching", "n_bounces", "n_overflow",
             "cell_too_small")

# name -> what the scene runs, as tests/test_shard.py runs it:
#   gravity: the 1-D step ("1d"), the ring, the 2-D step ("2d") on _setup(n, seed), `steps` steps of h
#   energy / drift: sharded_energy, run_sharded(n_steps, diag_every)
#   physics: the dense full-physics step on a 16-body pair scene, key per step
#   binned: the column-slab pass; granular: the granular step, force "zero" or "jnp"
#   bad: the errors of the bad splits and the indivisible N
SCENES = {
    "single": dict(kind="gravity", n=512, seed=0, steps=5, h=0.01, steps_of=("1d",)),
    "mesh2d": dict(kind="gravity", n=512, seed=1, steps=3, h=0.01, steps_of=("1d", "2d")),
    "ring": dict(kind="gravity", n=256, seed=5, steps=3, h=0.01, steps_of=("1d", "ring")),
    "energy": dict(kind="energy", n=256, seed=2),
    "drift": dict(kind="drift", n=512, seed=3, steps=50, diag_every=25, h=0.005),
    "bounce": dict(kind="physics", steps=1, h=0.008, key=0, until_merge=False),
    "merge": dict(kind="physics", steps=40, h=0.016, key=0, until_merge=True),
    "fracture": dict(kind="physics", steps=1, h=0.016, key=3, until_merge=False),
    "fracture_scaled": dict(kind="physics", steps=1, h=0.016, key=3, until_merge=False),
    "binned": dict(kind="binned", g=4, band=2, caps=(256, 384)),
    "granular_zero": dict(kind="granular", force="zero", seed=9, steps=4, h=0.016, key=7),
    "granular_jnp": dict(kind="granular", force="jnp", seed=11, steps=3, h=0.008, key=3),
    "bad": dict(kind="bad"),
}
PHYSICS_CFG = {
    "bounce": dict(G=0.0, merge_time=1e9, fracture_threshold=1e9),
    "merge": dict(G=0.5, merge_time=0.05, fracture_threshold=1e9),
    "fracture": dict(G=0.0, merge_time=1e9, fracture_threshold=0.5, min_fragment_mass=0.2),
    "fracture_scaled": dict(G=0.0, merge_time=1e9, fracture_threshold=0.5, min_fragment_mass=0.2),
}
GRANULAR_LAYOUT = (BOX, 4, 2, (256, 384))  # box, g, band, caps of tests/test_shard.py's granular scenes
# the worlds of the gloo kinds, and the NCCL kinds: (world, the meshes' device counts)
KINDS = {"d8": 8, "d1": 1}
NCCL_KINDS = {"nccl_d2": 2, "nccl_d4": 4}


def plummer_setup(plummer, n: int, seed: int):
    """tests/test_shard.py's _setup through a package's scene.plummer."""
    sc = plummer(n=n, total_mass=float(n), scale_radius=10.0, G=G, seed=seed)
    return (np.asarray(sc["pos"], np.float32), np.asarray(sc["vel"], np.float32),
            np.asarray(sc["mass"], np.float32))


def physics_arrays(name: str):
    """The 16-body scenes of tests/test_shard.py's physics tests: one pair,
    bodies 0 and 15 (on the first and the last of 8 shards), everyone else
    parked far apart with mass 0."""
    n = 16
    far = 80.0 if name == "fracture_scaled" else 500.0
    pos = np.full((n, 3), far, np.float32)
    if name != "fracture_scaled":
        pos += np.arange(n)[:, None] * 50.0
    vel = np.zeros((n, 3), np.float32)
    mass = np.zeros(n, np.float32)
    if name == "bounce":
        pos[0], pos[15] = [0.0, 0.0, 0.0], [1.0, 0.0, 0.0]
        vel[0, 0], vel[15, 0] = 1.0, -1.0
        mass[0] = mass[15] = 8.0
    elif name == "merge":
        pos[0], pos[15] = [0.0, 0.0, 0.0], [1.1, 0.0, 0.0]
        mass[0] = mass[15] = 8.0
    elif name == "fracture":
        pos[0], pos[15] = [0.0, 0.0, 0.0], [1.2, 0.0, 0.0]
        vel[0, 0], vel[15, 0] = 4.0, -4.0
        mass[0] = mass[15] = 10.0
    else:
        pos[0], pos[15] = [30.0, 30, 30], [31.2, 30, 30]
        vel[0, 0], vel[15, 0] = 4.0, -4.0
        mass[0] = mass[15] = 10.0
    return pos, vel, mass


def binned_arrays():
    """tests/test_shard.py's binned scene: 1,024 bodies, the last 64 dead,
    radii twice the default rock's (density 1), computed here for both
    packages."""
    rng = np.random.default_rng(5)
    n = 1024
    pos = rng.uniform(10, 90, (n, 3)).astype(np.float32)
    vel = rng.normal(0, 1.5, (n, 3)).astype(np.float32)
    mass = rng.uniform(2.0, 8.0, n).astype(np.float32)
    mass[-64:] = 0.0
    radius = (np.cbrt(3.0 * mass / (4.0 * np.pi)) * 2.0).astype(np.float32)
    return pos, vel, mass, radius


def granular_arrays(seed: int, n: int = 512):
    """tests/test_shard.py's _granular_cloud_cfg arrays (its config: the fat
    materials, merge_time 0.005, fracture_threshold 0.5, min_fragment_mass
    0.2)."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(20.0, 60.0, (n, 3)).astype(np.float32)
    vel = rng.normal(0, 2.0, (n, 3)).astype(np.float32)
    mass = rng.uniform(2.0, 8.0, n).astype(np.float32)
    mass[-64:] = 0.0
    return pos, vel, mass


GRANULAR_CFG = dict(merge_time=0.005, fracture_threshold=0.5, min_fragment_mass=0.2)


def draws_key(name: str, step: int) -> str:
    return f"{name}/{step}"


# ---- the port's side -----------------------------------------------------------------

def port_config(name: str):
    from nbx_torch.config import Materials, SimConfig, default_materials

    if name in PHYSICS_CFG:
        return SimConfig(**PHYSICS_CFG[name])
    dm = default_materials()
    return SimConfig(materials=Materials(dm.density * 0.1, dm.color1, dm.color2), **GRANULAR_CFG)


def _draws(draws: dict, name: str, step: int, dev):
    import torch

    from nbx_torch.collisions import Draws

    key = draws_key(name, step)
    if f"{key}/u0" not in draws:
        return None
    return Draws(*(torch.from_numpy(draws[f"{key}/{f}"]).to(dev) for f in ("u0", "u_mass", "u_dir", "u_off",
                                                                           "u_speed")))


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def _state_rows(st, fields, i: int) -> dict:
    return {f"{i}/{f}": _np(getattr(st, f)) for f in fields}


def run_gravity(name: str, meshes: dict) -> dict:
    from nbx_torch import scene
    from nbx_torch.parallel import shard

    sc = SCENES[name]
    pos, vel, mass = plummer_setup(scene.plummer, sc["n"], sc["seed"])
    out = {}
    for path in sc["steps_of"]:
        mesh = meshes["2d" if path == "2d" else "1d"]
        place = shard.shard_state2d if path == "2d" else shard.shard_state
        make = {"1d": shard.make_sharded_step, "2d": shard.make_sharded_step_2d,
                "ring": shard.make_sharded_step_ring}[path]
        st = place(mesh, pos, vel, mass)
        step = make(mesh, impl="jnp")
        out.update({f"{path}/{k}": v for k, v in _state_rows(st, GRAVITY_FIELDS, 0).items()})
        for i in range(sc["steps"]):
            st = step(st, G, EPS, sc["h"])
            out.update({f"{path}/{k}": v for k, v in _state_rows(st, GRAVITY_FIELDS, i + 1).items()})
    return out


def run_energy(name: str, meshes: dict) -> dict:
    from nbx_torch import scene
    from nbx_torch.parallel import shard

    sc = SCENES[name]
    mesh = meshes["1d"]
    st = shard.shard_state(mesh, *plummer_setup(scene.plummer, sc["n"], sc["seed"]))
    ke, pe = shard.sharded_energy(mesh, st, G, EPS, impl="jnp")
    out = {"ke0": _np(ke), "pe0": _np(pe)}
    if name == "drift":
        step = shard.make_sharded_step(mesh, impl="jnp")
        st, energies = shard.run_sharded(st, step, G, EPS, sc["h"], n_steps=sc["steps"],
                                         diag_every=sc["diag_every"], mesh=mesh, impl="jnp")
        ke, pe = shard.sharded_energy(mesh, st, G, EPS, impl="jnp")
        out.update({"energies": _np(energies), "ke1": _np(ke), "pe1": _np(pe)})
        out.update(_state_rows(st, GRAVITY_FIELDS, sc["steps"]))
    return out


def run_physics(name: str, meshes: dict, draws: dict) -> dict:
    from nbx_torch.parallel import shard

    sc = SCENES[name]
    mesh = meshes["1d"]
    st = shard.shard_body_state(mesh, *physics_arrays(name))
    step = shard.make_sharded_physics_step(mesh, port_config(name), impl="jnp")
    out = _state_rows(st, BODY_FIELDS, 0)
    for i in range(sc["steps"]):
        st, c = step(st, sc["h"], _draws(draws, name, 0, st.pos.device))  # the same key every step
        out.update(_state_rows(st, BODY_FIELDS, i + 1))
        out.update({f"{i + 1}/c/{k}": _np(c[k]) for k in PHYSICS_COUNTERS})
        if sc["until_merge"] and int(c["n_merges"]):
            break
    out["steps"] = np.asarray(i + 1)
    return out


def run_binned(name: str, meshes: dict) -> dict:
    import torch

    from nbx_torch.parallel import shard

    sc = SCENES[name]
    mesh = meshes["1d"]
    pos, vel, mass, radius = binned_arrays()
    put = shard._placer(mesh, len(pos))
    run = shard.make_sharded_binned_collision_pass(mesh, BOX, sc["g"], sc["band"], sc["caps"])
    dvel, dpos, dtemp, best, nb, novf, small = run(put(pos), put(vel), put(mass), put(radius))
    out = {"dvel": dvel, "dpos": dpos, "dtemp": dtemp, "n_bounces": nb, "n_overflow": novf, "cell_too_small": small}
    out.update(best)
    return {k: _np(v) if isinstance(v, torch.Tensor) else v for k, v in out.items()}


def run_granular(name: str, meshes: dict, draws: dict) -> dict:
    import torch

    from nbx_torch.parallel import shard

    sc = SCENES[name]
    mesh = meshes["1d"]
    box, g, band, caps = GRANULAR_LAYOUT
    pos, vel, mass = granular_arrays(sc["seed"])
    cfg = port_config(name)
    st = shard.shard_body_state(mesh, pos, vel, mass)
    if sc["force"] == "jnp":
        # prime acc with the initial force, as the JAX test primes it
        from nbx_torch.forces import accelerations

        acc0 = accelerations(torch.from_numpy(pos), torch.from_numpy(mass), cfg.G, cfg.softening)
        st = st._replace(acc=shard._placer(mesh, len(pos))(acc0))
    step = shard.make_sharded_granular_step(mesh, cfg, box, g, band, caps, force_impl=sc["force"])
    out = _state_rows(st, BODY_FIELDS, 0)
    for i in range(sc["steps"]):
        st, c = step(st, sc["h"], _draws(draws, name, i, st.pos.device))
        out.update(_state_rows(st, BODY_FIELDS, i + 1))
        out.update({f"{i + 1}/c/{k}": _np(c[k]) for k in GRANULAR_COUNTERS})
    return out


def run_bad(name: str, meshes: dict) -> dict:
    """The errors of the bad splits (g = 3: 9 columns over the mesh) and of
    the indivisible N (500 bodies)."""
    from nbx_torch.config import SimConfig
    from nbx_torch.parallel import shard

    mesh = meshes["1d"]
    tries = {
        "binned": lambda: shard.make_sharded_binned_collision_pass(mesh, BOX, 3, 2, (64, 96)),
        "granular": lambda: shard.make_sharded_granular_step(mesh, SimConfig(), BOX, 3, 2, (64, 96)),
        "indivisible": lambda: shard.shard_state(mesh, *(np.zeros((500, 3), np.float32),) * 2,
                                                 np.zeros(500, np.float32)),
    }
    out = {}
    for what, fn in tries.items():
        try:
            fn()
            out[f"msg/{what}"] = np.asarray("no error")
        except ValueError as e:
            out[f"msg/{what}"] = np.asarray(str(e))
    return out


def run_scene(name: str, meshes: dict, draws: dict) -> dict:
    kind = SCENES[name]["kind"]
    if kind == "gravity":
        return run_gravity(name, meshes)
    if kind in ("energy", "drift"):
        return run_energy(name, meshes)
    if kind == "physics":
        return run_physics(name, meshes, draws)
    if kind == "binned":
        return run_binned(name, meshes)
    if kind == "granular":
        return run_granular(name, meshes, draws)
    return run_bad(name, meshes)


def _meshes(world: int, device_type: str) -> dict:
    from nbx_torch.parallel import shard

    return {"1d": shard.make_mesh(world, ("b",), device_type=device_type),
            "2d": shard.make_mesh(world, ("b", "j"), device_type=device_type)}


def main(kind: str, rank: int, world: int, port: int, outdir: str) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=world)
    try:
        meshes = _meshes(world, "cpu")
        draws = dict(np.load(os.path.join(outdir, "draws.npz")))
        os.makedirs(os.path.join(outdir, kind), exist_ok=True)
        for name in SCENES:
            np.savez(os.path.join(outdir, kind, f"{name}_r{rank}.npz"), **run_scene(name, meshes, draws))
    finally:
        dist.destroy_process_group()


def seeded_draws(cfgs: dict) -> dict:
    """Fracture uniforms for every step of the scenes that fracture, from a
    generator seeded by (scene, step), keyed as draws.npz is: the same on
    every rank."""
    import dataclasses

    import torch

    from nbx_torch.collisions import draw_fracture_uniforms

    out = {}
    for s, (name, cfg) in enumerate(cfgs.items()):
        for i in range(SCENES[name]["steps"]):
            d = draw_fracture_uniforms(cfg, torch.Generator().manual_seed(1000 * s + i), "cpu")
            out.update({f"{draws_key(name, i)}/{f.name}": getattr(d, f.name).numpy() for f in dataclasses.fields(d)})
    return out


def main_nccl(kind: str, rank: int, world: int, port: int, outdir: str) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    torch.cuda.set_device(rank)
    dist.init_process_group("cpu:gloo,cuda:nccl", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    try:
        meshes = {dt: _meshes(world, dt) for dt in ("cuda", "cpu")}
        fracturing = ("fracture", "fracture_scaled", "granular_zero", "granular_jnp")
        draws = seeded_draws({name: port_config(name) for name in fracturing})
        os.makedirs(os.path.join(outdir, kind), exist_ok=True)
        for name in SCENES:
            for dt, ms in meshes.items():
                np.savez(os.path.join(outdir, kind, f"{name}_r{rank}_{dt}.npz"), **run_scene(name, ms, draws))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    run = main_nccl if sys.argv[1] in NCCL_KINDS else main
    run(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
