"""Runs the scenes of tests/torch_shard_ranks.py through the JAX package's
all-gather paths (`nbx.parallel.shard`, impl "jnp", the Pallas kernels in
interpret mode) on a virtual CPU mesh, for tests/test_torch_shard.py.

    env JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        python tests/torch_shard_jax_worker.py KIND OUTDIR

KIND "d8" runs them on a 1-D mesh of 8 devices (and a 2x4 mesh for the 2-D
step), "d1" on one device. Writes OUTDIR/<kind>/<scene>_jax.npz: the global
state after placement (step 0) and after each step, each step's counters,
and what else the scene computes, keyed as the port's ranks key theirs.
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_shard_ranks import (BODY_FIELDS, EPS, GRANULAR_CFG, GRANULAR_COUNTERS, GRANULAR_LAYOUT,  # noqa: E402
                               GRAVITY_FIELDS, PHYSICS_CFG, PHYSICS_COUNTERS, SCENES, G, binned_arrays,
                               granular_arrays, physics_arrays, plummer_setup)


def jax_config(name: str):
    from nbx.config import Materials, SimConfig, default_materials

    if name in PHYSICS_CFG:
        return SimConfig(**PHYSICS_CFG[name])
    dm = default_materials()
    return SimConfig(materials=Materials(density=dm.density * 0.1, color1=dm.color1, color2=dm.color2),
                     **GRANULAR_CFG)


def _rows(st, fields, i: int) -> dict:
    return {f"{i}/{f}": np.asarray(getattr(st, f)) for f in fields}


def run_gravity(name: str, meshes: dict) -> dict:
    from nbx import scene
    from nbx.parallel import shard

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
        out.update({f"{path}/{k}": v for k, v in _rows(st, GRAVITY_FIELDS, 0).items()})
        for i in range(sc["steps"]):
            st = step(st, G, EPS, sc["h"])
            out.update({f"{path}/{k}": v for k, v in _rows(st, GRAVITY_FIELDS, i + 1).items()})
    return out


def run_energy(name: str, meshes: dict) -> dict:
    from nbx import scene
    from nbx.parallel import shard

    sc = SCENES[name]
    mesh = meshes["1d"]
    st = shard.shard_state(mesh, *plummer_setup(scene.plummer, sc["n"], sc["seed"]))
    ke, pe = shard.sharded_energy(mesh, st, G, EPS, impl="jnp")
    out = {"ke0": np.asarray(ke), "pe0": np.asarray(pe)}
    if name == "drift":
        step = shard.make_sharded_step(mesh, impl="jnp")
        st, energies = shard.run_sharded(st, step, G, EPS, sc["h"], n_steps=sc["steps"],
                                         diag_every=sc["diag_every"], mesh=mesh, impl="jnp")
        ke, pe = shard.sharded_energy(mesh, st, G, EPS, impl="jnp")
        out.update({"energies": np.asarray(energies), "ke1": np.asarray(ke), "pe1": np.asarray(pe)})
        out.update(_rows(st, GRAVITY_FIELDS, sc["steps"]))
    return out


def run_physics(name: str, meshes: dict) -> dict:
    import jax

    from nbx.parallel import shard

    sc = SCENES[name]
    mesh = meshes["1d"]
    st = shard.shard_body_state(mesh, *physics_arrays(name))
    step = shard.make_sharded_physics_step(mesh, jax_config(name), impl="jnp")
    out = _rows(st, BODY_FIELDS, 0)
    for i in range(sc["steps"]):
        st, c = step(st, sc["h"], jax.random.PRNGKey(sc["key"]))
        out.update(_rows(st, BODY_FIELDS, i + 1))
        out.update({f"{i + 1}/c/{k}": np.asarray(c[k]) for k in PHYSICS_COUNTERS})
        if sc["until_merge"] and int(c["n_merges"]):
            break
    out["steps"] = np.asarray(i + 1)
    return out


def run_binned(name: str, meshes: dict) -> dict:
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from nbx.parallel import shard

    sc = SCENES[name]
    mesh = meshes["1d"]
    pos, vel, mass, radius = binned_arrays()
    s3, s1 = NamedSharding(mesh, P("b", None)), NamedSharding(mesh, P("b"))
    run = shard.make_sharded_binned_collision_pass(mesh, 100.0, sc["g"], sc["band"], sc["caps"], interpret=True)
    dvel, dpos, dtemp, best, nb, novf, small = run(
        jax.device_put(jnp.asarray(pos), s3), jax.device_put(jnp.asarray(vel), s3),
        jax.device_put(jnp.asarray(mass), s1), jax.device_put(jnp.asarray(radius), s1))
    out = {"dvel": dvel, "dpos": dpos, "dtemp": dtemp, "n_bounces": nb, "n_overflow": novf, "cell_too_small": small}
    out.update(best)
    return {k: np.asarray(v) for k, v in out.items()}


def run_granular(name: str, meshes: dict) -> dict:
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from nbx.parallel import shard
    from nbx.sim import gravity

    sc = SCENES[name]
    mesh = meshes["1d"]
    box, g, band, caps = GRANULAR_LAYOUT
    pos, vel, mass = granular_arrays(sc["seed"])
    cfg = jax_config(name)
    st = shard.shard_body_state(mesh, pos, vel, mass)
    if sc["force"] == "jnp":
        acc0 = gravity(jnp.asarray(pos), jnp.asarray(mass), cfg.G, cfg.softening, "dense")
        st = st._replace(acc=jax.device_put(acc0, NamedSharding(mesh, P("b", None))))
    step = shard.make_sharded_granular_step(mesh, cfg, box, g, band, caps, force_impl=sc["force"], interpret=True)
    out = _rows(st, BODY_FIELDS, 0)
    key = jax.random.PRNGKey(sc["key"])
    for i in range(sc["steps"]):
        key, sub = jax.random.split(key)
        st, c = step(st, sc["h"], sub)
        out.update(_rows(st, BODY_FIELDS, i + 1))
        out.update({f"{i + 1}/c/{k}": np.asarray(c[k]) for k in GRANULAR_COUNTERS})
    return out


def run_bad(name: str, meshes: dict) -> dict:
    from nbx.config import SimConfig
    from nbx.parallel import shard

    mesh = meshes["1d"]
    tries = {
        "binned": lambda: shard.make_sharded_binned_collision_pass(mesh, 100.0, 3, 2, (64, 96)),
        "granular": lambda: shard.make_sharded_granular_step(mesh, SimConfig(), 100.0, 3, 2, (64, 96)),
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


RUNS = {"gravity": run_gravity, "energy": run_energy, "drift": run_energy, "binned": run_binned, "bad": run_bad}


def main(kind: str, outdir: str) -> None:
    import jax

    from nbx.parallel import shard

    d = 8 if kind == "d8" else 1
    assert len(jax.devices()) >= d, jax.devices()
    meshes = {"1d": shard.make_mesh(d), "2d": shard.make_mesh(d, axes=("b", "j"))}
    os.makedirs(os.path.join(outdir, kind), exist_ok=True)
    for name, sc in SCENES.items():
        if sc["kind"] == "physics":
            out = run_physics(name, meshes)
        elif sc["kind"] == "granular":
            out = run_granular(name, meshes)
        else:
            out = RUNS[sc["kind"]](name, meshes)
        np.savez(os.path.join(outdir, kind, f"{name}_jax.npz"), **out)
        print("JAX WORKER scene", kind, name, flush=True)
    print("JAX WORKER OK", kind, flush=True)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
