"""Runs the scenes of tests/torch_spatial_ranks.py through the JAX package's
spatial step (`nbx.parallel.spatial`, the Pallas kernels in interpret mode)
on a virtual CPU mesh, for tests/test_torch_spatial.py.

    env JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        python tests/torch_spatial_jax_worker.py KIND OUTDIR

KIND "1d" runs the 1-D mesh's scenes and the one-device scene ("d1"); "2d"
the 2x4 mesh's. Writes OUTDIR/<kind>/<scene>_jax.npz: the global [D nl]
slots after spatial_state_for (step 0) and after each step, each step's
counters, the buckets of spatial_buckets_for, and for the P3M scenes
`p3m_acceleration`'s force on the scene (the JAX test's reference).
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_spatial_ranks import BOX, COUNTERS, G8, SCENES, SPATIAL_FIELDS, scene_arrays  # noqa: E402


def jax_config(name: str):
    from nbx.config import Materials, SimConfig, default_materials

    fields = dict(SCENES[name]["cfg"])
    dm = default_materials()
    mats = (Materials(density=dm.density * 0.1, color1=dm.color1, color2=dm.color2)
            if fields.pop("fat", False) else dm)
    return SimConfig(materials=mats, **fields)


def run_scene(name: str, mesh) -> dict:
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from nbx.parallel import spatial

    sc = SCENES[name]
    pos, vel, mass = scene_arrays(name)
    st = spatial.spatial_state_for(mesh, pos, vel, mass, BOX, G8, nl=sc.get("nl"))

    def rows(st, i):
        out = {f"{i}/{f}": np.asarray(getattr(st, f)) for f in SPATIAL_FIELDS}
        out[f"{i}/uid_next"] = np.asarray(st.uid_next)
        return out

    out = rows(st, 0)
    if sc["steps"] == 0:
        return out
    cfg = jax_config(name)
    buckets = None
    if "buckets" in sc:
        buckets = spatial.spatial_buckets_for(mesh, pos, BOX, G8, sc["band"], split_quantile=sc["buckets"])
        out["buckets"] = np.asarray(buckets)
    force = sc.get("force", "zero")
    step = spatial.make_spatial_granular_step(
        mesh, cfg, BOX, G8, sc["band"], sc["caps"], halo_cap=sc["halo"], mig_cap=sc["mig"], force_impl=force,
        pm_grid=sc.get("pm_grid", 128), interpret=True, buckets=buckets,
    )
    if sc.get("acc0"):
        from nbx.ops.pm import pm_acceleration

        uid = np.asarray(st.uid)
        acc0 = np.zeros((uid.shape[0], 3), np.float32)
        live = uid >= 0
        a0 = np.asarray(pm_acceleration(jnp.asarray(pos), jnp.asarray(mass), cfg.G, BOX, g=sc["pm_grid"],
                                        isolated=True))
        acc0[live] = a0[uid[live]]
        row = tuple(mesh.axis_names) if len(mesh.axis_names) == 2 else mesh.axis_names[0]
        st = st._replace(acc=jax.device_put(jnp.asarray(acc0), NamedSharding(mesh, P(row, None))))
    key = jax.random.PRNGKey(sc["key"])
    for i in range(sc["steps"]):
        st, c = step(st, sc["h"], jax.random.fold_in(key, i))
        out.update(rows(st, i + 1))
        out.update({f"{i + 1}/c/{k}": np.asarray(c[k]) for k in COUNTERS})
    if force == "p3m":
        from nbx.ops.p3m import p3m_acceleration

        acc_ref, unc = p3m_acceleration(jnp.asarray(pos), jnp.asarray(mass), cfg.G, BOX, g=sc["pm_grid"],
                                        n_cells=G8, max_per_cell=256, eps=cfg.softening, max_residual=256,
                                        pp_impl="xla")
        out["p3m_acc"] = np.asarray(acc_ref)
        out["p3m_unc"] = np.asarray(unc)
    return out


def main(kind: str, outdir: str) -> None:
    import jax

    from nbx.parallel import shard

    assert len(jax.devices()) >= 8, jax.devices()
    meshes = {"1d": shard.make_mesh(8), "d1": shard.make_mesh(1)} if kind == "1d" else {
        "2d": shard.make_mesh(8, axes=("bx", "by"))}
    for k, mesh in meshes.items():
        os.makedirs(os.path.join(outdir, k), exist_ok=True)
        for name, sc in SCENES.items():
            if sc["kind"] == k:
                np.savez(os.path.join(outdir, k, f"{name}_jax.npz"), **run_scene(name, mesh))
    print("JAX WORKER OK", kind, flush=True)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
