"""Checkpoint and resume (port of `nbx/checkpoint.py`).

The format is the JAX package's: one .npz holding the state's fields as
`state.<field>`, the config's as `cfg.<field>` (the materials table as
`cfg.materials.density`, `.color1`, `.color2`) and `format_version`. The
JAX package's `state.key` becomes `state.generator`: the torch.Generator's
state (`get_state()`, uint8), with `state.generator_device` naming the
device type it belongs to, so a resumed run draws the same fracture
uniforms and reproduces the original bit for bit.

`load_state` also reads a file the JAX package wrote: every array but
`state.key`, which torch cannot continue; the resumed state's generator is
then seeded with `seed`, so its fracture draws are fresh ones.

The JAX package's orbax checkpoints become directories of .npz files, one a
rank, with a JSON manifest (orbax imports jax, so the port cannot use it):

  save_state_orbax / load_state_orbax     ->  save_state_dir / load_state_dir
  save_sharded_orbax / load_sharded_orbax ->  save_sharded / load_sharded

`manifest.json` holds the format version, the state's kind, the global row
count N, the world size D, each field (dtype, shape of a row, whether it is
split over the ranks or replicated) and each rank's row range. A rank's file,
`rank<d>.npz`, holds its rows of each split field, the replicated fields and
its generator's state where the state has one. `load_sharded` re-shards on
read, as orbax does: a rank of a mesh of any D' that divides N reads its rows
[d N/D', (d + 1) N/D') from the files that hold them. A SpatialState is owned
by slabs, not by row ranges, so it restores onto a mesh of the same D only.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from nbx_torch.config import CUDA, Materials, SimConfig
from nbx_torch.convert import STATE_FIELDS
from nbx_torch.state import SimState, make_generator

FORMAT_VERSION = 1


def save_state(path: str, state: SimState, cfg: SimConfig | None = None) -> None:
    """Snapshot a SimState (and optionally its config) to .npz."""
    arrays = {f"state.{name}": getattr(state, name).cpu().numpy() for name in STATE_FIELDS}
    if state.contact is not None:
        arrays["state.contact"] = state.contact.cpu().numpy()
    arrays["state.generator"] = state.generator.get_state().numpy()
    arrays["state.generator_device"] = np.str_(state.generator.device.type)
    arrays["format_version"] = np.int32(FORMAT_VERSION)
    if cfg is not None:
        for f in dataclasses.fields(cfg):
            v = getattr(cfg, f.name)
            if isinstance(v, Materials):
                for name in ("density", "color1", "color2"):
                    arrays[f"cfg.materials.{name}"] = getattr(v, name).cpu().numpy()
            else:
                arrays[f"cfg.{f.name}"] = np.asarray(v)
    np.savez_compressed(path, **arrays)


def _generator(z, device, seed: int) -> torch.Generator:
    """The saved generator on `device`, or, for a file without one (the JAX
    package's), a new one seeded with `seed`."""
    gen = make_generator(device, seed)
    if "state.generator" not in z:
        return gen
    saved = str(z["state.generator_device"])
    if saved != gen.device.type:
        raise ValueError(f"the checkpoint's generator belongs to a {saved} device, not {gen.device.type}: "
                         f"load it onto a {saved} device")
    gen.set_state(torch.from_numpy(np.array(z["state.generator"])))
    return gen


def load_state(path: str, device=CUDA, seed: int = 0) -> tuple[SimState, SimConfig | None]:
    """Restore (state, cfg or None) onto `device` (the card unless the caller
    asks for the CPU). A file of this package resumes bit for bit, its
    generator included; a file of the JAX package loads every array but its
    PRNG key, and the generator is seeded with `seed`. A file of another
    format version raises ValueError."""
    z = np.load(path)
    version = int(z["format_version"])
    if version != FORMAT_VERSION:
        raise ValueError(f"checkpoint format {version} != {FORMAT_VERSION}")
    kw = {name: torch.as_tensor(np.array(z[f"state.{name}"]), dtype=dtype).to(device)
          for name, dtype in STATE_FIELDS.items()}
    contact = None
    if "state.contact" in z:
        contact = torch.as_tensor(np.array(z["state.contact"]), dtype=torch.float32).to(device)
    state = SimState(**kw, generator=_generator(z, device, seed), contact=contact)

    cfg = None
    if "cfg.G" in z:
        ckw = {}
        for f in dataclasses.fields(SimConfig):
            if f.name == "materials":
                ckw["materials"] = Materials(*(
                    torch.as_tensor(np.array(z[f"cfg.materials.{name}"]), dtype=torch.float32)
                    for name in ("density", "color1", "color2")))
            elif f"cfg.{f.name}" in z:
                ckw[f.name] = type(f.default)(z[f"cfg.{f.name}"].item())
        cfg = SimConfig(**ckw).to(device)
    return state, cfg


MANIFEST = "manifest.json"


def _write_manifest(dirpath: str, manifest: dict) -> None:
    tmp = os.path.join(dirpath, MANIFEST + ".tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1)
    os.replace(tmp, os.path.join(dirpath, MANIFEST))


def _read_manifest(dirpath: str, kinds) -> dict:
    with open(os.path.join(dirpath, MANIFEST)) as f:
        m = json.load(f)
    if m["format_version"] != FORMAT_VERSION:
        raise ValueError(f"checkpoint format {m['format_version']} != {FORMAT_VERSION}")
    if m["kind"] not in kinds:
        raise ValueError(f"{dirpath} holds a {m['kind']}, not one of {sorted(kinds)}")
    return m


def save_state_dir(dirpath: str, state: SimState, cfg: SimConfig | None = None) -> None:
    """Snapshot a SimState (and optionally its config) into a directory: the
    save_state file of a world of one, `rank0.npz`, and the manifest (the
    counterpart of the JAX package's save_state_orbax)."""
    os.makedirs(dirpath, exist_ok=True)
    save_state(os.path.join(dirpath, "rank0.npz"), state, cfg)
    fields = {name: {"dtype": str(getattr(state, name).dtype).replace("torch.", ""),
                     "row_shape": list(getattr(state, name).shape[1:]), "split": False}
              for name in STATE_FIELDS}
    _write_manifest(dirpath, dict(format_version=FORMAT_VERSION, kind="SimState", n=state.capacity, world_size=1,
                                  fields=fields, ranks=[[0, state.capacity]], config=cfg is not None))


def load_state_dir(dirpath: str, device=CUDA, seed: int = 0) -> tuple[SimState, SimConfig | None]:
    """Restore (state, cfg or None) from save_state_dir's directory onto
    `device`, bit for bit, the generator included."""
    _read_manifest(dirpath, {"SimState"})
    return load_state(os.path.join(dirpath, "rank0.npz"), device, seed)


def _sharded_kinds() -> dict:
    from nbx_torch.parallel.shard import ShardedBodyState, ShardedState
    from nbx_torch.parallel.spatial import SpatialState

    return {"ShardedState": ShardedState, "ShardedBodyState": ShardedBodyState, "SpatialState": SpatialState}


def _leaves(state) -> dict:
    if hasattr(state, "_asdict"):
        return dict(state._asdict())
    return {f.name: getattr(state, f.name) for f in dataclasses.fields(state)}


def _world(mesh) -> tuple[int, int]:
    """(this rank's shard index, the number of shards): its coordinate on the
    mesh (`parallel.shard`'s row-major shard), or 0 of 1 without one."""
    if mesh is None:
        return 0, 1
    from nbx_torch.parallel.shard import _shard_index

    return _shard_index(mesh), mesh.size()


def save_sharded(dirpath: str, state, mesh=None) -> None:
    """Checkpoint this rank's shard of a sharded state (parallel.shard's
    ShardedState or ShardedBodyState, parallel.spatial's SpatialState) on
    `mesh`: every rank of the mesh calls it and writes `rank<d>.npz`, d its
    shard index; rank 0 then writes the manifest, and every rank returns
    once it is written. No rank holds another's rows (the counterpart of the
    JAX package's save_sharded_orbax)."""
    import torch.distributed as dist

    kinds = _sharded_kinds()
    kind = type(state).__name__
    if kind not in kinds:
        raise ValueError(f"save_sharded takes one of {sorted(kinds)}, not {kind}")
    me, d = _world(mesh)
    leaves = _leaves(state)
    nl = leaves["mass"].shape[0]
    arrays, fields = {}, {}
    for name, v in leaves.items():
        if isinstance(v, torch.Generator):
            arrays["state.generator"] = v.get_state().numpy()
            arrays["state.generator_device"] = np.str_(v.device.type)
            continue
        split = v.dim() > 0
        if split and v.shape[0] != nl:
            raise ValueError(f"{kind}.{name} has {v.shape[0]} rows, the state {nl}")
        arrays[f"state.{name}"] = v.cpu().numpy()
        fields[name] = {"dtype": str(v.dtype).replace("torch.", ""), "row_shape": list(v.shape[1:]), "split": split}
    arrays["format_version"] = np.int32(FORMAT_VERSION)
    os.makedirs(dirpath, exist_ok=True)
    tmp = os.path.join(dirpath, f"rank{me}.tmp.npz")
    np.savez(tmp, **arrays)
    os.replace(tmp, os.path.join(dirpath, f"rank{me}.npz"))
    counts = [nl]
    if dist.is_initialized() and d > 1:
        counts = [None] * dist.get_world_size()
        dist.all_gather_object(counts, (me, nl))
        counts = [c for _, c in sorted(x for x in counts if x[0] < d)]
    starts = np.concatenate([[0], np.cumsum(counts)]).tolist()
    if me == 0:
        _write_manifest(dirpath, dict(format_version=FORMAT_VERSION, kind=kind, n=int(starts[-1]), world_size=d,
                                      fields=fields, ranks=[[int(a), int(b)] for a, b in zip(starts, starts[1:])]))
    if dist.is_initialized() and d > 1:
        dist.barrier()


def load_sharded(dirpath: str, mesh=None, device=None):
    """This rank's shard of a save_sharded checkpoint, of the state's own
    type, on `device`: by default the mesh's device, or the card when no
    mesh is given. The mesh may have another size D'
    than the one that saved, as long as D' divides N: the rank of shard
    index d reads rows [d N/D', (d + 1) N/D') from the files holding them
    (the counterpart of the JAX package's load_sharded_orbax). A
    SpatialState, owned by slabs, needs the saving D, and gets its rank's
    generator back."""
    kinds = _sharded_kinds()
    m = _read_manifest(dirpath, kinds)
    me, d = _world(mesh)
    if device is None:
        from nbx_torch.parallel.shard import mesh_device

        device = mesh_device(mesh) if mesh is not None else CUDA
    n, d_saved = m["n"], m["world_size"]
    if n % d:
        raise ValueError(f"N={n} rows do not divide over {d} shards")
    if m["kind"] == "SpatialState" and d != d_saved:
        raise ValueError(f"a SpatialState saved by {d_saved} ranks restores onto {d_saved}, not {d}")
    lo, hi = me * n // d, (me + 1) * n // d
    split = [name for name, f in m["fields"].items() if f["split"]]
    parts: dict = {name: [] for name in split}
    arrays, gen = {}, None
    for r, (a, b) in enumerate(m["ranks"]):
        if b <= lo or a >= hi:
            continue
        with np.load(os.path.join(dirpath, f"rank{r}.npz")) as z:
            for name in split:
                parts[name].append(z[f"state.{name}"][max(lo, a) - a:min(hi, b) - a])
            for name in m["fields"]:
                if name not in split:  # replicated: the same in every file
                    arrays.setdefault(name, z[f"state.{name}"])
            if "state.generator" in z:  # a SpatialState's: D is the saving D, so r is this rank
                gen = _generator(z, device, 0)
    arrays.update((name, np.concatenate(parts[name])) for name in split)
    kw = {name: torch.from_numpy(np.array(arr)).to(device) for name, arr in arrays.items()}
    if gen is not None:
        kw["generator"] = gen
    return kinds[m["kind"]](**kw)
