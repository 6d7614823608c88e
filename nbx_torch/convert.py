"""Carry configurations and states between the JAX package and this port as
plain Python scalars and numpy arrays. Nothing here imports jax; the caller
turns JAX arrays into numpy (`np.asarray`) on its side. What is built here
goes to the card unless the caller asks for the CPU (`device="cpu"`)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from nbx_torch.collisions_scaled import GranularState
from nbx_torch.config import CUDA, SimConfig
from nbx_torch.integrators import HermiteState, PhaseState
from nbx_torch.parallel.shard import ShardedBodyState, ShardedState
from nbx_torch.parallel.spatial import SpatialState
from nbx_torch.state import SimState, make_generator

# The SimState leaves that carry over, with their dtypes.
STATE_FIELDS = {
    "pos": torch.float32,
    "vel": torch.float32,
    "acc": torch.float32,
    "mass": torch.float32,
    "temp": torch.float32,
    "mat": torch.int32,
    "alive": torch.bool,
    "seq": torch.int32,
    "next_seq": torch.int32,
    "step_count": torch.int32,
}


def config_from_fields(fields: dict, device=CUDA) -> SimConfig:
    """A SimConfig from a dict of its scalar fields (for example
    `{f.name: getattr(jax_cfg, f.name) for f in dataclasses.fields(jax_cfg)}`).
    A `materials` entry is ignored: the port's default table, which equals
    the JAX package's, is placed on `device`."""
    names = {f.name for f in dataclasses.fields(SimConfig)} - {"materials"}
    kwargs = {k: v for k, v in fields.items() if k in names}
    for k, v in kwargs.items():  # numpy/JAX scalars -> Python scalars
        kwargs[k] = type(getattr(SimConfig, k))(np.asarray(v).item())
    return SimConfig(**kwargs).to(device)


def state_from_arrays(
    arrays: dict, cfg: SimConfig, device=CUDA, seed: int = 0
) -> SimState:
    """A SimState from the JAX SimState's leaves as numpy arrays (pos, vel,
    acc, mass, temp, mat, alive, seq, next_seq, step_count, and contact when
    cfg.collisions).

    The JAX PRNG key does not carry over: torch cannot continue its stream.
    The new state's generator is seeded with `seed`; to reproduce the JAX
    package's fracture draws, pass them explicitly through the `draws=`
    argument of `sim.substep` / `collisions.resolve_collisions`."""
    kw = {
        name: torch.as_tensor(np.array(arrays[name]), dtype=dtype).to(device)
        for name, dtype in STATE_FIELDS.items()
    }
    contact = None
    if cfg.collisions:
        contact = torch.as_tensor(np.array(arrays["contact"]), dtype=torch.float32).to(device)
    return SimState(**kw, generator=make_generator(device, seed), contact=contact)


def state_to_arrays(state: SimState) -> dict:
    """The state's leaves as numpy arrays (contact included when present)."""
    out = {name: getattr(state, name).cpu().numpy() for name in STATE_FIELDS}
    if state.contact is not None:
        out["contact"] = state.contact.cpu().numpy()
    return out


# The GranularState leaves that carry over, with their dtypes.
GRANULAR_FIELDS = {
    "pos": torch.float32,
    "vel": torch.float32,
    "mass": torch.float32,
    "mat": torch.int32,
    "temp": torch.float32,
    "partner": torch.int32,
    "contact_t": torch.float32,
}


def granular_state_from_arrays(arrays: dict, device=CUDA, seed: int = 0) -> GranularState:
    """A GranularState from the JAX GranularState's leaves as numpy arrays
    (all of GRANULAR_FIELDS). As for state_from_arrays, the JAX key does not
    carry over: the generator is seeded with `seed`, and the JAX package's
    fracture draws go in through `draws=`."""
    kw = {
        name: torch.as_tensor(np.array(arrays[name]), dtype=dtype).to(device)
        for name, dtype in GRANULAR_FIELDS.items()
    }
    return GranularState(**kw, generator=make_generator(device, seed))


def granular_state_to_arrays(state: GranularState) -> dict:
    """The GranularState's leaves (all but the generator) as numpy arrays."""
    return {name: getattr(state, name).cpu().numpy() for name in GRANULAR_FIELDS}


def _tensors(arrays: dict, fields: tuple, device) -> dict:
    """The named arrays as tensors on `device`, each keeping its dtype (the
    float64 states of an x64 run stay float64)."""
    return {name: torch.as_tensor(np.array(arrays[name])).to(device) for name in fields}


def phase_state_from_arrays(arrays: dict, device=CUDA) -> PhaseState:
    """An integrators.PhaseState from the JAX PhaseState's fields (pos, vel,
    acc) as numpy arrays."""
    return PhaseState(**_tensors(arrays, PhaseState._fields, device))


def phase_state_to_arrays(state: PhaseState | HermiteState) -> dict:
    """The fields of an integrator state (PhaseState or HermiteState) as
    numpy arrays."""
    return {name: t.cpu().numpy() for name, t in state._asdict().items()}


def hermite_state_from_arrays(arrays: dict, device=CUDA) -> HermiteState:
    """An integrators.HermiteState from the JAX HermiteState's fields (pos,
    vel, acc, jerk) as numpy arrays."""
    return HermiteState(**_tensors(arrays, HermiteState._fields, device))


hermite_state_to_arrays = phase_state_to_arrays


# The SpatialState leaves that carry over, with their dtypes (uid_next aside).
SPATIAL_FIELDS = {
    "pos": torch.float32,
    "vel": torch.float32,
    "acc": torch.float32,
    "mass": torch.float32,
    "mat": torch.int32,
    "temp": torch.float32,
    "uid": torch.int32,
    "partner_uid": torch.int32,
    "contact_t": torch.float32,
}


def spatial_state_from_arrays(arrays: dict, rank: int, n_ranks: int, device=CUDA, seed: int = 0) -> SpatialState:
    """Rank `rank`'s SpatialState from the JAX SpatialState's global leaves
    ([D nl] slot arrays, chip d's slots at [d nl, (d + 1) nl), and uid_next)
    as numpy arrays, D = n_ranks. The JAX key does not carry over: the
    rank's generator is seeded from (seed, rank), as spatial_state_for
    seeds it, and the JAX package's fracture draws go in through the step's
    `draws=`."""
    nl = np.asarray(arrays["mass"]).shape[0] // n_ranks
    rows = slice(rank * nl, (rank + 1) * nl)
    kw = {
        name: torch.as_tensor(np.array(arrays[name][rows]), dtype=dtype).to(device)
        for name, dtype in SPATIAL_FIELDS.items()
    }
    uid_next = torch.tensor(int(np.asarray(arrays["uid_next"])), dtype=torch.int32, device=device)
    rank_seed = int(np.random.SeedSequence([seed, rank]).generate_state(1)[0])
    return SpatialState(**kw, uid_next=uid_next, generator=make_generator(device, rank_seed))


def spatial_state_to_arrays(*states: SpatialState) -> dict:
    """The leaves of the ranks' states, given in rank order, as numpy arrays
    in the JAX package's global layout ([D nl] slots, uid_next); one state
    gives its own rank's rows."""
    out = {name: np.concatenate([getattr(s, name).cpu().numpy() for s in states]) for name in SPATIAL_FIELDS}
    out["uid_next"] = np.asarray(int(states[0].uid_next), np.int32)
    return out


# The leaves of the all-gather paths' states (`parallel.shard`), with their dtypes.
SHARDED_FIELDS = {"pos": torch.float32, "vel": torch.float32, "acc": torch.float32, "mass": torch.float32}
SHARDED_BODY_FIELDS = dict(SHARDED_FIELDS, mat=torch.int32, temp=torch.float32, partner=torch.int32,
                           contact_t=torch.float32)


def _shard_rows(arrays: dict, fields: dict, shard: int, n_shards: int, device) -> dict:
    n = np.asarray(arrays["mass"]).shape[0]
    if n % n_shards:
        raise ValueError(f"N={n} not divisible by {n_shards} shards")
    nl = n // n_shards
    rows = slice(shard * nl, (shard + 1) * nl)
    return {name: torch.as_tensor(np.array(arrays[name][rows]), dtype=dtype).to(device)
            for name, dtype in fields.items()}


def sharded_state_from_arrays(arrays: dict, shard: int, n_shards: int, device=CUDA) -> ShardedState:
    """Shard `shard` of D = n_shards of the JAX ShardedState's global leaves
    (pos, vel, acc, mass as numpy arrays): rows [shard N/D, (shard + 1) N/D).
    On a 1-D mesh the shard is the rank's coordinate; on the 2-D mesh
    ("b", "j") it is b |j| + j."""
    return ShardedState(**_shard_rows(arrays, SHARDED_FIELDS, shard, n_shards, device))


def sharded_state_to_arrays(*states: ShardedState) -> dict:
    """The leaves of the shards' states, given in shard order, as numpy
    arrays in the JAX package's global layout; one state gives its own
    rows."""
    return {name: np.concatenate([getattr(s, name).cpu().numpy() for s in states]) for name in SHARDED_FIELDS}


def sharded_body_state_from_arrays(arrays: dict, shard: int, n_shards: int, device=CUDA) -> ShardedBodyState:
    """Shard `shard` of D = n_shards of the JAX ShardedBodyState's global
    leaves (pos, vel, acc, mass, mat, temp, partner, contact_t as numpy
    arrays). partner holds global ids in both packages, so it carries over
    as it is."""
    return ShardedBodyState(**_shard_rows(arrays, SHARDED_BODY_FIELDS, shard, n_shards, device))


def sharded_body_state_to_arrays(*states: ShardedBodyState) -> dict:
    """The leaves of the shards' ShardedBodyStates, given in shard order, as
    numpy arrays in the JAX package's global layout."""
    return {name: np.concatenate([getattr(s, name).cpu().numpy() for s in states])
            for name in SHARDED_BODY_FIELDS}


# ---- the renderer's state (`render.pipeline.FrameState` and its parts) ----------------

TRAIL_FIELDS = {"pos": torch.float32, "valid": torch.bool, "head": torch.int32}
PARTICLE_FIELDS = {"pos": torch.float32, "vel": torch.float32, "life": torch.float32, "decay": torch.float32}
LIGHT_FIELDS = {"pos": torch.float32, "intensity": torch.float32}


def _fields(arrays: dict, fields: dict, device) -> dict:
    return {name: torch.as_tensor(np.array(arrays[name]), dtype=dtype).to(device) for name, dtype in fields.items()}


def trail_state_from_arrays(arrays: dict, device=CUDA):
    """A render.trails.TrailState from the JAX TrailState's fields (pos,
    valid, head) as numpy arrays."""
    from nbx_torch.render.trails import TrailState

    return TrailState(**_fields(arrays, TRAIL_FIELDS, device))


def particle_state_from_arrays(arrays: dict, device=CUDA, seed: int = 0):
    """A render.particles.ParticleState from the JAX ParticleState's fields
    (pos, vel, life, decay) as numpy arrays. The JAX key does not carry over:
    the generator is seeded with `seed`, and the JAX package's draws go in
    through the spawns' `draws=`."""
    from nbx_torch.render.particles import ParticleState

    return ParticleState(**_fields(arrays, PARTICLE_FIELDS, device), generator=make_generator(device, seed))


def light_state_from_arrays(arrays: dict, device=CUDA):
    """A render.lights.LightState from the JAX LightState's fields (pos,
    intensity) as numpy arrays."""
    from nbx_torch.render.lights import LightState

    return LightState(**_fields(arrays, LIGHT_FIELDS, device))


def frame_state_from_arrays(arrays: dict, device=CUDA, seed: int = 0):
    """A render.pipeline.FrameState from a dict of three dicts, "trails",
    "particles" and "lights", each its part's fields as numpy arrays
    (`frame_state_to_arrays`' layout)."""
    from nbx_torch.render.pipeline import FrameState

    return FrameState(trails=trail_state_from_arrays(arrays["trails"], device),
                      particles=particle_state_from_arrays(arrays["particles"], device, seed),
                      lights=light_state_from_arrays(arrays["lights"], device))


def frame_state_to_arrays(frame) -> dict:
    """A FrameState's fields (the generator aside) as numpy arrays, in the
    layout frame_state_from_arrays reads."""
    return {part: {name: getattr(getattr(frame, part), name).cpu().numpy() for name in fields}
            for part, fields in (("trails", TRAIL_FIELDS), ("particles", PARTICLE_FIELDS), ("lights", LIGHT_FIELDS))}


def camera_from_fields(eye, target, up, fov_deg: float = 45.0, device=CUDA):
    """A render.splat.Camera from the JAX Camera's fields (eye, target, up as
    3-vectors, fov_deg)."""
    from nbx_torch.render.splat import Camera

    def vec(x):
        return torch.as_tensor(np.array(x, np.float32)).to(device)

    return Camera(eye=vec(eye), target=vec(target), up=vec(up), fov_deg=float(np.asarray(fov_deg)))


def starfield_from_array(dirs, device=CUDA) -> torch.Tensor:
    """The starfield's unit directions ([n, 3], for example the JAX package's
    starfield_directions()) on `device`."""
    return torch.as_tensor(np.array(dirs), dtype=torch.float32).to(device)
