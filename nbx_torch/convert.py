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
