"""The simulation step: gravity + collisions + thermal (port of `nbx/sim.py`).

Per substep, the reference's order:

    1. half-kick with the previous acceleration
    2. drift
    3. gravity -> new accelerations
    4. collision resolution (pos/vel/temp, kills, births; newborns have acc 0)
    5. half-kick with the new acceleration
    6. thermal decay

and `cfg.sub_steps` substeps of dt / sub_steps per frame. PyTorch runs
eagerly, so `step` is a plain function and `run` a Python loop over frames.
Every scalar is float32, as in the JAX package, and the step reads nothing
back to the host.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from nbx_torch import forces, thermal
from nbx_torch.collisions import (
    Draws, Events, empty_events, resolve_collisions, resolve_collisions_sequential,
)
from nbx_torch.config import SimConfig
from nbx_torch.ops.pairwise import pairwise_acc
from nbx_torch.state import SimState

# Dense O(N^2)-memory gravity up to this capacity; above it the kernel on a
# CUDA tensor, row blocks on a CPU tensor.
_DENSE_MAX = 2048

# The collision sweeps: "jacobi", the data-parallel sweep of
# `resolve_collisions`, and "sequential", the strict in-sweep-visibility
# sweep of `resolve_collisions_sequential`. The JAX package runs any other
# value as "jacobi"; the port raises ValueError.
COLLISION_IMPLS = {"jacobi": resolve_collisions, "sequential": resolve_collisions_sequential}


def _collision_impl(name: str):
    if name not in COLLISION_IMPLS:
        raise ValueError(f"collision_impl must be one of {sorted(COLLISION_IMPLS)}, got {name!r}")
    return COLLISION_IMPLS[name]


def gravity(
    pos: torch.Tensor, mass: torch.Tensor, G: float, softening: float, impl: str = "auto"
) -> torch.Tensor:
    """Acceleration dispatcher. impl: auto | dense | blocked | pairwise."""
    n = pos.shape[0]
    if impl == "auto":
        if n <= _DENSE_MAX:
            impl = "dense"
        else:
            impl = "pairwise" if pos.is_cuda else "blocked"
    if impl == "dense":
        return forces.accelerations(pos, mass, G, softening)
    if impl == "blocked":
        block = min(1024, n)
        while n % block:
            block //= 2
        return forces.accelerations_blocked(pos, mass, G, softening, block)
    if impl == "pairwise":
        return pairwise_acc(pos, mass, G, softening)
    raise ValueError(f"unknown force impl {impl!r}")


def substep(
    state: SimState, cfg: SimConfig, h: float, force_impl: str = "auto",
    draws: Optional[Draws] = None, collision_impl: str = "jacobi",
) -> tuple[SimState, Events]:
    """One physics substep of size h. `draws` supplies the fracture uniforms
    (see collisions.resolve_collisions); None draws them from the state's
    generator. collision_impl: "jacobi" (the default, the data-parallel
    sweep) or "sequential" (the strict in-sweep-visibility sweep, one kernel
    launch a substep on the card, at most ops.sequential.MAX_CAPACITY
    bodies); any other value raises ValueError."""
    resolve = _collision_impl(collision_impl)
    half = 0.5 * h
    vel = state.vel + state.acc * half  # half-kick, old acc
    pos = state.pos + vel * h  # drift
    acc = gravity(pos, state.mass, cfg.G, cfg.softening, force_impl)
    state = state.replace(pos=pos, vel=vel, acc=acc)

    if cfg.collisions:
        state, events = resolve(state, cfg, h, draws)
    else:
        events = empty_events(cfg, state.device)

    # Second half-kick; newborns were created with acc = 0, so they are
    # unkicked, as in the reference.
    vel = state.vel + state.acc * half
    temp = thermal.decay(state.temp, cfg.heat_decay)
    return state.replace(vel=vel, temp=temp, step_count=state.step_count + 1), events


def substep_size(cfg: SimConfig) -> float:
    """h = dt / sub_steps, computed in float32 as the JAX package does."""
    return float(np.float32(cfg.dt) / np.float32(cfg.sub_steps))


def _stack(items: list):
    """Stack a list of tensors, or of dataclasses of tensors, along a new
    leading axis."""
    first = items[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(items)
    return type(first)(**{
        f.name: torch.stack([getattr(x, f.name) for x in items])
        for f in dataclasses.fields(first)
    })


def step(
    state: SimState, cfg: SimConfig, force_impl: str = "auto", collision_impl: str = "jacobi",
) -> tuple[SimState, Events]:
    """One frame = cfg.sub_steps substeps of dt / sub_steps. The Events of
    the substeps are stacked along a leading axis."""
    h = substep_size(cfg)
    evs = []
    for _ in range(cfg.sub_steps):
        state, e = substep(state, cfg, h, force_impl, collision_impl=collision_impl)
        evs.append(e)
    return state, _stack(evs)


def run(
    state: SimState,
    cfg: SimConfig,
    n_steps: int,
    force_impl: str = "auto",
    diagnostics: Optional[Callable[[SimState, SimConfig], object]] = None,
    collision_impl: str = "jacobi",
) -> tuple[SimState, object]:
    """n_steps frames. Returns (final state, stacked aux): the per-frame
    output of `diagnostics(state, cfg)` if given, else the Events log,
    stacked along a leading frame axis."""
    outs = []
    for _ in range(n_steps):
        state, ev = step(state, cfg, force_impl, collision_impl)
        outs.append(diagnostics(state, cfg) if diagnostics is not None else ev)
    return state, _stack(outs)
