"""Simulation configuration (port of `nbx/config.py`).

`SimConfig` mirrors the JAX package's field for field, as a frozen dataclass
of Python scalars. The JAX package splits its fields into dynamic leaves
(G, softening, dt, spawn_mass, fracture_threshold, min_fragment_mass,
merge_time, heat_decay, heat_to_glow, restitution, friction: retuning them
does not recompile) and static metadata (sub_steps, capacity, trail_length,
collisions, max_merges, max_fractures, max_fragments, match_rounds: they set
array shapes or trip counts). Eager PyTorch compiles nothing, so here
"static" only means that the field sets a shape. Keeping every field a Python
scalar means no comparison or branch on it ever waits for the device.

The JAX package computes every config scalar in float32; `f32` rounds a
Python expression of them the same way where the port needs it.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

# Material type codes (same as nbx.config).
ROCK: int = 0
METAL: int = 1
ICE: int = 2
MATERIAL_NAMES: tuple[str, ...] = ("rock", "metal", "ice")


def f32(x) -> float:
    """`x` rounded to float32, as a Python float."""
    return float(np.float32(x))


@dataclasses.dataclass(frozen=True)
class Materials:
    """Material property table: density drives the radius law
    r = (3m / 4 pi rho)^(1/3); color1/color2 feed the renderer's ramp.
    The tensors live on the device the simulation runs on."""

    density: torch.Tensor  # [M] f32
    color1: torch.Tensor  # [M, 3] f32
    color2: torch.Tensor  # [M, 3] f32

    def to(self, device) -> "Materials":
        return Materials(self.density.to(device), self.color1.to(device), self.color2.to(device))


def default_materials(device="cpu") -> Materials:
    """rock: density 1.0; metal: 3.0; ice: 0.5."""
    f = dict(dtype=torch.float32, device=device)
    return Materials(
        density=torch.tensor([1.0, 3.0, 0.5], **f),
        color1=torch.tensor([[0.4, 0.3, 0.2], [0.6, 0.6, 0.7], [0.8, 0.9, 1.0]], **f),
        color2=torch.tensor([[0.1, 0.1, 0.1], [0.3, 0.3, 0.4], [0.1, 0.3, 0.6]], **f),
    )


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """All simulation parameters; see nbx.config.SimConfig for each field's
    meaning. `materials` is created on the CPU; `to(device)` moves it."""

    G: float = 0.5
    softening: float = 0.5
    dt: float = 0.016
    spawn_mass: float = 20.0
    fracture_threshold: float = 25.0
    min_fragment_mass: float = 0.2
    merge_time: float = 0.5
    heat_decay: float = 0.998
    heat_to_glow: float = 3.0
    restitution: float = 0.2
    friction: float = 0.5
    materials: Materials = dataclasses.field(default_factory=default_materials)

    sub_steps: int = 2
    capacity: int = 300
    trail_length: int = 80
    collisions: bool = True
    max_merges: int = 16
    max_fractures: int = 8
    max_fragments: int = 18
    match_rounds: int = 4

    @property
    def max_births(self) -> int:
        return self.max_merges + self.max_fractures * self.max_fragments

    def replace(self, **kwargs) -> "SimConfig":
        return dataclasses.replace(self, **kwargs)

    def to(self, device) -> "SimConfig":
        return self.replace(materials=self.materials.to(device))


def body_radius(mass: torch.Tensor, mat: torch.Tensor, materials: Materials) -> torch.Tensor:
    """Radius from mass and material density: r = (3 m / (4 pi rho))^(1/3).

    torch has no cbrt, so this takes pow(x, 1/3) of the non-negative
    argument. It differs from `jnp.cbrt` by an ulp or so; the parity tests
    hold radii and everything downstream to float32 tolerances."""
    rho = materials.density[mat]
    return torch.pow(3.0 * mass / (4.0 * math.pi * rho), 1.0 / 3.0)


def inverse_mass(mass: torch.Tensor) -> torch.Tensor:
    """1/m for m > 0 else 0."""
    return torch.where(mass > 0, 1.0 / torch.where(mass > 0, mass, 1.0), 0.0)
