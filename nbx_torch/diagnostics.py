"""Diagnostics: energy, momentum, drift, event counters (port of
`nbx/diagnostics.py`). Computed on the state's device; only `write_jsonl`
reads them back."""

from __future__ import annotations

import dataclasses
import json

import torch

from nbx_torch import forces
from nbx_torch.config import SimConfig
from nbx_torch.state import SimState


@dataclasses.dataclass(frozen=True)
class Diagnostics:
    kinetic: torch.Tensor  # [] f32
    potential: torch.Tensor  # [] f32
    momentum: torch.Tensor  # [3] f32
    angular_momentum: torch.Tensor  # [3] f32
    total_mass: torch.Tensor  # [] f32
    n_alive: torch.Tensor  # [] i32
    max_temp: torch.Tensor  # [] f32

    @property
    def energy(self) -> torch.Tensor:
        return self.kinetic + self.potential


def measure(state: SimState, cfg: SimConfig, block: int | None = None) -> Diagnostics:
    """Diagnostics over the alive bodies (dead slots have mass 0 and add
    nothing to any sum)."""
    pos, vel, mass = state.pos, state.vel, state.mass
    return Diagnostics(
        kinetic=forces.kinetic_energy(vel, mass),
        potential=forces.potential_energy(pos, mass, cfg.G, cfg.softening, block),
        momentum=(mass[:, None] * vel).sum(0),
        angular_momentum=(mass[:, None] * torch.linalg.cross(pos, vel)).sum(0),
        total_mass=mass.sum(),
        n_alive=state.n_alive,
        max_temp=state.temp.max(),
    )


def measure_arrays(pos, vel, mass, G, softening, block: int | None = None) -> Diagnostics:
    """Diagnostics for raw phase-space arrays (gravity-only paths)."""
    return Diagnostics(
        kinetic=forces.kinetic_energy(vel, mass),
        potential=forces.potential_energy(pos, mass, G, softening, block),
        momentum=(mass[:, None] * vel).sum(0),
        angular_momentum=(mass[:, None] * torch.linalg.cross(pos, vel)).sum(0),
        total_mass=mass.sum(),
        n_alive=(mass > 0).sum(dtype=torch.int32),
        max_temp=torch.zeros((), dtype=torch.float32, device=pos.device),
    )


def relative_energy_drift(diags: Diagnostics) -> torch.Tensor:
    """max_t |E_t - E_0| / |E_0| over a stacked per-step Diagnostics log."""
    e = diags.kinetic + diags.potential
    return ((e - e[0]).abs() / e[0].abs()).max()


def run_logged(state, cfg, n_steps: int, path: str | None = None, force_impl: str = "auto"):
    """Run n_steps with per-frame diagnostics, optionally writing JSONL.
    Returns (final_state, stacked Diagnostics [n_steps])."""
    from nbx_torch import sim as simmod

    state, diags = simmod.run(state, cfg, n_steps, force_impl, diagnostics=measure)
    if path is not None:
        write_jsonl(path, diags)
    return state, diags


def write_jsonl(path: str, diags: Diagnostics) -> None:
    """Write a stacked per-step Diagnostics log as JSONL."""
    arrays = {f.name: getattr(diags, f.name).cpu().numpy() for f in dataclasses.fields(diags)}
    n = arrays["kinetic"].shape[0]
    with open(path, "w") as fh:
        for t in range(n):
            rec = {"step": t}
            for k, v in arrays.items():
                rec[k] = v[t].tolist() if v[t].ndim else v[t].item()
            rec["energy"] = rec["kinetic"] + rec["potential"]
            fh.write(json.dumps(rec) + "\n")
