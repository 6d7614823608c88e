"""Interactive host API (port of `nbx/interactive.py`): `Simulation` wraps a
live state with the reference GUI's verbs.

  sim.set(G=2.0, fracture_threshold=50)   # live retune: a new SimConfig
  sim.spawn(pos, vel)                     # addBody with FIFO eviction
  sim.spawn_drag(start, end)              # the drag-back slingshot:
                                          # vel = -0.5 * (end - start)
  sim.step(n)                             # n frames
  sim.reset('galaxy' | 'collision' | ...) # the scenario reset
  sim.bodies()                            # compacted host view
  sim.save(path) / Simulation.load(path)

It takes a `seed` for the fracture generator where the JAX package takes a
PRNG key, and a `device` (the card unless the caller asks for the CPU).
`render` and `spawn_drag_screen` need the renderer, which is not ported yet
(ROADMAP item 9); they raise NotImplementedError.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from nbx_torch import checkpoint, diagnostics, scene, sim as simmod
from nbx_torch.config import CUDA, ROCK, SimConfig
from nbx_torch.state import SimState, add_body, compact_arrays

SPAWN_VELOCITY_FACTOR = -0.5  # drag-back slingshot


class Simulation:
    """Host-side handle on a live simulation on `device`."""

    def __init__(self, cfg: Optional[SimConfig] = None, scenario: str = "galaxy", seed: int = 0,
                 device=CUDA, **scenario_kw):
        self.device = torch.device(device)
        self.cfg = (cfg or SimConfig()).to(self.device)
        self.state: SimState = None  # set by reset
        self._seed = seed
        self.reset(scenario, **scenario_kw)

    # -- config (the GUI layer) -------------------------------------------
    def set(self, **fields) -> "Simulation":
        """Retune parameters live (G, dt, softening, spawn_mass,
        fracture_threshold, merge_time, ...). Fields that set a shape
        (capacity, max_merges, ...) must match the state's."""
        self.cfg = self.cfg.replace(**fields)
        return self

    # -- scenario lifecycle -------------------------------------------------
    def reset(self, scenario: str = "galaxy", **kw) -> "Simulation":
        builder = scene.SCENARIOS[scenario]
        if scenario == "galaxy":
            kw.setdefault("G", float(self.cfg.G))
            # fit the reference's 1 + 150 bodies into smaller capacities
            kw.setdefault("n_disk", min(150, self.cfg.capacity - 1))
        self.state = scene.make_state(self.cfg, builder(**kw), self.device, seed=self._seed)
        return self

    # -- stepping -----------------------------------------------------------
    def step(self, n_frames: int = 1):
        """Advance n frames. Returns the stacked event log."""
        if n_frames == 1:
            self.state, events = simmod.step(self.state, self.cfg)
        else:
            self.state, events = simmod.run(self.state, self.cfg, n_frames)
        return events

    # -- interaction ----------------------------------------------------------
    def spawn(self, pos, vel, mass: float | None = None, mat: int = ROCK, temp: float = 0.0) -> bool:
        """addBody. Returns True if a body was FIFO-evicted to make room."""
        m = self.cfg.spawn_mass if mass is None else mass
        self.state, evicted = add_body(self.state, m, np.asarray(pos, np.float32), np.asarray(vel, np.float32),
                                       mat, temp)
        return bool(evicted)

    def spawn_drag(self, start, end, mass: float | None = None, mat: int = ROCK) -> bool:
        """The mouse-drag slingshot: spawn at `start` with velocity
        -0.5 * (end - start)."""
        start = np.asarray(start, np.float32)
        end = np.asarray(end, np.float32)
        return self.spawn(start, SPAWN_VELOCITY_FACTOR * (end - start), mass=mass, mat=mat)

    def spawn_drag_screen(self, cam, sx0, sy0, sx1, sy1, width: int = 640, height: int = 360,
                          mass: float | None = None, mat: int = ROCK) -> tuple[bool, bool]:
        raise NotImplementedError("spawn_drag_screen raycasts through the renderer's camera, "
                                  "which is not ported yet (ROADMAP item 9)")

    # -- observation -----------------------------------------------------------
    def bodies(self) -> dict:
        """Compacted host view in insertion order."""
        return compact_arrays(self.state)

    @property
    def n_alive(self) -> int:
        return int(self.state.n_alive)

    def measure(self) -> diagnostics.Diagnostics:
        """The diagnostics of the current state, as numpy values."""
        d = diagnostics.measure(self.state, self.cfg)
        return type(d)(**{f.name: getattr(d, f.name).cpu().numpy() for f in dataclasses.fields(d)})

    def render(self, cam=None, width: int = 640, height: int = 360, exposure: float = 1.5) -> np.ndarray:
        raise NotImplementedError("render needs the renderer (render.splat), which is not ported yet "
                                  "(ROADMAP item 9)")

    # -- persistence -----------------------------------------------------------
    def run_checkpointed(self, n_frames: int, path: str, every: int = 100) -> None:
        """Advance n_frames, snapshotting every `every` frames: a killed job
        resumes from the last snapshot with Simulation.load(path) and loses
        at most `every` frames. Each snapshot is written to a temporary file
        and renamed over `path`, so a snapshot is never torn."""
        done = 0
        while done < n_frames:
            chunk = min(every, n_frames - done)
            self.step(chunk)
            done += chunk
            tmp = path + ".tmp.npz"  # np.savez appends .npz to bare names
            checkpoint.save_state(tmp, self.state, self.cfg)
            os.replace(tmp, path)

    def save(self, path: str) -> None:
        checkpoint.save_state(path, self.state, self.cfg)

    @classmethod
    def load(cls, path: str, device=CUDA) -> "Simulation":
        state, cfg = checkpoint.load_state(path, device)
        obj = cls.__new__(cls)
        obj.device = torch.device(device)
        # The fallback config must match the saved state's shapes: a state
        # from a run without collisions has no contact timers, and stepping
        # it with collisions on would fail.
        obj.cfg = cfg or SimConfig(capacity=state.capacity, collisions=state.contact is not None).to(device)
        obj.state = state
        obj._seed = 0
        return obj
