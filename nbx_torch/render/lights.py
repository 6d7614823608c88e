"""Persistent decaying flash lights (port of `nbx/render/lights.py`).

The reference makes a point light (0xffaa00, intensity min(0.2 E, 15), range
60) per merge or fracture flash, fades it x0.85 a frame and removes it below
0.1, so an event both flares and lights nearby bodies while it lives. Here
the light list is a fixed pool:

  * `advance` decays the pool and inserts the frame's new flashes into dead
    slots (a rank scatter, no sort);
  * `splat_light_glow` draws every live light's additive Gaussian flare;
  * `body_light_gain` is the per-body illumination of the pool (linear
    falloff over range 60).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from nbx_torch.collisions_scaled import _set_at
from nbx_torch.config import CUDA

LIGHT_POOL = 16  # concurrent decaying lights
DECAY = 0.85  # per-frame fade
CULL = 0.1  # removal threshold
RANGE = 60.0  # point-light range
COLOR = (1.0, 0.666, 0.0)  # 0xffaa00


class LightState(NamedTuple):
    """Fixed pool of decaying point lights. intensity == 0 marks dead."""

    pos: torch.Tensor  # [L, 3]
    intensity: torch.Tensor  # [L]

    @staticmethod
    def create(pool: int = LIGHT_POOL, device=CUDA) -> "LightState":
        return LightState(pos=torch.zeros((pool, 3), dtype=torch.float32, device=device),
                          intensity=torch.zeros((pool,), dtype=torch.float32, device=device))


def advance(lights: LightState, flash_pos, flash_energy, flash_mask) -> LightState:
    """Decay the pool one frame (x0.85, cull < 0.1), then insert this frame's
    flashes (intensity min(0.2 E, 15)) into dead slots in rank order; when
    the pool is full the frame's excess flashes are dropped."""
    ln = lights.intensity.shape[0]
    inten = lights.intensity * DECAY
    inten = torch.where(inten < CULL, 0.0, inten)

    new_i = torch.where(flash_mask, torch.clamp(0.2 * flash_energy, max=15.0), 0.0)
    want = new_i > 0.0
    dead = inten <= 0.0
    drank = torch.cumsum(dead.to(torch.int32), 0) - 1
    f = want.shape[0]
    dev = inten.device
    # x.at[idx].set(v, mode="drop") with idx in [0, len(x)]: len(x) drops
    slot_of_rank = _set_at(torch.full((f,), ln, dtype=torch.int32, device=dev),
                           torch.where(dead & (drank < f), drank, f).long(),
                           torch.arange(ln, dtype=torch.int32, device=dev))
    wrank = torch.cumsum(want.to(torch.int32), 0) - 1
    slot = torch.where(want, slot_of_rank[torch.clamp(wrank, 0, f - 1)], ln)
    slot = torch.where(slot < ln, slot, ln)
    slot = slot.long()
    return LightState(pos=_set_at(lights.pos, slot, flash_pos), intensity=_set_at(inten, slot, new_i))


def splat_light_glow(img_hdr, lights: LightState, cam, width: int = 640, height: int = 360,
                     depth=None) -> torch.Tensor:
    """Additive Gaussian flare per live light (it decays with the pool). With
    `depth`, pixels whose opaque surface is in front of the light are
    masked; the planet it lights still brightens through body_light_gain."""
    from nbx_torch.render.splat import gaussian_blobs, project

    px, py, z = project(cam, lights.pos, width, height)
    inten = torch.where(z > 1e-3, lights.intensity, 0.0)
    return gaussian_blobs(img_hdr, px, py, inten, z, COLOR, depth)


def body_light_gain(lights: LightState, pos: torch.Tensor) -> torch.Tensor:
    """Per-body incident flash light, [N]: 0.02 sum_l I_l (1 - d/60)^2,
    clamped at 0 (the classic distance-bounded point-light falloff)."""
    d = torch.linalg.vector_norm(pos[:, None, :] - lights.pos[None, :, :], dim=-1)
    fall = torch.clamp(1.0 - d / RANGE, min=0.0)
    return 0.02 * (lights.intensity[None, :] * fall * fall).sum(1)
