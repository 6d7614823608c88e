"""Thermal model (port of `nbx/thermal.py`).

Heating is applied inside collision resolution: dT = (impact_energy / mass)
* 0.2 per body of an approaching overlap pair. Decay runs once per substep
after the second half-kick: T *= heat_decay; T < 0.1 -> 0.
"""

from __future__ import annotations

import torch

HEAT_FRACTION = 0.2  # fraction of specific impact energy converted to heat
SNAP_TO_ZERO = 0.1  # temperatures below this snap to exactly 0


def decay(temp: torch.Tensor, heat_decay: float) -> torch.Tensor:
    t = temp * heat_decay
    return torch.where(t < SNAP_TO_ZERO, 0.0, t)


def impact_heating(impact_energy: torch.Tensor, mass: torch.Tensor) -> torch.Tensor:
    """Temperature increment for one body from one impact."""
    safe_m = torch.where(mass > 0, mass, 1.0)
    return torch.where(mass > 0, impact_energy / safe_m * HEAT_FRACTION, 0.0)
