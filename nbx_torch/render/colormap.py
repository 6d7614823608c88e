"""Body colour model and tonemap (port of `nbx/render/colormap.py`).

A point splat has no surface, so the reference shader's colour ramp collapses
to one colour a body:

    base  = mix(color2, color1, 0.5)
    hot   = lerp(base, (1.0, 0.3, 0.1), clamp(T / 50, 0, 1) * 0.7)
    glow  = 1 + heat_to_glow * max(T - 50, 0) / 50

`tonemap` is three.js's ACESFilmicToneMapping (the reference renderer's), or
the softer Reinhard-exp curve, then the display gamma.
"""

from __future__ import annotations

import numpy as np
import torch

HEAT_COLOR = np.array([1.0, 0.3, 0.1], np.float32)
GLOW_TEMP = 50.0

# three.js ACESFilmicToneMapping: the RRT+ODT rational fit between fixed
# colour-space matrices (row-major, for row-vector pixels).
_ACES_IN = np.array(
    [[0.59719, 0.35458, 0.04823],
     [0.07600, 0.90834, 0.01566],
     [0.02840, 0.13383, 0.83777]], np.float32)
_ACES_OUT = np.array(
    [[1.60475, -0.53108, -0.07367],
     [-0.10208, 1.10813, -0.00605],
     [-0.00327, -0.07276, 1.07602]], np.float32)


_CONSTS: dict = {}


def const(a, like: torch.Tensor) -> torch.Tensor:
    """A float32 constant (numpy array or tuple) on the device of `like`,
    copied there once per device and kept: a frame makes no host-to-device
    copy (one from pageable memory waits for the stream)."""
    a = np.asarray(a, np.float32)
    key = (a.tobytes(), a.shape, like.device)
    t = _CONSTS.get(key)
    if t is None:
        t = _CONSTS[key] = torch.from_numpy(a.copy()).to(like.device)
    return t


def body_color(temp: torch.Tensor, mat: torch.Tensor, color1: torch.Tensor, color2: torch.Tensor,
               heat_to_glow: float = 3.0) -> torch.Tensor:
    """Per-body emissive RGB, [N, 3] float32 (unbounded: tonemapped later)."""
    mat = mat.long()
    base = 0.5 * (color1[mat] + color2[mat])
    heat = torch.clamp(temp / GLOW_TEMP, 0.0, 1.0)[:, None]
    col = base * (1.0 - 0.7 * heat) + const(HEAT_COLOR, temp) * (0.7 * heat)
    glow = 1.0 + heat_to_glow * torch.clamp(temp - GLOW_TEMP, min=0.0)[:, None] / GLOW_TEMP
    return col * glow


def tonemap(hdr: torch.Tensor, exposure: float = 1.0, mode: str = "aces") -> torch.Tensor:
    """Tonemap and gamma, [H, W, 3] float32 -> [H, W, 3] in [0, 1].

    mode="aces": three.js's ACESFilmicToneMapping (colour *= exposure / 0.6,
    input matrix, RRTAndODTFit a(v)/b(v), output matrix, saturate), the
    reference's; mode="reinhard": 1 - exp(-hdr exposure)."""
    if mode == "aces":
        c = torch.clamp(hdr, min=0.0) * np.float32(exposure / 0.6)
        c = c @ const(_ACES_IN.T, hdr)
        a = c * (c + 0.0245786) - 0.000090537
        b = c * (0.983729 * c + 0.4329510) + 0.238081
        c = (a / b) @ const(_ACES_OUT.T, hdr)
        x = torch.clamp(c, 0.0, 1.0)
    else:
        x = torch.clamp(1.0 - torch.exp(-hdr * exposure), 0.0, 1.0)
    return torch.pow(x, 1.0 / 2.2)
