"""Camera paths for demo movies (port of `nbx/render/campath.py`): smooth
orbit sweeps and keyframe moves.

  * orbit_path: a continuous orbit sweep (yaw / pitch / zoom spread over the
    clip, optionally eased);
  * keyframe_path: piecewise interpolation through Camera keyframes; the eye
    moves in the orbit parameterisation (radius, yaw, pitch) around each
    segment's interpolated target, so moves circle bodies instead of cutting
    through them.

Each yielded Camera's tensors live on the first camera's device.
"""

from __future__ import annotations

import math
from typing import Iterator, Sequence

import torch

from nbx_torch.render.splat import Camera


def ease_in_out(t):
    """Smoothstep easing on [0, 1] (a float, or a tensor)."""
    t = torch.clamp(torch.as_tensor(t, dtype=torch.float32), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def _to_orbit(cam: Camera):
    rel = cam.eye - cam.target
    r = torch.linalg.vector_norm(rel)
    yaw = torch.atan2(rel[0], rel[2])
    pitch = torch.asin(torch.clamp(rel[1] / torch.clamp(r, min=1e-9), -1.0, 1.0))
    return r, yaw, pitch


def _from_orbit(target, up, r, yaw, pitch, fov_deg) -> Camera:
    eye = target + r * torch.stack([torch.cos(pitch) * torch.sin(yaw), torch.sin(pitch),
                                    torch.cos(pitch) * torch.cos(yaw)])
    return Camera(eye=eye, target=target, up=up, fov_deg=fov_deg)


def orbit_path(cam: Camera, n_frames: int, d_yaw: float = 2.0 * math.pi, d_pitch: float = 0.0, zoom: float = 1.0,
               ease: bool = False) -> Iterator[Camera]:
    """Sweep the orbit by d_yaw / d_pitch radians and a total zoom factor over
    n_frames (default: one full turn); ease=True paces it with smoothstep,
    False keeps a constant angular speed (a looping turntable)."""
    r0, yaw0, pitch0 = _to_orbit(cam)
    for i in range(n_frames):
        t = i / max(n_frames - 1, 1)
        s = float(ease_in_out(t)) if ease else t
        yield _from_orbit(cam.target, cam.up, r0 * zoom**s, yaw0 + d_yaw * s,
                          torch.clamp(pitch0 + d_pitch * s, -1.45, 1.45), cam.fov_deg)


def keyframe_path(keys: Sequence[Camera], n_frames: int, ease: bool = True) -> Iterator[Camera]:
    """Interpolate through Camera keyframes over n_frames (equal frame
    budgets a segment). Radius, yaw (the short way round) and pitch lerp
    around the interpolated target."""
    if len(keys) < 2:
        raise ValueError("keyframe_path needs at least 2 keyframes")
    n_seg = len(keys) - 1
    for i in range(n_frames):
        u = i / max(n_frames - 1, 1) * n_seg
        seg = min(int(u), n_seg - 1)
        t = u - seg
        if ease:
            t = float(ease_in_out(t))
        a, b = keys[seg], keys[seg + 1]
        target = a.target + (b.target - a.target) * t
        up = a.up + (b.up - a.up) * t
        ra, ya, pa = _to_orbit(a)
        rb, yb, pb = _to_orbit(b)
        dy = torch.remainder(yb - ya + math.pi, 2.0 * math.pi) - math.pi  # the short way
        fov = a.fov_deg + (b.fov_deg - a.fov_deg) * float(t)
        yield _from_orbit(target, up / torch.clamp(torch.linalg.vector_norm(up), min=1e-9), ra + (rb - ra) * t,
                          ya + dy * t, pa + (pb - pa) * t, fov)
