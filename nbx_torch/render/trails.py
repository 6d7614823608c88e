"""Ribbon trails (port of `nbx/render/trails.py`): a ring buffer of each
body's recent positions and camera-facing tapered quads between them.

The reference keeps a position history per body and rebuilds a
camera-facing ribbon each frame: half-width radius * 0.8 * (1 - i/(L-1)),
rib direction normalize((cam - p) x dir). Here the history is a [C, L, 3]
ring buffer updated in place of one slot a frame, and each quad is filled
by splatting an (n_along x n_across) lattice of sub-points.
"""

from __future__ import annotations

import dataclasses

import torch

from nbx_torch.render.colormap import body_color

WIDTH_FACTOR = 0.8  # ribbon half-width = radius * 0.8 * taper


@dataclasses.dataclass(frozen=True)
class TrailState:
    """Ring buffer: pos [C, L, 3], valid [C, L], head [] int32 (the next
    write index, a device scalar: the frame counter)."""

    pos: torch.Tensor
    valid: torch.Tensor
    head: torch.Tensor

    @staticmethod
    def create(capacity: int, length: int = 80, device=None) -> "TrailState":
        from nbx_torch.config import CUDA

        device = CUDA if device is None else device
        return TrailState(
            pos=torch.zeros((capacity, length, 3), dtype=torch.float32, device=device),
            valid=torch.zeros((capacity, length), dtype=torch.bool, device=device),
            head=torch.zeros((), dtype=torch.int32, device=device),
        )

    @property
    def length(self) -> int:
        return self.pos.shape[1]


def update(trails: TrailState, body_pos: torch.Tensor, alive: torch.Tensor) -> TrailState:
    """Push the current positions; dead bodies' histories are invalidated so
    a reused slot starts clean. The slot index stays on the device."""
    h = torch.remainder(trails.head, trails.length).long().reshape(1)
    pos = trails.pos.index_copy(1, h, body_pos[:, None, :])
    valid = trails.valid.index_copy(1, h, alive[:, None])
    valid = valid & alive[:, None]
    return TrailState(pos=pos, valid=valid, head=trails.head + 1)


def by_age(trails: TrailState) -> tuple[torch.Tensor, torch.Tensor]:
    """History reordered so index 0 is the newest sample: (pos [C, L, 3],
    valid [C, L])."""
    length = trails.length
    idx = torch.remainder(trails.head - 1 - torch.arange(length, device=trails.head.device), length)
    return trails.pos[:, idx, :], trails.valid[:, idx]


def splat_trails(img_hdr: torch.Tensor, trails: TrailState, radius, temp, mat, color1, color2, cam,
                 width: int = 640, height: int = 360, gain: float = 0.10, n_along: int = 2, n_across: int = 5,
                 depth=None) -> torch.Tensor:
    """Additive tapered ribbon quads. Per valid history segment [p_i,
    p_{i+1}]: rib = normalize((cam - p) x (p_{i+1} - p_i)), half-width
    w_i = radius * 0.8 * (1 - i/(L-1)); the quad p +- rib * w is filled with
    n_along x n_across sub-points whose summed intensity matches one trail
    point."""
    from nbx_torch.render.splat import _depth_at, _round_i, project, scatter_add

    c, length = trails.valid.shape
    dev = img_hdr.device
    pos_age, valid_age = by_age(trails)
    taper = (1.0 - torch.arange(length, device=dev) / max(length - 1, 1)).to(torch.float32)

    p0 = pos_age[:, :-1, :]
    p1 = pos_age[:, 1:, :]
    seg_ok = valid_age[:, :-1] & valid_age[:, 1:]
    seg = p1 - p0
    to_cam = cam.eye[None, None, :] - p0
    rib = torch.linalg.cross(to_cam, seg)
    rib_len = torch.linalg.vector_norm(rib, dim=-1, keepdim=True)
    rib = rib / torch.where(rib_len > 1e-6, rib_len, 1.0)
    w0 = (radius[:, None] * WIDTH_FACTOR * taper[None, :-1])[..., None]
    w1 = (radius[:, None] * WIDTH_FACTOR * taper[None, 1:])[..., None]

    t = torch.linspace(0.0, 1.0, n_along + 1, device=dev)[:n_along]  # endpoint excluded
    s = torch.linspace(-1.0, 1.0, n_across, device=dev)
    tt = t[None, None, :, None, None]
    q = (p0[:, :, None, None, :] + seg[:, :, None, None, :] * tt
         + rib[:, :, None, None, :] * (w0[:, :, None, None, :] * (1.0 - tt) + w1[:, :, None, None, :] * tt)
         * s[None, None, None, :, None])
    px, py, z = project(cam, q.reshape(-1, 3), width, height)
    shape = (c, length - 1, n_along, n_across)
    px, py, z = px.reshape(shape), py.reshape(shape), z.reshape(shape)

    visible = (seg_ok[:, :, None, None] & (z > 1e-3) & (px >= 0) & (px < width - 1) & (py >= 0)
               & (py < height - 1))
    if depth is not None:
        visible = visible & (z <= _depth_at(depth, px, py, width, height))
    col = body_color(temp, mat, color1, color2)
    inten = torch.where(visible, (gain / (n_along * n_across)) * taper[None, :-1, None, None]
                        * radius[:, None, None, None], 0.0)
    rgb = col[:, None, None, None, :] * inten[..., None]
    x0 = torch.clamp(_round_i(px), 0, width - 1).reshape(-1)
    y0 = torch.clamp(_round_i(py), 0, height - 1).reshape(-1)
    return scatter_add(img_hdr, y0, x0, rgb.reshape(-1, 3))
