"""Point-splat renderer (port of `nbx/render/splat.py`).

Project every body with a pinhole camera, scatter-add its footprint into an
HDR framebuffer, add event flashes as Gaussian blobs, tonemap. Footprints
come in three tiers, as in the JAX package: a 2x2 bilinear splat over all N
bodies, a 5x5 Gaussian over the first `_MID_SPLATS` bodies wider than 0.75
px, an 11x11 Gaussian over the first `_BIG_SPLATS` wider than 2 px.

The JAX package scatters with `.at[...].add(mode="drop")`, one scatter a tap.
Here every tap of a pass goes into one `index_add` (`scatter_add`), in the
JAX order of taps and rows, with out-of-range pixels masked to zero first
(`index_add` has no drop mode). On a CUDA tensor the accumulation uses
atomics, so a frame on the card differs from the CPU's by summation order.

The camera's tensors live on the device of the scene; its focal length is a
float32 host constant (`focal`), so nothing in a frame is read back.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from nbx_torch.config import CUDA
from nbx_torch.ops.p3m import take_rows
from nbx_torch.render.colormap import body_color, const, tonemap

_BIG_SPLATS = 512  # 11x11-tier capacity (index order, not size-ranked)
_MID_SPLATS = 8192  # 5x5-tier capacity

SUN_POS = np.array([50.0, 50.0, 50.0], np.float32)  # the reference's DirectionalLight site
FLASH_SIGMA = 12.0  # px, the flash blobs' and light glows' Gaussian
FLASH_COLOR = (1.0, 0.666, 0.0)  # 0xffaa00


def _vec(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32)).to(device)


@dataclasses.dataclass(frozen=True)
class Camera:
    """Pinhole look-at camera. Defaults echo the reference: eye (0, 80, 150)
    looking at the origin, 45-degree vertical FOV. eye, target, up are [3]
    float32 tensors on the scene's device; fov_deg a Python float."""

    eye: torch.Tensor
    target: torch.Tensor
    up: torch.Tensor
    fov_deg: float = 45.0

    @staticmethod
    def default(device=CUDA) -> "Camera":
        return Camera(eye=_vec([0.0, 80.0, 150.0], device), target=_vec([0.0, 0.0, 0.0], device),
                      up=_vec([0.0, 1.0, 0.0], device))

    @property
    def device(self) -> torch.device:
        return self.eye.device

    def pan(self, dx: float = 0.0, dy: float = 0.0) -> "Camera":
        """OrbitControls-style pan: translate eye AND target along the view
        plane's right/up axes, scaled by the orbit radius."""
        rel = self.eye - self.target
        r = torch.linalg.vector_norm(rel)
        fwd = -rel / r
        right = torch.linalg.cross(fwd, self.up)
        right = right / torch.linalg.vector_norm(right)
        up = torch.linalg.cross(right, fwd)
        shift = (right * dx + up * dy) * r
        return dataclasses.replace(self, eye=self.eye + shift, target=self.target + shift)

    def orbit(self, d_yaw: float = 0.0, d_pitch: float = 0.0, zoom: float = 1.0) -> "Camera":
        """OrbitControls-style rotate/zoom around the target."""
        rel = self.eye - self.target
        norm = torch.linalg.vector_norm(rel)
        r = norm * zoom
        yaw = torch.atan2(rel[0], rel[2]) + d_yaw
        pitch = torch.clamp(torch.asin(rel[1] / norm) + d_pitch, -1.45, 1.45)
        eye = self.target + r * torch.stack(
            [torch.cos(pitch) * torch.sin(yaw), torch.sin(pitch), torch.cos(pitch) * torch.cos(yaw)])
        return dataclasses.replace(self, eye=eye)


def _look_at(cam: Camera):
    fwd = cam.target - cam.eye
    fwd = fwd / torch.linalg.vector_norm(fwd)
    right = torch.linalg.cross(fwd, cam.up)
    right = right / torch.linalg.vector_norm(right)
    up = torch.linalg.cross(right, fwd)
    return right, up, fwd


def focal(cam: Camera, height: int) -> float:
    """(height / 2) / tan(fov / 2) in float32, as the JAX package computes it."""
    half = np.float32(np.float32(cam.fov_deg) * np.float32(math.pi / 180.0)) / np.float32(2.0)
    return float(np.float32(height / 2.0) / np.tan(half))


def project(cam: Camera, pos: torch.Tensor, width: int, height: int):
    """World [N, 3] -> (px, py, depth). Points behind the camera get
    depth <= 0 (callers mask them)."""
    right, up, fwd = _look_at(cam)
    rel = pos - cam.eye
    x = rel @ right
    y = rel @ up
    z = rel @ fwd
    f = focal(cam, height)
    safe_z = torch.where(z > 1e-6, z, 1.0)
    px = width / 2.0 + f * x / safe_z
    py = height / 2.0 - f * y / safe_z
    return px, py, z


def screen_to_plane(cam: Camera, sx, sy, width: int, height: int, plane_y: float = 0.0):
    """Unproject a screen pixel to the y = plane_y world plane (the
    reference's drag-to-spawn raycaster). Returns ([3] point, [] hit flag);
    no hit when the ray is parallel or points away from the plane."""
    right, up, fwd = _look_at(cam)
    f = focal(cam, height)
    d = fwd + (sx - width / 2.0) / f * right - (sy - height / 2.0) / f * up
    d = d / torch.linalg.vector_norm(d)
    denom = d[1]
    t = torch.where(denom.abs() > 1e-9, (plane_y - cam.eye[1]) / denom, -1.0)
    return cam.eye + t * d, t > 0


def scatter_add(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor, vals: torch.Tensor,
                inplace: bool = False) -> torch.Tensor:
    """img.at[ys, xs].add(vals, mode="drop") of the JAX package: rows whose
    pixel lies outside the image add nothing. `inplace` adds into `img`
    itself (for a buffer the caller made)."""
    h, w, c = img.shape
    ok = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
    idx = torch.where(ok, ys.long() * w + xs.long(), 0)
    vals = torch.where(ok[:, None], vals, 0.0)
    flat = img.view(h * w, c) if inplace else img.reshape(h * w, c)
    if inplace:
        flat.index_add_(0, idx, vals)
        return img
    return flat.index_add(0, idx, vals).view(h, w, c)


def top_k_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """`lax.top_k(x, k)`'s indices: the k largest of a float32 vector in XLA's
    total order (-0.0 below +0.0), ties lowest index first, by a stable sort
    of the order-preserving integer keys (`torch.topk` gives no tie order)."""
    bits = x.contiguous().view(torch.int32)
    key = bits ^ ((bits >> 31) & 0x7FFFFFFF)
    return torch.sort(key, descending=True, stable=True).indices[:k]


def _round_i(x: torch.Tensor) -> torch.Tensor:
    """jnp.round(x).astype(int32): half to even."""
    return torch.round(x).to(torch.int32)


def _depth_at(depth: torch.Tensor, px, py, width: int, height: int) -> torch.Tensor:
    """The z-buffer at each point's nearest pixel (clipped to the image)."""
    xc = torch.clamp(_round_i(px), 0, width - 1).long()
    yc = torch.clamp(_round_i(py), 0, height - 1).long()
    return depth[yc, xc]


def splat_bodies_hdr(pos, radius, temp, mat, alive, color1, color2, cam: Camera, width: int = 640,
                     height: int = 360, depth=None, light_gain=None) -> torch.Tensor:
    """Body splats into a fresh HDR buffer (no tonemap), the composition
    primitive of the frame pipeline. `depth` [H, W] (from draw_impostors)
    hides splats behind opaque impostor surfaces; `light_gain` [N] adds
    flash-light illumination (`render.lights`)."""
    return _splat_bodies(pos, radius, temp, mat, alive, color1, color2, cam, width, height, depth, light_gain)


def splat_frame(pos, radius, temp, mat, alive, color1, color2, cam: Camera, width: int = 640,
                height: int = 360, exposure: float = 1.0) -> torch.Tensor:
    """One HDR -> tonemapped frame, [H, W, 3] float32 in [0, 1]: each body
    splats its emissive colour with intensity ~ apparent area."""
    img = _splat_bodies(pos, radius, temp, mat, alive, color1, color2, cam, width, height)
    return tonemap(img, exposure)


def _splat_bodies(pos, radius, temp, mat, alive, color1, color2, cam, width, height, depth=None,
                  light_gain=None) -> torch.Tensor:
    px, py, z = project(cam, pos, width, height)
    visible = alive & (z > 1e-3) & (px >= 0) & (px < width - 1) & (py >= 0) & (py < height - 1)
    if depth is not None:  # z-test against opaque impostor surfaces
        visible = visible & (z <= _depth_at(depth, px, py, width, height))
    col = body_color(temp, mat, color1, color2)
    # sun-phase shading: the lit fraction of a sphere facing the camera,
    # with the reference's 0.05 ambient floor; hot bodies are emissive
    to_sun = const(SUN_POS, pos)[None, :] - pos
    to_eye = cam.eye[None, :] - pos
    cosang = (to_sun * to_eye).sum(1) * torch.rsqrt(
        torch.clamp((to_sun**2).sum(1) * (to_eye**2).sum(1), min=1e-12))
    lit = 0.05 + 0.95 * 0.5 * (1.0 + cosang)
    emissive = torch.clamp(temp / 50.0, 0.0, 1.0)
    albedo = col
    col = col * torch.maximum(lit, emissive)[:, None]
    if light_gain is not None:  # incident flash light: warm reflected add
        col = col + albedo * light_gain[:, None] * const(FLASH_COLOR, pos)
    f = focal(cam, height)
    app = f * radius / torch.where(z > 1e-3, z, 1.0)  # apparent radius in px

    # the three footprint tiers (see the JAX module): index-order extraction
    # of the wide bodies into capped tiers, the rest 2x2 bilinear
    n = alive.shape[0]
    big = visible & (app > 2.0)
    idx_b, valid_b = take_rows(big, _BIG_SPLATS)
    idx_b = idx_b.long()
    in_big = big & (torch.cumsum(big.to(torch.int32), 0) - 1 < _BIG_SPLATS)
    mid = visible & ~in_big & (app > 0.75)
    m_cap = min(_MID_SPLATS, n)
    idx_m, valid_m = take_rows(mid, m_cap)
    idx_m = idx_m.long()
    in_mid = mid & (torch.cumsum(mid.to(torch.int32), 0) - 1 < m_cap)
    small = visible & ~in_big & ~in_mid
    inten_s = torch.where(small, torch.clamp(app * app, 0.3, 60.0), 0.0)
    rgb_s = col * inten_s[:, None]
    ys, xs, vals = [], [], []

    # small tier: 2x2 bilinear over all N
    xf = torch.clamp(px, 0.0, width - 1.001)
    yf = torch.clamp(py, 0.0, height - 1.001)
    x0 = torch.floor(xf).to(torch.int32)
    y0 = torch.floor(yf).to(torch.int32)
    fx = xf - x0
    fy = yf - y0
    for dy, dx, w in ((0, 0, (1.0 - fx) * (1.0 - fy)), (0, 1, fx * (1.0 - fy)), (1, 0, (1.0 - fx) * fy),
                      (1, 1, fx * fy)):
        ys.append(y0 + dy)
        xs.append(x0 + dx)
        vals.append(rgb_s * w[:, None])

    # mid tier: 5x5 Gaussian over the m_cap gathered rows
    pxm, pym, appm = px[idx_m], py[idx_m], app[idx_m]
    inten_m = torch.where(valid_m, torch.clamp(appm * appm, 0.3, 60.0), 0.0)
    rgb_m = col[idx_m] * inten_m[:, None]
    sigm = torch.clamp(appm * 0.6, 0.45, 2.2)
    x0m = torch.clamp(_round_i(pxm), 2, width - 3)
    y0m = torch.clamp(_round_i(pym), 2, height - 3)
    taps = []
    wsum = torch.zeros_like(pxm)
    for dy in range(-2, 3):
        for dx in range(-2, 3):
            d2 = ((x0m + dx) - pxm) ** 2 + ((y0m + dy) - pym) ** 2
            w = torch.exp(-d2 / (2.0 * sigm * sigm))
            taps.append((dy, dx, w))
            wsum = wsum + w
    inv_wsum = 1.0 / torch.where(wsum > 0, wsum, 1.0)
    for dy, dx, w in taps:
        ys.append(y0m + dy)
        xs.append(x0m + dx)
        vals.append(rgb_m * (w * inv_wsum)[:, None])

    # 11x11 tier: the gathered big bodies
    r_half = 5
    pxb, pyb, appb = px[idx_b], py[idx_b], app[idx_b]
    inten_b = torch.where(valid_b, torch.clamp(appb * appb, 0.3, 240.0), 0.0)
    rgbb = col[idx_b] * inten_b[:, None]
    sigb = torch.clamp(appb * 0.6, 1.2, 4.8)
    x0b = torch.clamp(_round_i(pxb), r_half, width - r_half - 1)
    y0b = torch.clamp(_round_i(pyb), r_half, height - r_half - 1)
    dr = torch.arange(-r_half, r_half + 1, dtype=torch.int32, device=pos.device)
    dxx = dr[None, None, :]
    dyy = dr[None, :, None]
    d2b = ((x0b[:, None, None] + dxx) - pxb[:, None, None]) ** 2 + ((y0b[:, None, None] + dyy) - pyb[:, None, None]) ** 2
    wb = torch.exp(-d2b / (2.0 * sigb * sigb)[:, None, None])
    wb = wb / torch.clamp(wb.sum(dim=(1, 2), keepdim=True), min=1e-9)
    tapshape = (idx_b.shape[0], 2 * r_half + 1, 2 * r_half + 1)
    yb = (y0b[:, None, None] + dyy).expand(tapshape).reshape(-1)
    xb = (x0b[:, None, None] + dxx).expand(tapshape).reshape(-1)
    vb = (rgbb[:, None, None, :] * wb[..., None]).reshape(-1, 3)
    if depth is not None:
        # per-tap z-test: the wide footprint must not bleed across an
        # occluding planet's disc edge
        zb = z[idx_b][:, None, None].expand(tapshape).reshape(-1)
        vb = torch.where((zb <= depth[yb.long(), xb.long()])[:, None], vb, 0.0)
    ys.append(yb)
    xs.append(xb)
    vals.append(vb)
    img = torch.zeros((height, width, 3), dtype=torch.float32, device=pos.device)
    return scatter_add(img, torch.cat(ys), torch.cat(xs), torch.cat(vals), inplace=True)


def gaussian_blobs(img_hdr: torch.Tensor, cx, cy, inten, z, color, depth=None) -> torch.Tensor:
    """img + sum over l of inten_l exp(-r_l^2 / (2 sigma^2)) * color for the
    blobs centred at (cx, cy) [L], masked where `depth` lies in front of z_l.
    The JAX package adds them one by one in a scan; the sum commutes, so
    here it is one batched pass of LIGHT_POOL blobs at a time (an [L, H, W]
    intermediate), equal up to float32 summation order."""
    from nbx_torch.render.lights import LIGHT_POOL

    h, w = img_hdr.shape[:2]
    dev = img_hdr.device
    ys = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
    col = const(color, img_hdr)
    for s in range(0, cx.shape[0], LIGHT_POOL):
        e = slice(s, s + LIGHT_POOL)
        g = inten[e, None, None] * torch.exp(
            -((xs - cx[e, None, None]) ** 2 + (ys - cy[e, None, None]) ** 2) / (2 * FLASH_SIGMA**2))
        if depth is not None:
            g = torch.where(z[e, None, None] <= depth[None], g, 0.0)
        img_hdr = img_hdr + g.sum(0)[:, :, None] * col
    return img_hdr


def add_flashes(img_hdr, flash_pos, flash_energy, flash_mask, cam: Camera, width: int = 640, height: int = 360,
                depth=None) -> torch.Tensor:
    """Additive Gaussian flash blobs, the splat analogue of the reference's
    transient flash light (intensity min(0.2 E, 15), colour 0xffaa00). With
    `depth`, pixels whose opaque surface is in front of the flash are
    masked."""
    px, py, z = project(cam, flash_pos, width, height)
    inten = torch.where(flash_mask & (z > 1e-3), torch.clamp(0.2 * flash_energy, max=15.0), 0.0)
    return gaussian_blobs(img_hdr, px, py, inten, z, FLASH_COLOR, depth)


def render_state(state, cfg, cam: Camera | None = None, **kw) -> torch.Tensor:
    """Render a SimState with its material table."""
    cam = cam or Camera.default(state.device)
    return splat_frame(state.pos, state.radius(cfg), state.temp, state.mat, state.alive,
                       cfg.materials.color1, cfg.materials.color2, cam, **kw)
