"""Per-pixel sphere impostors, the planet surface shader (port of
`nbx/render/impostor.py`).

The reference's fragment shader: 3-D simplex noise (two octaves with a
per-body seed, 0.6 / 0.4), colour mix smoothstep(-0.2, 0.5, detail), a
noise-perturbed Lambertian sun term, a Fresnel rim pow(1 - V.N, 3) color1
0.5, magma glow in the noise cracks for hot bodies, a whole-body glow above
T = 50, ambient 0.05, and spin about +y at 0.2 rad/s.

Every pixel z-tests the K largest on-screen discs, in chunks of 32 so the
live [H, W, chunk] block stays bounded; the nearest covering body wins and
one elementwise pass shades each pixel with its parameters. The K picks are
`lax.top_k`'s: the K largest projected radii, lowest index first on ties
(`splat.top_k_indices`, a stable sort; `torch.topk` gives no tie order).

The noise follows the JAX package's float32 operations in their order:
simplex noise's lattice arithmetic (`_mod289`, `_permute`) is exact in
float32, and its outputs agree with the JAX package's to float32 rounding.
`value_noise3`'s hash, fract(sin(d) 43758.5453), turns one ulp of a sine
(torch's and XLA's differ on about one value in twenty) into about 3e-3 of
the hash; it is the study variant and no frame uses it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

SUN_POSITION = np.array([50.0, 50.0, 50.0], np.float32)
AMBIENT = 0.05
SPIN_RATE = 0.2  # rad/s about +y
HEAT_COLOR = np.array([1.0, 0.3, 0.1], np.float32)
BODY_GLOW_COLOR = np.array([1.0, 0.5, 0.2], np.float32)
CHUNK = 32  # discs tested a pass


def _hash3(ix, iy, iz, seed):
    """Lattice hash -> [0, 1): fract(sin(dot(p, k)) * big)."""
    d = ix * 12.9898 + iy * 78.233 + iz * 37.719 + seed * 0.618
    return torch.remainder(torch.sin(d) * 43758.5453, 1.0)


def _smooth(t):
    return t * t * (3.0 - 2.0 * t)


def value_noise3(p: torch.Tensor, seed) -> torch.Tensor:
    """3-D value noise in [-1, 1]: hashed lattice corners, smoothstep-
    trilinear blend. p [..., 3]; seed broadcastable to p[..., 0]."""
    pf = torch.floor(p)
    f = _smooth(p - pf)
    ix, iy, iz = pf[..., 0], pf[..., 1], pf[..., 2]
    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]

    def corner(dx, dy, dz):
        return _hash3(ix + dx, iy + dy, iz + dz, seed)

    c000, c100 = corner(0, 0, 0), corner(1, 0, 0)
    c010, c110 = corner(0, 1, 0), corner(1, 1, 0)
    c001, c101 = corner(0, 0, 1), corner(1, 0, 1)
    c011, c111 = corner(0, 1, 1), corner(1, 1, 1)
    x00 = c000 + (c100 - c000) * fx
    x10 = c010 + (c110 - c010) * fx
    x01 = c001 + (c101 - c001) * fx
    x11 = c011 + (c111 - c011) * fx
    y0 = x00 + (x10 - x00) * fy
    y1 = x01 + (x11 - x01) * fy
    return 2.0 * (y0 + (y1 - y0) * fz) - 1.0


_F = np.float32


def _mod289(x):
    return x - torch.floor(x * float(_F(1.0 / 289.0))) * 289.0


def _permute(x):
    return _mod289(((x * 34.0) + 1.0) * x)


def simplex_noise3(v: torch.Tensor) -> torch.Tensor:
    """3-D simplex noise in [-1, 1], the Ashima/McEwan lattice algorithm the
    reference embeds: skew to the simplex lattice, rank the fractional
    coordinates, the permutation polynomial (34x + 1) x mod 289, gradients
    from a 7x7 lattice with Taylor inverse-sqrt normalisation, radial falloff
    (0.6 - r^2)^4. v: [..., 3] float32."""
    v = v.to(torch.float32)
    c_x, c_y = float(_F(1.0 / 6.0)), float(_F(1.0 / 3.0))
    s = (v[..., 0] + v[..., 1] + v[..., 2]) * c_y
    i = torch.floor(v + s[..., None])
    t = (i[..., 0] + i[..., 1] + i[..., 2]) * c_x
    x0 = v - i + t[..., None]

    x0x, x0y, x0z = x0[..., 0], x0[..., 1], x0[..., 2]
    gx = (x0x >= x0y).to(torch.float32)
    gy = (x0y >= x0z).to(torch.float32)
    gz = (x0z >= x0x).to(torch.float32)
    i1 = torch.stack([torch.minimum(gx, 1.0 - gz), torch.minimum(gy, 1.0 - gx), torch.minimum(gz, 1.0 - gy)], -1)
    i2 = torch.stack([torch.maximum(gx, 1.0 - gz), torch.maximum(gy, 1.0 - gx), torch.maximum(gz, 1.0 - gy)], -1)
    x1 = x0 - i1 + c_x
    x2 = x0 - i2 + float(_F(2.0) * _F(c_x))
    x3 = x0 - 0.5

    i = _mod289(i)
    iz, iy, ix = i[..., 2], i[..., 1], i[..., 0]
    zero, one = torch.zeros_like(iz), torch.ones_like(iz)
    oz = torch.stack([zero, i1[..., 2], i2[..., 2], one], -1)
    oy = torch.stack([zero, i1[..., 1], i2[..., 1], one], -1)
    ox = torch.stack([zero, i1[..., 0], i2[..., 0], one], -1)
    p = _permute(_permute(_permute(iz[..., None] + oz) + iy[..., None] + oy) + ix[..., None] + ox)

    one7 = _F(1.0 / 7.0)
    j = p - 49.0 * torch.floor(p * float(one7 * one7))
    gx4 = torch.floor(j * float(one7))
    gy4 = torch.floor(j - 7.0 * gx4)
    gx4 = gx4 * float(_F(2.0) * one7) + float(one7 * _F(0.5) - _F(1.0))
    gy4 = gy4 * float(_F(2.0) * one7) + float(one7 * _F(0.5) - _F(1.0))
    gz4 = 1.0 - gx4.abs() - gy4.abs()
    sh = -(gz4 <= 0.0).to(torch.float32)
    gx4 = gx4 + (torch.floor(gx4) * 2.0 + 1.0) * sh
    gy4 = gy4 + (torch.floor(gy4) * 2.0 + 1.0) * sh

    xs = torch.stack([x0x, x1[..., 0], x2[..., 0], x3[..., 0]], -1)
    ys = torch.stack([x0y, x1[..., 1], x2[..., 1], x3[..., 1]], -1)
    zs = torch.stack([x0z, x1[..., 2], x2[..., 2], x3[..., 2]], -1)
    norm = 1.79284291400159 - 0.85373472095314 * (gx4 * gx4 + gy4 * gy4 + gz4 * gz4)
    dot4 = (gx4 * xs + gy4 * ys + gz4 * zs) * norm
    m = torch.clamp(0.6 - (xs * xs + ys * ys + zs * zs), min=0.0)
    m = m * m
    return 42.0 * (m * m * dot4).sum(-1)


def surface_detail(p_obj: torch.Tensor, seed):
    """Two octaves: n1 = snoise(p 0.5 + seed), n2 = snoise(p 2 + 2 seed),
    detail = 0.6 n1 + 0.4 n2; the seed enters as a position offset, as in
    the reference. Returns (detail, n2): n2 also drives the crack mask."""
    seed = torch.as_tensor(seed, dtype=torch.float32, device=p_obj.device)[..., None]
    n1 = simplex_noise3(p_obj * 0.5 + seed)
    n2 = simplex_noise3(p_obj * 2.0 + seed * 2.0)
    return n1 * 0.6 + n2 * 0.4, n2


def _smoothstep(e0, e1, x):
    t = torch.clamp((x - e0) / (e1 - e0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def impostor_focal(cam, height: int) -> float:
    """0.5 height / tan(0.5 fov) in float32, the impostor pass's order."""
    half = _F(0.5) * _F(_F(cam.fov_deg) * _F(math.pi / 180.0))
    return float(_F(0.5 * height) / np.tan(half))


def select_impostors(score: torch.Tensor, k: int) -> torch.Tensor:
    """The k largest scores, ties lowest index first (`lax.top_k`)."""
    from nbx_torch.render.splat import top_k_indices

    return top_k_indices(score, k)


def draw_impostors(img_hdr, pos, radius, temp, mat, alive, color1, color2, cam, time, width: int = 640,
                   height: int = 360, n_impostors: int = 8, light_gain=None):
    """Shade the n_impostors largest on-screen bodies as lit spheres.

    Every pixel tests the K selected discs, the nearest covering body wins,
    and the surface model shades that pixel once with its parameters;
    covered pixels replace the HDR value (bodies are opaque). `time`
    (seconds; a Python float or a 0-d tensor) drives the spin.

    Returns (img, depth): depth [H, W] is the winner's front-surface view
    depth (centre z - radius / 2), +inf where uncovered: the z-buffer the
    additive passes test against."""
    from nbx_torch.render.colormap import const
    from nbx_torch.render.splat import _look_at, project

    dev = pos.device
    px, py, z = project(cam, pos, width, height)
    focal = impostor_focal(cam, height)
    pr = radius * focal / torch.where(z > 1e-3, z, 1.0)
    on_screen = alive & (z > 1e-3) & (px > -pr) & (px < width + pr) & (py > -pr) & (py < height + pr)
    score = torch.where(on_screen, pr, -1.0)
    score_p = torch.cat([score, torch.full((n_impostors,), -1.0, device=dev)])
    sel = select_impostors(score_p, n_impostors)
    valid = score_p[sel] > 1.0  # skip sub-pixel and off-screen picks
    sel = torch.clamp(sel, max=pos.shape[0] - 1)

    xs = torch.arange(width, dtype=torch.float32, device=dev)[None, :]
    ys = torch.arange(height, dtype=torch.float32, device=dev)[:, None]
    chunk = min(CHUNK, n_impostors)
    zmin = torch.full((height, width), math.inf, dtype=torch.float32, device=dev)
    win_body = torch.zeros((height, width), dtype=torch.int64, device=dev)
    for c0 in range(0, n_impostors, chunk):
        sl = sel[c0:c0 + chunk]
        safe_pr = torch.clamp(pr[sl], min=1e-3)
        ox_k = (xs[..., None] - px[sl]) / safe_pr
        oy_k = (ys[..., None] - py[sl]) / safe_pr
        d2_k = ox_k * ox_k + oy_k * oy_k
        inside_k = (d2_k < 1.0) & valid[c0:c0 + chunk] & (z[sl] > 1e-3)
        zbuf = torch.where(inside_k, z[sl], math.inf)
        zc, wc = torch.min(zbuf, dim=-1)
        better = zc < zmin  # strict: z ties keep the earlier (higher-score) pick
        zmin = torch.where(better, zc, zmin)
        win_body = torch.where(better, sl[wc], win_body)
    covered = torch.isfinite(zmin)

    body = win_body
    b_pr = torch.clamp(pr[body], min=1e-3)
    ox = (xs - px[body]) / b_pr
    oy = (ys - py[body]) / b_pr
    d2 = ox * ox + oy * oy
    b_pos = pos[body]
    b_rad = radius[body]
    b_temp = temp[body]
    b_mat = mat[body].long()
    seed = body.to(torch.float32) * 19.19  # deterministic per-slot seed

    right, up, fwd = _look_at(cam)
    nz = torch.sqrt(torch.clamp(1.0 - d2, min=0.0))
    n_world = ox[..., None] * right - oy[..., None] * up - nz[..., None] * fwd
    p_surf = b_pos + n_world * b_rad[..., None]

    # spin about +y: rotate the object-space sample point
    ang = SPIN_RATE * torch.as_tensor(time, dtype=torch.float32, device=dev)
    ca, sa = torch.cos(ang), torch.sin(ang)
    n_spun = torch.stack([ca * n_world[..., 0] + sa * n_world[..., 2], n_world[..., 1],
                          -sa * n_world[..., 0] + ca * n_world[..., 2]], dim=-1)
    p_obj = n_spun * 3.0
    detail, n2 = surface_detail(p_obj, seed)
    n_pert = n_world + 0.1 * detail[..., None]
    n_pert = n_pert / torch.linalg.vector_norm(n_pert, dim=-1, keepdim=True)

    c1 = color1[b_mat]
    c2 = color2[b_mat]
    base = c2 + (c1 - c2) * _smoothstep(-0.2, 0.5, detail)[..., None]

    sun_dir = const(SUN_POSITION, pos) - p_surf
    sun_dir = sun_dir / torch.linalg.vector_norm(sun_dir, dim=-1, keepdim=True)
    lambert = torch.clamp((n_pert * sun_dir).sum(-1), min=0.0)

    view = cam.eye - p_surf
    view = view / torch.linalg.vector_norm(view, dim=-1, keepdim=True)
    fresnel = torch.clamp(1.0 - (view * n_pert).sum(-1), min=0.0) ** 3

    t_norm = torch.clamp(b_temp / 50.0, 0.0, 1.0)
    crack = _smoothstep(0.4, 0.6, n2.abs())
    heat = (1.0 - crack) * t_norm * 5.0
    glow_body = torch.clamp(b_temp - 50.0, min=0.0) * 0.005

    rgb = (base * (AMBIENT + lambert[..., None]) + fresnel[..., None] * c1 * 0.5
           + const(HEAT_COLOR, pos) * heat[..., None] + const(BODY_GLOW_COLOR, pos) * glow_body[..., None])
    if light_gain is not None:  # incident flash light: warm albedo-reflected add
        from nbx_torch.render.lights import COLOR

        rgb = rgb + base * light_gain[body][..., None] * const(COLOR, pos)

    depth = torch.where(covered, zmin - 0.5 * b_rad, math.inf)
    img = torch.where(covered[..., None], rgb.to(img_hdr.dtype), img_hdr)
    return img, depth
