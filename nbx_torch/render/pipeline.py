"""Full frame pipeline: bodies, trails, particles and flash lights (port of
`nbx/render/pipeline.py`).

The composition order of the reference frame (everything additive, then
bloom and tonemap):

    HDR = impostors + splat(bodies) + stars + trails + particles + lights
    frame = tonemap(bloom(HDR))

`FrameState` carries the renderer's state on the device (the trail ring
buffer, the particle pool and its generator, the light pool).
`render_and_advance` consumes one frame step's output (state and events) and
returns (new FrameState, frame); `render_granular` does the same for the
at-scale state. Neither reads anything back to the host.

Randomness: the particle spawns draw from the FrameState's generator unless
`draws=` passes a `FrameDraws` (the tests pass the JAX package's).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from nbx_torch.config import CUDA
from nbx_torch.render import lights as lights_mod
from nbx_torch.render import particles as particles_mod
from nbx_torch.render import trails as trails_mod
from nbx_torch.render.bloom import bloom
from nbx_torch.render.colormap import tonemap
from nbx_torch.render.impostor import draw_impostors
from nbx_torch.render.splat import Camera, _depth_at, _round_i, project, scatter_add, splat_bodies_hdr


@dataclasses.dataclass(frozen=True)
class FrameState:
    trails: trails_mod.TrailState
    particles: particles_mod.ParticleState
    lights: lights_mod.LightState

    @staticmethod
    def create(capacity: int, trail_length: int = 80, pool: int = particles_mod.POOL_SIZE, seed: int = 0,
               device=CUDA) -> "FrameState":
        return FrameState(trails=trails_mod.TrailState.create(capacity, trail_length, device),
                          particles=particles_mod.ParticleState.create(pool, seed, device),
                          lights=lights_mod.LightState.create(device=device))


class FrameDraws(NamedTuple):
    """A frame's particle draws: the smoke spawn's, then the explosions'."""

    smoke: particles_mod.SmokeDraws
    explosions: particles_mod.ExplosionDraws


N_STARS = 3000  # the reference's starfield


def starfield_directions(generator: Optional[torch.Generator] = None, n: int = N_STARS,
                         device=CUDA) -> torch.Tensor:
    """Unit directions of the background stars (at infinity only direction
    matters). The JAX package draws them from PRNGKey(7); here from
    `generator` (default: a generator seeded with 7 on `device`)."""
    if generator is None:
        from nbx_torch.state import make_generator

        generator = make_generator(device, 7)
    v = torch.randn((n, 3), dtype=torch.float32, device=generator.device, generator=generator)
    return v / torch.linalg.vector_norm(v, dim=1, keepdim=True)


def splat_starfield(img_hdr, dirs, cam: Camera, width: int = 640, height: int = 360, gain: float = 0.22,
                    depth=None) -> torch.Tensor:
    """Additive dim star points at infinity (occluded by impostor discs when
    a `depth` buffer is passed: stars sit at z ~ 1e6)."""
    pos = cam.eye[None, :] + dirs * 1e6
    px, py, z = project(cam, pos, width, height)
    vis = (z > 0) & (px >= 0) & (px < width - 1) & (py >= 0) & (py < height - 1)
    x0 = torch.clamp(_round_i(px), 0, width - 1)
    y0 = torch.clamp(_round_i(py), 0, height - 1)
    if depth is not None:
        vis = vis & (z <= _depth_at(depth, px, py, width, height))
    inten = torch.where(vis, gain, 0.0)
    return scatter_add(img_hdr, y0, x0, inten[:, None].expand(-1, 3))


def _flat(x: torch.Tensor, stacked: bool) -> torch.Tensor:
    return x.reshape((-1,) + tuple(x.shape[2:])) if stacked else x


def _compose(frame: FrameState, pos, vel, radius, temp, mat, alive, cfg, events, cam, trail_idx, width, height,
             exposure, use_bloom, stars, bloom_strength, bloom_threshold, n_impostors, draws):
    """The pass order both entry points share. trail_idx: the body slots
    that get ribbon trails (None: every body)."""
    c1, c2 = cfg.materials.color1, cfg.materials.color2
    if trail_idx is None:
        t_pos, t_alive, t_rad, t_temp, t_mat = pos, alive, radius, temp, mat
    else:
        t_pos, t_alive, t_rad, t_temp, t_mat = (x[trail_idx] for x in (pos, alive, radius, temp, mat))
    trails = trails_mod.update(frame.trails, t_pos, t_alive)
    parts = particles_mod.update(frame.particles, cfg.dt)
    parts = particles_mod.spawn_smoke(parts, pos, vel, radius, temp, alive,
                                      None if draws is None else draws.smoke)

    # substep-stacked events ([S, M, 3] merge_pos) are flattened
    stacked = events.merge_pos.dim() == 3
    parts = particles_mod.spawn_explosions(parts, _flat(events.spawn_pos, stacked), _flat(events.spawn_mask, stacked),
                                           None if draws is None else draws.explosions)
    flash_pos = torch.cat([_flat(events.merge_pos, stacked), _flat(events.fracture_pos, stacked)])
    flash_e = torch.cat([0.5 * _flat(events.merge_mass, stacked), _flat(events.fracture_energy, stacked)])
    flash_mask = torch.cat([_flat(events.merge_mask, stacked), _flat(events.fracture_mask, stacked)])
    lights = lights_mod.advance(frame.lights, flash_pos, flash_e, flash_mask)
    light_gain = lights_mod.body_light_gain(lights, pos)

    # impostors draw first and hand their z-buffer to every additive pass
    depth = imp = None
    if n_impostors > 0:
        imp, depth = draw_impostors(
            torch.zeros((height, width, 3), dtype=torch.float32, device=pos.device), pos, radius, temp, mat, alive,
            c1, c2, cam, frame.trails.head.to(torch.float32) * cfg.dt, width=width, height=height,
            n_impostors=n_impostors, light_gain=light_gain)
    hdr = splat_bodies_hdr(pos, radius, temp, mat, alive, c1, c2, cam, width=width, height=height, depth=depth,
                           light_gain=light_gain)
    if imp is not None:
        hdr = hdr + imp
    if stars is not None:
        hdr = splat_starfield(hdr, stars, cam, width=width, height=height, depth=depth)
    hdr = trails_mod.splat_trails(hdr, trails, t_rad, t_temp, t_mat, c1, c2, cam, width=width, height=height,
                                  depth=depth)
    hdr = particles_mod.splat_particles(hdr, parts, cam, width=width, height=height, depth=depth)
    hdr = lights_mod.splat_light_glow(hdr, lights, cam, width=width, height=height, depth=depth)
    if use_bloom:
        hdr = bloom(hdr, bloom_strength, bloom_threshold)
    return FrameState(trails=trails, particles=parts, lights=lights), tonemap(hdr, exposure)


def render_granular(frame: FrameState, st, cfg, events, cam: Camera, trail_idx: torch.Tensor, width: int = 640,
                    height: int = 360, exposure: float = 1.5, use_bloom: bool = True, stars=None,
                    bloom_strength: float = 1.2, bloom_threshold: float = 0.3, n_impostors: int = 64,
                    draws: Optional[FrameDraws] = None):
    """render_and_advance for the at-scale state (GranularState and
    ScaledEvents): the same passes, with ribbon trails only for the
    `trail_idx` body slots (frame.trails' capacity is trail_idx's length):
    an 80-point history for each of 1M bodies would be a ~1 GB ring buffer
    for sub-pixel ribbons. Splats, impostors, smoke, explosions and lights
    still run over every body and event."""
    from nbx_torch.config import body_radius

    radius = body_radius(st.mass, st.mat, cfg.materials)
    alive = st.mass > 0.0
    return _compose(frame, st.pos, st.vel, radius, st.temp, st.mat, alive, cfg, events, cam, trail_idx.long(),
                    width, height, exposure, use_bloom, stars, bloom_strength, bloom_threshold, n_impostors, draws)


def render_and_advance(frame: FrameState, state, cfg, events, cam: Camera, width: int = 640, height: int = 360,
                       exposure: float = 1.5, use_bloom: bool = True, stars=None, bloom_strength: float = 1.2,
                       bloom_threshold: float = 0.3, n_impostors: int = 64,
                       draws: Optional[FrameDraws] = None):
    """One rendered frame and the advanced renderer state. `events`: a
    single substep's Events or a substep-stacked one (leaves [S, ...]).
    `stars`: starfield_directions() for the background field.
    n_impostors > 0 shades that many nearest bodies with the per-pixel
    planet pass; 0 disables it. `draws`: the frame's particle draws (None:
    from frame.particles.generator)."""
    return _compose(frame, state.pos, state.vel, state.radius(cfg), state.temp, state.mat, state.alive, cfg,
                    events, cam, None, width, height, exposure, use_bloom, stars, bloom_strength,
                    bloom_threshold, n_impostors, draws)
