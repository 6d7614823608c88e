"""Particle pool: explosions and smoke trails (port of
`nbx/render/particles.py`).

The reference keeps a 5000-particle pool fed by fracture explosions (15
particles each, random directions, speed <= 8, life 1, decay 0.01-0.04) and
by hot bodies shedding smoke (chance min(0.1 + (T-50) 0.002, 1), velocity
0.1 body vel + jitter, life 0.8-1.2). Here it is a fixed [P] structure of
arrays: spawning writes into dead slots, update is one elementwise pass,
rendering reuses the point splat.

Randomness: where the JAX package carries a PRNG key, ParticleState carries
a torch.Generator, and each spawn takes its uniforms and normals from
`draws=` (`SmokeDraws`, `ExplosionDraws`) or, with draws=None, from the
generator (`draw_smoke`, `draw_explosions`). torch cannot reproduce
`jax.random`; the tests pass the JAX package's draws in.

Slots: a spawn takes the b dead slots of least life, lowest index first on
ties, as `lax.top_k(-life, b)` does (`splat.top_k_indices`: `torch.topk`
gives no tie order, so the slots come from a stable sort).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from nbx_torch.collisions_scaled import _set_at
from nbx_torch.config import CUDA
from nbx_torch.render.colormap import const

POOL_SIZE = 5000
PARTICLE_COLOR = np.array([1.0, 0.666, 0.266], np.float32)  # 0xffaa44
EXPLOSION_COUNT = 15
SMOKE_BASE_CHANCE = 0.1
SMOKE_TEMP_SLOPE = 0.002
GLOW_TEMP = 50.0


@dataclasses.dataclass(frozen=True)
class ParticleState:
    pos: torch.Tensor  # [P, 3]
    vel: torch.Tensor  # [P, 3]
    life: torch.Tensor  # [P], <= 0 means dead
    decay: torch.Tensor  # [P]
    generator: torch.Generator

    @staticmethod
    def create(pool: int = POOL_SIZE, seed: int = 0, device=CUDA) -> "ParticleState":
        from nbx_torch.state import make_generator

        f = dict(dtype=torch.float32, device=device)
        return ParticleState(pos=torch.zeros((pool, 3), **f), vel=torch.zeros((pool, 3), **f),
                             life=torch.zeros((pool,), **f), decay=torch.zeros((pool,), **f),
                             generator=make_generator(device, seed))

    @property
    def n_alive(self) -> torch.Tensor:
        return (self.life > 0).sum(dtype=torch.int32)

    def replace(self, **kw) -> "ParticleState":
        return dataclasses.replace(self, **kw)


class SmokeDraws(NamedTuple):
    """The draws of one spawn_smoke over C bodies into a pool of P, b =
    min(C, P): fire [C] uniform, offset [b, 3] normal, radius [b] uniform,
    jitter [b, 3] uniform, life [b] uniform (the JAX step's k1 ... k5)."""

    fire: torch.Tensor
    offset: torch.Tensor
    radius: torch.Tensor
    jitter: torch.Tensor
    life: torch.Tensor

    def to(self, device) -> "SmokeDraws":
        return SmokeDraws(*(x.to(device) for x in self))


class ExplosionDraws(NamedTuple):
    """The draws of one spawn_explosions of F events (n = 15 F particles):
    dirs [n, 3] normal, speed [n] uniform, decay [n] uniform (k1 ... k3)."""

    dirs: torch.Tensor
    speed: torch.Tensor
    decay: torch.Tensor

    def to(self, device) -> "ExplosionDraws":
        return ExplosionDraws(*(x.to(device) for x in self))


def draw_smoke(gen: torch.Generator, c: int, pool: int, device) -> SmokeDraws:
    b = min(c, pool)
    f = dict(dtype=torch.float32, device=device, generator=gen)
    return SmokeDraws(torch.rand((c,), **f), torch.randn((b, 3), **f), torch.rand((b,), **f),
                      torch.rand((b, 3), **f), torch.rand((b,), **f))


def draw_explosions(gen: torch.Generator, f: int, device) -> ExplosionDraws:
    n = f * EXPLOSION_COUNT
    kw = dict(dtype=torch.float32, device=device, generator=gen)
    return ExplosionDraws(torch.randn((n, 3), **kw), torch.rand((n,), **kw), torch.rand((n,), **kw))


def update(p: ParticleState, dt: float) -> ParticleState:
    """Life decrement and Euler drift. Dead particles stay with life <= 0
    (the splat masks them)."""
    return p.replace(pos=p.pos + p.vel * dt, life=torch.clamp(p.life - p.decay, min=0.0))


def free_slots(life: torch.Tensor, b: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(slots, their life) of the b least-life slots, ties lowest index first:
    `lax.top_k(-life, b)` of the JAX package (`splat.top_k_indices`)."""
    from nbx_torch.render.splat import top_k_indices

    order = top_k_indices(-life, b)
    return order, life[order]


def _spawn(p: ParticleState, new_pos, new_vel, new_life, new_decay, mask) -> ParticleState:
    """Write spawned particles into dead slots, least life first."""
    pool = p.life.shape[0]
    b = min(mask.shape[0], pool)  # spawns beyond the pool size are dropped
    new_pos, new_vel = new_pos[:b], new_vel[:b]
    new_life, new_decay, mask = new_life[:b], new_decay[:b], mask[:b]
    slots, life = free_slots(p.life, b)
    ok = mask & (life <= 0.0)  # only overwrite dead slots
    slots = torch.where(ok, slots, pool)  # index `pool` drops
    return p.replace(pos=_set_at(p.pos, slots, new_pos), vel=_set_at(p.vel, slots, new_vel),
                     life=_set_at(p.life, slots, new_life), decay=_set_at(p.decay, slots, new_decay))


def spawn_explosions(p: ParticleState, centers, mask, draws: Optional[ExplosionDraws] = None) -> ParticleState:
    """15 particles an event: random directions, speed <= 8, life 1, decay
    0.01-0.04. `draws`: the uniforms and normals, else from p.generator."""
    f = mask.shape[0]
    n = f * EXPLOSION_COUNT
    if draws is None:
        draws = draw_explosions(p.generator, f, p.life.device)
    dirs = draws.dirs / torch.linalg.vector_norm(draws.dirs, dim=1, keepdim=True)
    speed = draws.speed * 8.0
    decay = 0.01 + draws.decay * 0.03
    pos = torch.repeat_interleave(centers, EXPLOSION_COUNT, dim=0)
    m = torch.repeat_interleave(mask, EXPLOSION_COUNT)
    return _spawn(p, pos, dirs * speed[:, None], torch.ones(n, device=centers.device), decay, m)


def spawn_smoke(p: ParticleState, body_pos, body_vel, radius, temp, alive,
                draws: Optional[SmokeDraws] = None) -> ParticleState:
    """Smoke for hot bodies: chance min(0.1 + (T-50) 0.002, 1) a body a frame;
    one particle at a random offset inside the radius, vel = 0.1 body vel +
    jitter(+-0.25), life 0.8-1.2, decay 0.03. The first b firing bodies are
    extracted before the geometry draws (as in the JAX package)."""
    from nbx_torch.ops.p3m import take_rows

    c = alive.shape[0]
    b = min(c, p.life.shape[0])
    if draws is None:
        draws = draw_smoke(p.generator, c, p.life.shape[0], p.life.device)
    chance = torch.clamp(SMOKE_BASE_CHANCE + (temp - GLOW_TEMP) * SMOKE_TEMP_SLOPE, max=1.0)
    hot = alive & (temp > GLOW_TEMP)
    fire = hot & (draws.fire < chance)
    idx, valid = take_rows(fire, b)
    idx = idx.long()
    offset = draws.offset / torch.linalg.vector_norm(draws.offset, dim=1, keepdim=True)
    offset = offset * (radius[idx] * draws.radius)[:, None]
    jitter = (draws.jitter - 0.5) * 0.5
    life = 0.8 + draws.life * 0.4
    return _spawn(p, body_pos[idx] + offset, body_vel[idx] * 0.1 + jitter, life,
                  torch.full((b,), 0.03, device=body_pos.device), valid)


def splat_particles(img_hdr, p: ParticleState, cam, width: int = 640, height: int = 360, gain: float = 0.5,
                    depth=None) -> torch.Tensor:
    """Additive point splat of live particles (size 1.2, colour 0xffaa44 in
    the reference). `depth` [H, W] hides particles behind impostor surfaces."""
    from nbx_torch.render.splat import _depth_at, _round_i, project, scatter_add

    px, py, z = project(cam, p.pos, width, height)
    visible = (p.life > 0) & (z > 1e-3) & (px >= 0) & (px < width - 1) & (py >= 0) & (py < height - 1)
    if depth is not None:
        visible = visible & (z <= _depth_at(depth, px, py, width, height))
    inten = torch.where(visible, gain * p.life, 0.0)
    rgb = const(PARTICLE_COLOR, img_hdr)[None, :] * inten[:, None]
    x0 = torch.clamp(_round_i(px), 0, width - 1)
    y0 = torch.clamp(_round_i(py), 0, height - 1)
    return scatter_add(img_hdr, y0, x0, rgb)
