"""Frozen copies of the scene generators the benchmark's configurations use.

The benchmark makes its inputs itself and hands the same arrays to the
program and to the reference, so the yardstick does not move when the
program's own generators change. Each function is the recipe of
`nbx_torch.scene` as it stood when the benchmark was defined, in NumPy, with
the same draws in the same order: the same seed gives the same bits.

Scene dict: {pos [N, 3] f32, vel [N, 3] f32, mass [N] f32, mat [N] i32,
temp [N] f32}.
"""

from __future__ import annotations

import numpy as np

ROCK = 0  # material codes of the reference simulator


def _scene(pos, vel, mass) -> dict:
    n = len(mass)
    return dict(
        pos=np.asarray(pos, np.float32).reshape(n, 3),
        vel=np.asarray(vel, np.float32).reshape(n, 3),
        mass=np.asarray(mass, np.float32),
        mat=np.full(n, ROCK, np.int32),
        temp=np.zeros(n, np.float32),
    )


def cold_collapse_disk(n: int, radius: float = 100.0, total_mass: float = 1000.0, seed: int = 0) -> dict:
    """A cold (zero-velocity) uniform disk of equal masses: radius
    ~ R sqrt(U), angle ~ U(0, 2 pi), height ~ U(-1, 1). BASELINE config 4's
    throughput scene."""
    rng = np.random.default_rng(seed)
    r = radius * np.sqrt(rng.uniform(0, 1, n))
    th = rng.uniform(0, 2 * np.pi, n)
    pos = np.stack([r * np.cos(th), rng.uniform(-1, 1, n), r * np.sin(th)], axis=1)
    return _scene(pos=pos, vel=np.zeros((n, 3)), mass=np.full(n, total_mass / n))


def galaxy_merger(n: int, G: float = 0.5, separation: float = 300.0, approach_speed: float = 0.5,
                  seed: int = 0) -> dict:
    """Two disk galaxies on a collision course, each the reference simulator's
    startup galaxy scaled up: a heavy core (mass n_disk / 150 x 500) and a
    cold disk on circular orbits (distance 30 + U(0, 60) sqrt(n_disk / 150),
    height U(-1, 1), speed sqrt(G core / distance), masses U(0.5, 2.5)),
    `separation` apart along x and approaching at `approach_speed` each.
    BASELINE config 5's scene."""
    n_half = n // 2

    def one_galaxy(n_disk, center, vel0, seed_off):
        r = np.random.default_rng(seed + seed_off)
        core_mass = n_disk / 150.0 * 500.0
        angle = r.uniform(0, 2 * np.pi, n_disk)
        dist = 30.0 + r.uniform(0, 60.0, n_disk) * np.sqrt(n_disk / 150.0)
        speed = np.sqrt(G * core_mass / dist)
        pos = np.stack([np.cos(angle) * dist, r.uniform(-1, 1, n_disk), np.sin(angle) * dist], axis=1) + center
        vel = np.stack([-np.sin(angle) * speed, np.zeros(n_disk), np.cos(angle) * speed], axis=1) + vel0
        mass = r.uniform(size=n_disk) * 2.0 + 0.5
        return (np.concatenate([[center], pos]), np.concatenate([[vel0], vel]),
                np.concatenate([[core_mass], mass]))

    c = np.array([separation / 2, 0, 0])
    v = np.array([approach_speed, 0, 0])
    p1, v1, m1 = one_galaxy(n_half - 1, -c, +v, 1)
    p2, v2, m2 = one_galaxy(n - n_half - 1, +c, -v, 2)
    return _scene(pos=np.concatenate([p1, p2]), vel=np.concatenate([v1, v2]), mass=np.concatenate([m1, m2]))
