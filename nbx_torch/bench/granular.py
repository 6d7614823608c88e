"""Scenes of the granular full-physics benchmark (the numpy builders of
`nbx/bench/granular.py`, copied): the uniform cloud that the at-scale live
server runs and the contact-rich debris disk."""

from __future__ import annotations

import numpy as np

BOX = 100.0


def debris_disk(n: int, seed: int = 0):
    """Annular debris disk, contact-rich; slot 0 is the demo's central body,
    parked dead (mass 0).

    Masses scale as 32768/n beyond the demo's N so the total body volume
    stays about the annulus volume."""
    rng = np.random.default_rng(seed)
    r = rng.uniform(8.0, 28.0, n)
    th = rng.uniform(0, 2 * np.pi, n)
    pos = np.stack(
        [50 + r * np.cos(th), 50 + rng.normal(0, 0.4, n), 50 + r * np.sin(th)],
        axis=1,
    ).astype(np.float32)
    mass = (rng.uniform(0.05, 0.4, n) * min(1.0, 32768 / n)).astype(np.float32)
    v = np.sqrt(0.5 * 2000.0 / r)
    vel = np.stack([-v * np.sin(th), np.zeros(n), v * np.cos(th)], axis=1).astype(np.float32)
    pos = np.concatenate([[[50.0, 50.0, 50.0]], pos]).astype(np.float32)
    vel = np.concatenate([[[0.0, 0.0, 0.0]], vel]).astype(np.float32)
    mass = np.concatenate([[0.0], mass]).astype(np.float32)
    return pos, vel, mass


def granular_cloud(n: int, seed: int = 0, box: float = BOX):
    """Uniform cloud in [0.1 box, 0.9 box)^3 with converging velocity
    jitter: near-uniform cell occupancy, contacts fire."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.1 * box, 0.9 * box, (n, 3)).astype(np.float32)
    vel = ((0.5 * box - pos) * 0.02 + rng.normal(0, 0.3, (n, 3))).astype(np.float32)
    mass = rng.uniform(0.05, 0.4, n).astype(np.float32)
    return pos, vel, mass
