"""Scenario generators (port of `nbx/scene.py`).

The builders below are host-side NumPy, copied verbatim from the JAX package
(whose module imports jax, so it cannot be reused here): the same seed gives
the same arrays. Only `make_state`, which loads a scene into a SimState, is
ported.

Scene dict convention: {pos [N,3] f32, vel [N,3] f32, mass [N] f32,
mat [N] i32, temp [N] f32}.
"""

from __future__ import annotations

import numpy as np
import torch

from nbx_torch.config import CUDA, ICE, METAL, ROCK, SimConfig
from nbx_torch.state import SimState, empty_state

Scene = dict


def _scene(pos, vel, mass, mat=None, temp=None) -> Scene:
    n = len(mass)
    return dict(
        pos=np.asarray(pos, np.float32).reshape(n, 3),
        vel=np.asarray(vel, np.float32).reshape(n, 3),
        mass=np.asarray(mass, np.float32),
        mat=np.full(n, ROCK, np.int32) if mat is None else np.asarray(mat, np.int32),
        temp=np.zeros(n, np.float32) if temp is None else np.asarray(temp, np.float32),
    )


def make_state(cfg: SimConfig, scene: Scene, device=CUDA, seed: int = 0) -> SimState:
    """Load a scene into a fresh SimState on `device` (scenario reset =
    clear + re-add), the card unless the caller asks for the CPU. `seed`
    seeds the fracture generator.

    On an empty state, n sequential add_body calls put body k in slot k with
    seq k and leave next_seq = n; this writes exactly that in one pass."""
    n = scene["mass"].shape[0]
    if n > cfg.capacity:
        raise ValueError(f"scene has {n} bodies > capacity {cfg.capacity}")
    state = empty_state(cfg, device, seed)

    def put(arr, value):
        value = torch.as_tensor(np.asarray(value), dtype=arr.dtype).to(device)
        return torch.cat([value, arr[n:]])

    return state.replace(
        pos=put(state.pos, scene["pos"]),
        vel=put(state.vel, scene["vel"]),
        mass=put(state.mass, scene["mass"]),
        temp=put(state.temp, scene["temp"]),
        mat=put(state.mat, scene["mat"]),
        alive=put(state.alive, np.ones(n, bool)),
        seq=put(state.seq, np.arange(n)),
        next_seq=torch.full((), n, dtype=torch.int32, device=device),
    )


def reference_galaxy(
    n_disk: int = 150, G: float = 0.5, seed: int = 0, center_mass: float = 500.0
) -> Scene:
    """The startup 'galaxy' scene (index.html:749-759): a hot metal core of
    mass 500 at the origin plus `n_disk` bodies on circular orbits —
    angle ~ U(0, 2pi), dist ~ U(30, 90), y ~ U(-1, 1), tangential speed
    sqrt(G * 500 / dist), mass ~ U(0.5, 2.5), 20% ice / 80% rock."""
    rng = np.random.default_rng(seed)
    angle = rng.uniform(0, 2 * np.pi, n_disk)
    dist = 30.0 + rng.uniform(0, 60.0, n_disk)
    speed = np.sqrt(G * center_mass / dist)
    pos = np.stack(
        [np.cos(angle) * dist, rng.uniform(-1, 1, n_disk), np.sin(angle) * dist],
        axis=1,
    )
    vel = np.stack(
        [-np.sin(angle) * speed, np.zeros(n_disk), np.cos(angle) * speed], axis=1
    )
    mat = np.where(rng.uniform(size=n_disk) > 0.8, ICE, ROCK)
    mass = rng.uniform(size=n_disk) * 2.0 + 0.5
    return _scene(
        pos=np.concatenate([[[0, 0, 0]], pos]),
        vel=np.concatenate([[[0, 0, 0]], vel]),
        mass=np.concatenate([[center_mass], mass]),
        mat=np.concatenate([[METAL], mat]),
        temp=np.concatenate([[1000.0], np.zeros(n_disk)]),
    )


def head_on_collision() -> Scene:
    """The 'collision' scene (index.html:760-763): two mass-100 bodies,
    rock at (-40,0,0) moving +x, ice at (40,0,10) moving -x — the z-offset
    makes it a grazing impact."""
    return _scene(
        pos=[[-40, 0, 0], [40, 0, 10]],
        vel=[[1, 0, 0], [-1, 0, 0]],
        mass=[100.0, 100.0],
        mat=[ROCK, ICE],
    )


def kepler_two_body(
    m1: float = 1000.0,
    m2: float = 1.0,
    a: float = 50.0,
    e: float = 0.0,
    G: float = 0.5,
) -> Scene:
    """Two-body orbit with semi-major axis a and eccentricity e, started at
    periapsis, in the COM frame. Closed-form gate for the integrators
    (BASELINE config 2)."""
    M = m1 + m2
    r_peri = a * (1 - e)
    v_peri = np.sqrt(G * M * (1 + e) / (a * (1 - e)))  # vis-viva at periapsis
    # body2 relative to body1 at (r_peri, 0, 0) moving +y; split by mass ratio
    pos2 = np.array([r_peri, 0, 0]) * (m1 / M)
    pos1 = -np.array([r_peri, 0, 0]) * (m2 / M)
    vel2 = np.array([0, v_peri, 0]) * (m1 / M)
    vel1 = -np.array([0, v_peri, 0]) * (m2 / M)
    return _scene(
        pos=[pos1, pos2], vel=[vel1, vel2], mass=[m1, m2], mat=[METAL, ROCK]
    )


def solar_system() -> Scene:
    """Sun + 8 planets, heliocentric units: AU, year, solar mass, G = 4 pi^2.
    Circular-orbit idealization (a in AU, m in Msun) — an energy-conservation
    testbed, not an ephemeris."""
    G = 4 * np.pi**2
    a = np.array([0.387, 0.723, 1.0, 1.524, 5.203, 9.537, 19.19, 30.07])
    m = np.array([1.66e-7, 2.45e-6, 3.0e-6, 3.2e-7, 9.55e-4, 2.86e-4, 4.37e-5, 5.15e-5])
    v = np.sqrt(G * 1.0 / a)
    n = len(a)
    pos = np.zeros((n + 1, 3))
    vel = np.zeros((n + 1, 3))
    pos[1:, 0] = a
    vel[1:, 1] = v
    mass = np.concatenate([[1.0], m])
    # Move to COM frame
    vel -= (mass[:, None] * vel).sum(0) / mass.sum()
    pos -= (mass[:, None] * pos).sum(0) / mass.sum()
    return _scene(pos=pos, vel=vel, mass=mass, mat=[METAL] + [ROCK] * n)


def plummer(
    n: int = 16384,
    total_mass: float = 1.0,
    scale_radius: float = 1.0,
    G: float = 1.0,
    seed: int = 0,
) -> Scene:
    """Plummer sphere in virial equilibrium (Aarseth, Henon & Wielen 1974
    sampling): r from the inverse cumulative mass profile, speeds by
    rejection from f(q) ~ q^2 (1 - q^2)^(7/2). Drift gate scene
    (BASELINE config 3)."""
    rng = np.random.default_rng(seed)
    m = total_mass / n
    u = rng.uniform(1e-10, 1 - 1e-10, n)
    r = scale_radius / np.sqrt(u ** (-2.0 / 3.0) - 1.0)
    pos = r[:, None] * _random_unit(rng, n)
    v_esc = np.sqrt(2.0 * G * total_mass) * (r**2 + scale_radius**2) ** -0.25
    q = np.empty(n)
    todo = np.ones(n, bool)
    while todo.any():
        k = int(todo.sum())
        x, y = rng.uniform(0, 1, k), rng.uniform(0, 0.1, k)
        ok = y < x**2 * (1 - x**2) ** 3.5
        idx = np.nonzero(todo)[0][ok]
        q[idx] = x[ok]
        todo[idx] = False
    vel = (q * v_esc)[:, None] * _random_unit(rng, n)
    pos -= pos.mean(0)
    vel -= vel.mean(0)
    return _scene(pos=pos, vel=vel, mass=np.full(n, m))


def cold_collapse_disk(
    n: int = 262144, radius: float = 100.0, total_mass: float = 1000.0, seed: int = 0
) -> Scene:
    """Cold (zero-velocity) uniform disk — the N=262k single-chip throughput
    scene (BASELINE config 4)."""
    rng = np.random.default_rng(seed)
    r = radius * np.sqrt(rng.uniform(0, 1, n))
    th = rng.uniform(0, 2 * np.pi, n)
    pos = np.stack(
        [r * np.cos(th), rng.uniform(-1, 1, n), r * np.sin(th)], axis=1
    )
    return _scene(pos=pos, vel=np.zeros((n, 3)), mass=np.full(n, total_mass / n))


def galaxy_merger(
    n: int = 1_048_576,
    G: float = 0.5,
    separation: float = 300.0,
    approach_speed: float = 0.5,
    seed: int = 0,
) -> Scene:
    """Two reference-style disk galaxies on a collision course — the N=1M
    multi-chip scene (BASELINE config 5). Each galaxy is the reference
    'galaxy' recipe (index.html:749-759) scaled up: heavy core + cold disk on
    circular orbits."""
    rng = np.random.default_rng(seed)
    n_half = n // 2

    def one_galaxy(n_disk, center, vel0, seed_off):
        r = np.random.default_rng(seed + seed_off)
        core_mass = n_disk / 150.0 * 500.0  # reference mass scaling
        angle = r.uniform(0, 2 * np.pi, n_disk)
        dist = 30.0 + r.uniform(0, 60.0, n_disk) * np.sqrt(n_disk / 150.0)
        speed = np.sqrt(G * core_mass / dist)
        pos = np.stack(
            [np.cos(angle) * dist, r.uniform(-1, 1, n_disk), np.sin(angle) * dist],
            axis=1,
        ) + center
        vel = np.stack(
            [-np.sin(angle) * speed, np.zeros(n_disk), np.cos(angle) * speed],
            axis=1,
        ) + vel0
        mass = r.uniform(size=n_disk) * 2.0 + 0.5
        pos = np.concatenate([[center], pos])
        vel = np.concatenate([[vel0], vel])
        mass = np.concatenate([[core_mass], mass])
        return pos, vel, mass

    c = np.array([separation / 2, 0, 0])
    v = np.array([approach_speed, 0, 0])
    p1, v1, m1 = one_galaxy(n_half - 1, -c, +v, 1)
    p2, v2, m2 = one_galaxy(n - n_half - 1, +c, -v, 2)
    return _scene(
        pos=np.concatenate([p1, p2]),
        vel=np.concatenate([v1, v2]),
        mass=np.concatenate([m1, m2]),
    )


def galaxy_merger_3d(
    n: int = 1_048_576,
    G: float = 0.5,
    R: float | None = None,
    bulge_frac: float = 0.30,
    seed: int = 0,
) -> tuple[Scene, float]:
    """Two 3D disk+bulge galaxies on a bound grazing collision course — the
    flagship N=1M full-physics scene (BASELINE config 5, examples/
    merger_full.py). Returns (scene, box): positions live in [0, box)^3,
    the domain the collision binning and the isolated P3M/PM mesh share.

    Geometry diverges deliberately from the reference disk recipe
    (index.html:749-759, y ~ U(-1, 1)): a razor-thin sheet at N = 1M
    concentrates ~sigma h^2 bodies into every occupied mesh cell, which
    breaks P3M's kept-table premise at any affordable tune (see
    nbx.ops.p3m.p3m_tune_for). Each galaxy here is a Plummer BULGE
    (scale 0.35 R) plus a surface-uniform disk with Gaussian scale height
    0.16 R — occupancy per cell stays under the PP kernel's K at
    n_cells ~ 32, with the bulge cores (the physically clustered part)
    absorbed by the adaptive residual exactly like the measured
    1M+30k-core bench scene. Rotation curves come from the enclosed-mass
    profile (core + bulge + disk), the reference's v = sqrt(G M / r)
    construction (index.html:754) generalized; 20% ice / 80% rock and
    body masses U(0.5, 2.5) follow the reference disk recipe.
    """
    rng = np.random.default_rng(seed)
    n_half = n // 2
    if R is None:
        # surface density scales like n / R^2: keep it at the value that
        # fits K <= 768 at n_cells ~ 32 (module note above) at any N
        R = 1200.0 * np.sqrt(n / 1_048_576)

    def one_galaxy(n_gal, seed_off):
        r = np.random.default_rng(seed + seed_off)
        n_bulge = int(n_gal * bulge_frac)
        n_disk = n_gal - n_bulge - 1  # one core body
        mass = (r.uniform(size=n_gal - 1) * 2.0 + 0.5).astype(np.float64)
        core_mass = 0.05 * mass.sum()
        m_bulge = mass[:n_bulge].sum()
        m_disk = mass[n_bulge:].sum()
        a_b = 0.35 * R

        # bulge: Plummer positions (inverse-CDF radius)
        u = r.uniform(size=n_bulge)
        rb = a_b / np.sqrt(np.maximum(u ** (-2.0 / 3.0) - 1.0, 1e-9))
        rb = np.minimum(rb, 3.0 * a_b)  # clip the far tail inside the box
        db = _random_unit(r, n_bulge)
        pos_b = db * rb[:, None]

        # disk: surface-uniform annulus + Gaussian scale height
        r_in = 0.05 * R
        rd = np.sqrt(r.uniform(r_in**2, R**2, n_disk))
        th = r.uniform(0, 2 * np.pi, n_disk)
        z = r.normal(0.0, 0.16 * R, n_disk)
        pos_d = np.stack([rd * np.cos(th), z, rd * np.sin(th)], axis=1)

        # enclosed mass -> circular speed (the sqrt(GM/r) construction)
        def m_enc(rr):
            mb = m_bulge * rr**3 / (rr**2 + a_b**2) ** 1.5
            md = m_disk * np.clip(
                (rr**2 - r_in**2) / (R**2 - r_in**2), 0.0, 1.0
            )
            return core_mass + mb + md

        # bulge: isotropic velocities at ~0.6 of local circular speed
        # (pressure-supported, kept sub-virial so the bulge gently relaxes)
        vb = 0.6 * np.sqrt(G * m_enc(np.maximum(rb, 0.05 * R)) / np.maximum(rb, 0.05 * R))
        vel_b = _random_unit(r, n_bulge) * vb[:, None]
        # disk: tangential circular orbits in the galaxy plane
        vd = np.sqrt(G * m_enc(rd) / rd)
        vel_d = np.stack(
            [-np.sin(th) * vd, np.zeros(n_disk), np.cos(th) * vd], axis=1
        )

        pos = np.concatenate([[[0.0, 0.0, 0.0]], pos_b, pos_d])
        vel = np.concatenate([[[0.0, 0.0, 0.0]], vel_b, vel_d])
        m = np.concatenate([[core_mass], mass])
        mat = np.full(n_gal, ROCK, np.int32)
        ice = r.uniform(size=n_gal) < 0.2  # 20% ice (index.html:757)
        mat[ice] = ICE
        mat[0] = METAL  # hot metal core (index.html:750)
        temp = np.zeros(n_gal, np.float32)
        temp[0] = 1000.0
        return pos, vel, m, mat, temp, m.sum()

    p1, v1, m1, t1, T1, M1 = one_galaxy(n_half, 1)
    p2, v2, m2, t2, T2, M2 = one_galaxy(n - n_half, 2)

    sep = 2.1 * R
    impact = 0.25 * R  # grazing offset (the reference collision scenario's
    # z-offset trick, index.html:760-763, scaled up)
    # bound pair: relative speed at distance `sep` below escape
    v_esc = np.sqrt(2.0 * G * (M1 + M2) / sep)
    v_app = 0.45 * v_esc
    c = np.array([sep / 2, 0.0, impact / 2])
    dv = np.array([v_app / 2, 0.0, 0.0])
    pos = np.concatenate([p1 - c, p2 + c])
    vel = np.concatenate([v1 + dv, v2 - dv])

    box = float(2.0 * (sep / 2 + 1.7 * R))
    pos = pos + box / 2.0  # -> [0, box)^3 (binning + isolated-mesh domain)
    sc = _scene(
        pos=pos,
        vel=vel,
        mass=np.concatenate([m1, m2]),
        mat=np.concatenate([t1, t2]),
        temp=np.concatenate([T1, T2]),
    )
    return sc, box


def uniform_cube(n: int, side: float = 100.0, seed: int = 0) -> Scene:
    """Uniform random cube, unit masses — kernel benchmarking scene."""
    rng = np.random.default_rng(seed)
    return _scene(
        pos=rng.uniform(-side / 2, side / 2, (n, 3)),
        vel=np.zeros((n, 3)),
        mass=np.ones(n),
    )


def _random_unit(rng, n: int) -> np.ndarray:
    v = rng.normal(size=(n, 3))
    return v / np.linalg.norm(v, axis=1, keepdims=True)


SCENARIOS = {
    "galaxy": reference_galaxy,
    "collision": head_on_collision,
    "kepler": kepler_two_body,
    "solar_system": solar_system,
    "plummer": plummer,
    "cold_collapse_disk": cold_collapse_disk,
    "galaxy_merger": galaxy_merger,
    "uniform_cube": uniform_cube,
}
