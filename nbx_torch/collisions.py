"""Collision resolution: contact timers, impulse bounce, merge, fracture (port
of `nbx/collisions.py`: `resolve_collisions`, `resolve_collisions_sequential`
and their helpers).

The same masked data-parallel work over the fixed-capacity state as the JAX
package: [C, C] pair matrices for the overlap test, contact timers, Jacobi
impulses and position corrections, and an iterated greedy matching that picks
merge and fracture events in the reference's (i, j) sweep order. See the JAX
module's docstring for the semantics and its one documented divergence from
the sequential reference sweep.

Fracture randomness: the JAX package draws the fragment uniforms from its
`jax.random` key, a stream torch cannot reproduce. Here they are an explicit
`Draws` input: `resolve_collisions(..., draws=None)` draws them from the
state's torch.Generator on the state's device, and a caller (a parity test)
may pass its own.

Nothing here reads a value back to the host or makes a shape depend on the
data: no .item(), nonzero(), boolean-mask indexing or unique. (The one
exception is the CPU path of the strict-sequential sweep, the plain version
`ops.sequential.sweep_reference`, which reads each decision; on the card the
sweep is one kernel launch.)
"""

from __future__ import annotations

import dataclasses

import torch

from nbx_torch import thermal
from nbx_torch.config import CUDA, SimConfig, f32, inverse_mass
from nbx_torch.ops import sequential
from nbx_torch.state import SimState, add_bodies_batch

RESTITUTION = 0.2
FRICTION = 0.5
CORRECTION = 0.8  # Baumgarte position-correction factor


@dataclasses.dataclass(frozen=True)
class Events:
    """Per-substep event log, fixed-size masked buffers:
    merges (flash at merged COM), fractures (flash at pair midpoint with the
    impact energy), spawns (one explosion per fragment)."""

    merge_pos: torch.Tensor  # [M, 3]
    merge_mass: torch.Tensor  # [M]
    merge_mask: torch.Tensor  # [M] bool
    fracture_pos: torch.Tensor  # [F, 3]
    fracture_energy: torch.Tensor  # [F]
    fracture_mask: torch.Tensor  # [F] bool
    spawn_pos: torch.Tensor  # [F * K, 3] fragment explosion sites
    spawn_temp: torch.Tensor  # [F * K]
    spawn_mask: torch.Tensor  # [F * K] bool
    n_merges: torch.Tensor  # [] i32
    n_fractures: torch.Tensor  # [] i32
    n_bounces: torch.Tensor  # [] i32
    n_evicted: torch.Tensor  # [] i32  FIFO evictions caused by births
    n_dropped: torch.Tensor  # [] i32  event candidates lost to buffer caps


def empty_events(cfg: SimConfig, device=CUDA) -> Events:
    m, f, k = cfg.max_merges, cfg.max_fractures, cfg.max_fragments

    def z(shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return Events(
        merge_pos=z((m, 3)),
        merge_mass=z((m,)),
        merge_mask=z((m,), torch.bool),
        fracture_pos=z((f, 3)),
        fracture_energy=z((f,)),
        fracture_mask=z((f,), torch.bool),
        spawn_pos=z((f * k, 3)),
        spawn_temp=z((f * k,)),
        spawn_mask=z((f * k,), torch.bool),
        n_merges=z((), torch.int32),
        n_fractures=z((), torch.int32),
        n_bounces=z((), torch.int32),
        n_evicted=z((), torch.int32),
        n_dropped=z((), torch.int32),
    )


@dataclasses.dataclass(frozen=True)
class Draws:
    """The uniform [0, 1) draws of one substep's fracture breakup, F =
    max_fractures events by K = max_fragments fragment slots. In the JAX
    package they come from the split chain of `resolve_collisions`:
    split(key) -> sub; split(sub) -> k_count, k_scan; u0 from k_count;
    u_mass, u_dir, u_off, u_speed from fold_in(k_scan, 0..3)."""

    u0: torch.Tensor  # [F] fragment count
    u_mass: torch.Tensor  # [K, F] mass split
    u_dir: torch.Tensor  # [K, F, 3] scatter direction
    u_off: torch.Tensor  # [K, F] offset from the COM
    u_speed: torch.Tensor  # [K, F] ejection speed

    def to(self, device) -> "Draws":
        return Draws(*(getattr(self, f.name).to(device) for f in dataclasses.fields(self)))


def draw_fracture_uniforms(cfg: SimConfig, generator: torch.Generator, device) -> Draws:
    f, k = cfg.max_fractures, cfg.max_fragments

    def u(*shape):
        return torch.rand(shape, generator=generator, device=device)

    return Draws(u0=u(f), u_mass=u(k, f), u_dir=u(k, f, 3), u_off=u(k, f), u_speed=u(k, f))


def _greedy_match(cand: torch.Tensor, rounds: int) -> torch.Tensor:
    """Greedy maximal matching over candidate pairs by (i, j) lexicographic
    priority. cand: [C, C] bool, upper-triangular. Each round selects every
    pair that is the minimum-priority candidate of both its bodies."""
    c = cand.shape[0]
    idx = torch.arange(c, device=cand.device)
    prio = idx[:, None] * c + idx[None, :]  # lexicographic (i, j) sweep order
    big = c * c
    matched = torch.zeros_like(cand)
    for _ in range(rounds):
        p = torch.where(cand, prio, big)
        p_sym = torch.minimum(p, p.T)  # body b's best candidate priority
        best = p_sym.amin(1)  # [C]
        sel = cand & (p == best[:, None]) & (p == best[None, :])
        matched = matched | sel
        used = sel.any(1) | sel.any(0)  # consumed bodies
        cand = cand & ~used[:, None] & ~used[None, :]
    return matched


def _top_pairs(sel: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Up to k selected pairs in sweep order. Returns (i, j, valid); invalid
    entries carry index 0. `sel` comes from a matching, so each row holds at
    most one selected column."""
    c = sel.shape[0]
    dev = sel.device
    row_has = sel.any(1)  # [C]
    # argmax on an integer cast: the first selected column, as jnp.argmax
    # on bool gives it.
    j_of = sel.to(torch.int32).argmax(1)  # [C]
    rank = torch.cumsum(row_has.to(torch.int64), 0) - 1  # [C] sweep order
    tgt = torch.where(row_has & (rank < k), rank, k)  # k = dropped
    ii = torch.full((k + 1,), c, dtype=torch.int64, device=dev)
    ii = ii.index_put((tgt,), torch.arange(c, device=dev))[:k]
    valid = ii < c
    jj = torch.where(valid, j_of[ii.clamp(0, c - 1)], 0)
    return torch.where(valid, ii, 0), jj, valid


def resolve_collisions(
    state: SimState, cfg: SimConfig, h: float, draws: Draws | None = None
) -> tuple[SimState, Events]:
    """One collision sweep. Runs between the force evaluation and the second
    half-kick. Updates pos/vel/temp/contact, kills merged and fractured
    bodies, and births merged bodies and fragments (with FIFO eviction).

    `draws` supplies the fracture uniforms; None draws them from
    `state.generator`."""
    c = state.capacity
    dev = state.device
    pos, vel, mass, temp = state.pos, state.vel, state.mass, state.temp
    alive = state.alive
    inv_m = inverse_mass(mass)
    radius = state.radius(cfg)

    idx = torch.arange(c, device=dev)
    upper = idx[:, None] < idx[None, :]
    pair_alive = alive[:, None] & alive[None, :] & upper

    d = pos[None, :, :] - pos[:, None, :]  # d[i, j] = p_j - p_i
    dist2 = (d * d).sum(-1)
    min_dist = radius[:, None] + radius[None, :]
    overlap = pair_alive & (dist2 < min_dist * min_dist)

    # --- contact-time accumulation + pruning -------------------------------
    overlap_sym = overlap | overlap.T
    contact = torch.where(overlap_sym, state.contact + h, 0.0)

    dist = torch.sqrt(torch.where(dist2 > 0, dist2, 1.0))
    normal = d / dist[:, :, None]  # unit, i -> j
    rel_vel = vel[None, :, :] - vel[:, None, :]  # v_j - v_i
    vn = (rel_vel * normal).sum(-1)
    approaching = overlap & (vn < 0)

    inv_sum = inv_m[:, None] + inv_m[None, :]
    safe_inv_sum = torch.where(inv_sum > 0, inv_sum, 1.0)
    j_imp = -f32(1.0 + f32(cfg.restitution)) * vn / safe_inv_sum
    m_sum = mass[:, None] + mass[None, :]
    safe_m_sum = torch.where(m_sum > 0, m_sum, 1.0)
    mu = mass[:, None] * mass[None, :] / safe_m_sum
    energy = 0.5 * mu * vn * vn
    q = energy / safe_m_sum  # specific energy

    # --- heating: every approaching pair heats both bodies -----------------
    appr_sym = approaching | approaching.T
    e_sym = torch.where(appr_sym, torch.maximum(energy, energy.T), 0.0)
    temp = temp + thermal.impact_heating(e_sym.sum(1), mass)

    # --- branch classification ----------------------------------------------
    merge_cand = (
        approaching
        & (contact > cfg.merge_time)
        & (q < f32(cfg.fracture_threshold) * 2.0)
    )
    fracture_cand = (
        approaching
        & ~merge_cand
        & (q > cfg.fracture_threshold)
        & (
            (mass[:, None] > cfg.min_fragment_mass)
            | (mass[None, :] > cfg.min_fragment_mass)
        )
    )
    event_cand = merge_cand | fracture_cand
    matched = _greedy_match(event_cand, cfg.match_rounds)
    merge_sel = matched & merge_cand
    fract_sel = matched & fracture_cand
    consumed = matched.any(1) | matched.any(0)

    # Bounce pairs: approaching, not an event candidate, neither body consumed.
    bounce = approaching & ~event_cand & ~consumed[:, None] & ~consumed[None, :]

    # --- position correction: fracture + bounce branches -------------------
    corr_pairs = bounce | fract_sel
    corr_mag = torch.where(
        corr_pairs, (min_dist - dist) / safe_inv_sum * CORRECTION, 0.0
    )
    corr_vec = corr_mag[:, :, None] * normal  # [C, C, 3]
    pos = pos + (corr_vec.sum(0) - corr_vec.sum(1)) * inv_m[:, None]

    # --- bounce impulses: normal + friction --------------------------------
    tangent_raw = rel_vel - vn[:, :, None] * normal
    t_len = torch.sqrt((tangent_raw * tangent_raw).sum(-1))
    # THREE.Vector3.normalize maps the zero vector to zero.
    tangent = tangent_raw / torch.where(t_len > 0, t_len, 1.0)[:, :, None]
    jt = -t_len * cfg.friction / safe_inv_sum
    imp = torch.where(bounce, j_imp, 0.0)[:, :, None] * normal + torch.where(
        bounce, jt, 0.0
    )[:, :, None] * tangent
    vel = vel + (imp.sum(0) - imp.sum(1)) * inv_m[:, None]

    state = state.replace(pos=pos, vel=vel, temp=temp, contact=contact)

    # --- merge events (uncorrected positions, post-heating temperatures) ---
    mi, mj, m_valid = _top_pairs(merge_sel, cfg.max_merges)
    ma, mb = mass[mi], mass[mj]
    m_tot = ma + mb
    m_safe = torch.where(m_valid, m_tot, 1.0)
    merge_vel = (vel[mi] * ma[:, None] + vel[mj] * mb[:, None]) / m_safe[:, None]
    merge_pos = (pos[mi] * ma[:, None] + pos[mj] * mb[:, None]) / m_safe[:, None]
    merge_temp = (temp[mi] * ma + temp[mj] * mb) / m_safe
    merge_mat = torch.where(ma > mb, state.mat[mi], state.mat[mj])

    # --- fracture events (post-correction positions) -----------------------
    fi, fj, f_valid = _top_pairs(fract_sel, cfg.max_fractures)
    fa, fb = mass[fi], mass[fj]
    f_tot = fa + fb
    f_safe = torch.where(f_valid, f_tot, 1.0)
    com = (pos[fi] * fa[:, None] + pos[fj] * fb[:, None]) / f_safe[:, None]
    base_vel = (vel[fi] * fa[:, None] + vel[fj] * fb[:, None]) / f_safe[:, None]
    f_energy = energy[fi, fj]
    f_temp = torch.maximum(temp[fi], temp[fj]) + (f_energy / f_safe) * 0.1
    f_mat = torch.where(fa > fb, state.mat[fi], state.mat[fj])
    f_radius_sum = radius[fi] + radius[fj]
    midpoint = 0.5 * (pos[fi] + pos[fj])  # flash site

    if draws is None:
        draws = draw_fracture_uniforms(cfg, state.generator, dev)
    frag = _make_fragments(
        draws, cfg, f_valid, com, base_vel, f_energy, f_tot, f_temp, f_mat,
        f_radius_sum,
    )

    # --- kills: only valid pairs mark their bodies (index c is dropped) -----
    kill_idx = torch.cat([
        torch.where(m_valid, mi, c), torch.where(m_valid, mj, c),
        torch.where(f_valid, fi, c), torch.where(f_valid, fj, c),
    ])
    kill = torch.zeros((c + 1,), dtype=torch.bool, device=dev)
    kill = kill.index_put((kill_idx,), torch.ones_like(kill_idx, dtype=torch.bool))
    keep = ~kill[:c]
    state = state.replace(
        alive=state.alive & keep,
        mass=torch.where(keep, state.mass, 0.0),
        vel=torch.where(keep[:, None], state.vel, 0.0),
        acc=torch.where(keep[:, None], state.acc, 0.0),
        temp=torch.where(keep, state.temp, 0.0),
        contact=torch.where(keep[:, None] & keep[None, :], state.contact, 0.0),
    )

    # --- births: merged bodies then fragments, FIFO eviction ---------------
    state, n_evicted = add_bodies_batch(
        state,
        torch.cat([torch.where(m_valid, m_tot, 0.0), frag["mass"]]),
        torch.cat([merge_pos, frag["pos"]]),
        torch.cat([merge_vel, frag["vel"]]),
        torch.cat([merge_mat, frag["mat"]]),
        torch.cat([merge_temp, frag["temp"]]),
        torch.cat([m_valid, frag["mask"]]),
    )

    def count(x):
        return x.sum(dtype=torch.int32)

    events = Events(
        merge_pos=merge_pos,
        merge_mass=torch.where(m_valid, m_tot, 0.0),
        merge_mask=m_valid,
        fracture_pos=midpoint,
        fracture_energy=torch.where(f_valid, f_energy, 0.0),
        fracture_mask=f_valid,
        spawn_pos=frag["pos"],
        spawn_temp=frag["temp"],
        spawn_mask=frag["mask"],
        n_merges=count(m_valid),
        n_fractures=count(f_valid),
        n_bounces=count(bounce),
        n_evicted=n_evicted,
        n_dropped=(count(merge_sel) - count(m_valid))
        + (count(fract_sel) - count(f_valid)),
    )
    return state, events


def resolve_collisions_sequential(
    state: SimState, cfg: SimConfig, h: float, draws: Draws | None = None
) -> tuple[SimState, Events]:
    """The strict-sequential collision sweep (port of the JAX package's
    `resolve_collisions_sequential`): the reference's in-place (i, j) pair
    loop, each pair seeing every earlier pair's impulses, corrections and
    heat within the sweep, where `resolve_collisions` approximates them. The
    sweep itself is `ops.sequential.sweep`, one kernel launch on the card
    (at most `ops.sequential.MAX_CAPACITY` bodies); the kills and births
    after it are tensor ops, as in `resolve_collisions`: removed bodies die,
    the merged bodies and then the fragments are born, with FIFO eviction.

    `draws` supplies the fracture uniforms; None draws them from
    `state.generator`, as `resolve_collisions` does."""
    mm, ff = cfg.max_merges, cfg.max_fractures
    dev = state.device
    s = sequential.sweep(state.pos, state.vel, state.temp, state.mass, state.radius(cfg),
                         inverse_mass(state.mass), state.mat, state.alive, state.contact, h, cfg)
    keep = ~s.removed
    state = state.replace(
        pos=s.pos, vel=torch.where(keep[:, None], s.vel, 0.0),
        temp=torch.where(keep, s.temp, 0.0),
        alive=state.alive & keep,
        mass=torch.where(keep, state.mass, 0.0),
        acc=torch.where(keep[:, None], state.acc, 0.0),
        contact=torch.where(keep[:, None] & keep[None, :], s.contact, 0.0),
    )

    m_cnt, f_cnt = s.count("m_cnt"), s.count("f_cnt")
    m_valid = torch.arange(mm, dtype=torch.int32, device=dev) < m_cnt
    f_valid = torch.arange(ff, dtype=torch.int32, device=dev) < f_cnt
    m_pos, m_vel, m_mass, m_temp = s.mbuf[:, 0:3], s.mbuf[:, 3:6], s.mbuf[:, 6], s.mbuf[:, 7]
    f_com, f_bvel = s.fbuf[:, 0:3], s.fbuf[:, 3:6]
    f_energy, f_tot, f_temp, f_rsum, f_mid = s.fbuf[:, 6], s.fbuf[:, 7], s.fbuf[:, 8], s.fbuf[:, 9], s.fbuf[:, 10:13]
    if draws is None:
        draws = draw_fracture_uniforms(cfg, state.generator, dev)
    frag = _make_fragments(
        draws, cfg, f_valid, f_com, f_bvel, torch.where(f_valid, f_energy, 0.0), f_tot, f_temp, s.fmat,
        f_rsum,
    )
    state, n_evicted = add_bodies_batch(
        state,
        torch.cat([torch.where(m_valid, m_mass, 0.0), frag["mass"]]),
        torch.cat([m_pos, frag["pos"]]),
        torch.cat([m_vel, frag["vel"]]),
        torch.cat([s.mmat, frag["mat"]]),
        torch.cat([m_temp, frag["temp"]]),
        torch.cat([m_valid, frag["mask"]]),
    )
    events = Events(
        merge_pos=m_pos,
        merge_mass=torch.where(m_valid, m_mass, 0.0),
        merge_mask=m_valid,
        fracture_pos=f_mid,
        fracture_energy=torch.where(f_valid, f_energy, 0.0),
        fracture_mask=f_valid,
        spawn_pos=frag["pos"],
        spawn_temp=frag["temp"],
        spawn_mask=frag["mask"],
        n_merges=m_cnt,
        n_fractures=f_cnt,
        n_bounces=s.count("n_bounces"),
        n_evicted=n_evicted,
        n_dropped=s.count("m_drop") + s.count("f_drop"),
    )
    return state, events


def _make_fragments(
    draws: Draws,
    cfg: SimConfig,
    valid: torch.Tensor,  # [F]
    com: torch.Tensor,  # [F, 3]
    base_vel: torch.Tensor,  # [F, 3]
    energy: torch.Tensor,  # [F]
    total_mass: torch.Tensor,  # [F]
    temp: torch.Tensor,  # [F]
    mat: torch.Tensor,  # [F]
    radius_sum: torch.Tensor,  # [F]
) -> dict:
    """Stochastic breakup of fractured pairs, batched over F events x K
    fragment slots. The greedy sequential mass split (each fragment takes
    0.3 + 0.4 u of the remainder, the last takes all, sub-threshold
    fragments skipped, early break when the remainder is sub-threshold) runs
    as a loop over the K axis. Outputs are [F * K], event-major."""
    f, k = valid.shape[0], cfg.max_fragments
    safe_m = torch.where(valid, total_mass, 1.0)
    severity = torch.clamp(energy / cfg.fracture_threshold, max=5.0)
    num_frag = torch.floor(3.0 + draws.u0 * 3.0 * severity).to(torch.int32)
    eject_base = torch.sqrt(energy / safe_m)

    remaining = torch.where(valid, total_mass, 0.0)
    broke = ~valid
    outs = []
    for idx in range(k):
        broke = broke | (remaining < cfg.min_fragment_mass)
        frag_mass = remaining * (0.3 + 0.4 * draws.u_mass[idx])
        frag_mass = torch.where(num_frag - 1 == idx, remaining, frag_mass)
        keep = valid & ~broke & (num_frag > idx) & (frag_mass >= cfg.min_fragment_mass)
        remaining = torch.where(keep, remaining - frag_mass, remaining)
        scatter = draws.u_dir[idx] - 0.5  # [F, 3]
        s_len = torch.sqrt((scatter * scatter).sum(-1))
        scatter = scatter / torch.where(s_len > 0, s_len, 1.0)[:, None]
        pos = com + scatter * (radius_sum * 0.5 * draws.u_off[idx])[:, None]
        speed = eject_base * (0.5 + draws.u_speed[idx])
        vel = base_vel + scatter * speed[:, None]
        outs.append(dict(
            mass=torch.where(keep, frag_mass, 0.0), pos=pos, vel=vel,
            temp=temp, mat=mat, mask=keep,
        ))
    # stack to [F, K, ...] and flatten event-major (event 0's fragments first)
    return {
        name: torch.stack([o[name] for o in outs], dim=1).reshape(
            (f * k,) + outs[0][name].shape[1:]
        )
        for name in outs[0]
    }
