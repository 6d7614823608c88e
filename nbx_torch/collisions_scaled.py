"""Full collision physics at scale: bounce + merge + fracture beyond 100k
bodies (port of `nbx/collisions_scaled.py`).

The dense resolver (`nbx_torch.collisions`) carries [C, C] pair matrices;
this module runs the same event physics on top of the fused collision pass
(`nbx_torch.ops.collide`, kernel K2), with a per-body partner record in place
of the [C, C] contact map:

  * the pass reports each body's deepest-overlap partner per substep;
  * a body's contact timer accumulates while its deepest partner is stable
    and resets when it changes (timer_slots=1), or lives in a K-slot
    per-body table that survives partner alternation (timer_slots=K > 1);
  * merges and fractures fire only on mutual partners, one event per body
    per substep.

The divergences from the dense path are the JAX module's and are documented
there: impulses apply to event pairs too, a merge is written in place into
the lower slot, and fragments go into dead slots (dropped and counted when
none remain).

Fracture randomness: the fragment uniforms are an explicit `Draws` input, as
in `nbx_torch.collisions`; `draws=None` draws them from the state's
torch.Generator. Nothing here reads a value back to the host or makes a shape
depend on the data.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from nbx_torch import thermal
from nbx_torch.collisions import Draws, _make_fragments, draw_fracture_uniforms
from nbx_torch.config import CUDA, SimConfig, body_radius, f32
from nbx_torch.ops.collide import binned_collision_pass
from nbx_torch.ops.p3m import take_rows
from nbx_torch.profiling import span, spanned
from nbx_torch.sim import _stack, gravity, substep_size
from nbx_torch.state import make_generator


@dataclasses.dataclass(frozen=True)
class GranularState:
    """Fixed-capacity SoA state for at-scale collisional dynamics. Dead slots
    carry mass 0. partner / contact_t ([N], or [N, K] with K timer slots)
    replace SimState.contact. `generator` takes the place of the JAX key."""

    pos: torch.Tensor  # [N, 3] f32
    vel: torch.Tensor  # [N, 3] f32
    mass: torch.Tensor  # [N] f32 (0 = dead)
    mat: torch.Tensor  # [N] i32 material id
    temp: torch.Tensor  # [N] f32
    partner: torch.Tensor  # [N] or [N, K] i32 deepest-overlap partner (-1 = none)
    contact_t: torch.Tensor  # [N] or [N, K] f32 accumulated contact seconds
    generator: torch.Generator

    @property
    def device(self) -> torch.device:
        return self.pos.device

    def replace(self, **kwargs) -> "GranularState":
        return dataclasses.replace(self, **kwargs)


def make_granular_state(pos, vel, mass, mat=None, temp=None, seed: int = 0,
                        timer_slots: int = 1, device=None) -> GranularState:
    """A GranularState from arrays (numpy or torch). timer_slots=1: one
    partner and timer per body. timer_slots=K > 1: a K-slot contact table
    per body, whose unobserved entries survive one grace step, so a body
    alternating between M <= K deepest partners still accrues their timers
    (see the JAX package's make_granular_state). The state goes to `device`;
    by default, to the device of a tensor `pos`, else to the card."""
    if device is None:
        device = pos.device if isinstance(pos, torch.Tensor) else CUDA

    def t(x, dtype):
        return torch.as_tensor(x, dtype=dtype).to(device)

    n = pos.shape[0]
    mat = torch.zeros(n, dtype=torch.int32, device=device) if mat is None else t(mat, torch.int32)
    temp = torch.zeros(n, dtype=torch.float32, device=device) if temp is None else t(temp, torch.float32)
    pshape = (n,) if timer_slots == 1 else (n, timer_slots)
    return GranularState(
        pos=t(pos, torch.float32), vel=t(vel, torch.float32), mass=t(mass, torch.float32),
        mat=mat, temp=temp,
        partner=torch.full(pshape, -1, dtype=torch.int32, device=device),
        contact_t=torch.zeros(pshape, dtype=torch.float32, device=device),
        generator=make_generator(device, seed),
    )


@dataclasses.dataclass(frozen=True)
class ScaledEvents:
    """Per-substep event log (fixed shapes)."""

    merge_pos: torch.Tensor  # [M, 3] merged COM
    merge_mass: torch.Tensor  # [M]
    merge_mask: torch.Tensor  # [M] bool
    fracture_pos: torch.Tensor  # [F, 3] pair midpoints
    fracture_energy: torch.Tensor  # [F]
    fracture_mask: torch.Tensor  # [F] bool
    spawn_pos: torch.Tensor  # [F * K, 3] fragment sites
    spawn_temp: torch.Tensor  # [F * K]
    spawn_mask: torch.Tensor  # [F * K] bool
    n_merges: torch.Tensor  # [] i32 (total fired, not just logged)
    n_fractures: torch.Tensor  # [] i32
    n_bounces: torch.Tensor  # [] i32
    n_overflow: torch.Tensor  # [] i32 bodies dropped from the binning
    n_dropped: torch.Tensor  # [] i32 event/fragment candidates lost to caps
    cell_too_small: torch.Tensor  # [] bool 2 max(r) > cell: contacts may be missed
    touched: torch.Tensor  # [N] bool slots reborn this substep (newborns: acc = 0)


def _set_at(x: torch.Tensor, idx: torch.Tensor, val) -> torch.Tensor:
    """x.at[idx].set(val, mode="drop") for idx in [0, n]: index n drops."""
    pad = torch.cat([x, x[:1]])
    pad[idx] = val
    return pad[:-1]


@spanned("nbx.collide.timers")
def _timers(state: GranularState, best_j: torch.Tensor, has: torch.Tensor, h: float):
    """Advance the contact timers with this substep's deepest partners.
    Returns (partner, contact_t, deepest [N], t_pair [N]): t_pair is the
    smaller of the two sides' timers for the mutual pair."""
    n = best_j.shape[0]
    dev = best_j.device
    i_ar = torch.arange(n, device=dev)
    if state.partner.dim() == 1:
        same = best_j == state.partner
        contact_t = torch.where(has, torch.where(same, state.contact_t + h, h), 0.0)
        partner = torch.where(has, best_j, -1)
        jc = partner.long().clamp(0, n - 1)
        return partner, contact_t, partner, torch.minimum(contact_t, contact_t[jc])

    # K-slot table: FRESH (p >= 0), MISSED once (-p - 2), EMPTY (-1). The
    # matching slot goes fresh and accrues h; unmatched fresh slots go missed
    # (timer kept); unmatched missed slots are pruned.
    P, T = state.partner, state.contact_t  # [N, K]
    obs = torch.where(has, best_j, -2)  # -2 matches nothing
    pdec = torch.where(P >= 0, P, -P - 2)
    match = (P != -1) & (pdec == obs[:, None])
    matched_any = match.any(1)
    fresh_unm = (P >= 0) & ~match
    P = torch.where(match, obs[:, None], torch.where(fresh_unm, -P - 2, -1))
    T = torch.where(match, T + h, torch.where(fresh_unm, T, 0.0))
    # insert an unmatched observation: first empty slot, else the
    # smallest-timer slot (argmin takes the first minimum)
    need = has & ~matched_any
    slot = torch.where(P == -1, -1.0, T).argmin(1, keepdim=True)
    P = P.scatter(1, slot, torch.where(need, obs, P.gather(1, slot)[:, 0])[:, None])
    T = T.scatter(1, slot, torch.where(need, h, T.gather(1, slot)[:, 0])[:, None])
    deepest = torch.where(has, best_j, -1)
    pdec2 = torch.where(P >= 0, P, -P - 2)
    sel = (P != -1) & (pdec2 == torch.where(has, best_j, -2)[:, None])
    t_mine = torch.where(sel, T, 0.0).amax(1)
    # the partner's timer for me: look me up in row jc's table
    jc = deepest.long().clamp(0, n - 1)
    Pj = P[jc]
    pdecj = torch.where(Pj >= 0, Pj, -Pj - 2)
    selj = (Pj != -1) & (pdecj == i_ar[:, None])
    t_theirs = torch.where(selj, T[jc], 0.0).amax(1)
    return P, T, deepest, torch.minimum(t_mine, t_theirs)


@spanned("nbx.collide")
def resolve_collisions_scaled(
    state: GranularState,
    cfg: SimConfig,
    h: float,
    box_size: float,
    n_cells: int,
    max_per_cell: int = 16,
    band_cells: Optional[int] = None,
    packed_caps: Optional[tuple[int, int]] = None,
    max_blocks: Optional[int] = None,
    buckets: Optional[tuple[tuple[int, int, int], ...]] = None,
    draws: Optional[Draws] = None,
    windows_per_block: int = 1,
    construction: str = "auto",
) -> tuple[GranularState, ScaledEvents]:
    """One full collision substep at scale. Runs between the force
    evaluation and the second half-kick. `draws` supplies the fracture
    uniforms; None draws them from state.generator. The layout arguments
    (n_cells ... buckets, windows_per_block, construction) go to
    `ops.collide.binned_collision_pass`."""
    n = state.mass.shape[0]
    dev = state.device
    i_ar = torch.arange(n, device=dev)
    radius = body_radius(state.mass, state.mat, cfg.materials)

    dvel, dpos, dtemp, best, n_bounces, n_overflow, too_small = binned_collision_pass(
        state.pos, state.vel, state.mass, radius, box_size, n_cells,
        cfg.restitution, cfg.friction, max_per_cell, band_cells, packed_caps,
        max_blocks, buckets, windows_per_block, construction,
    )
    pos = state.pos + dpos
    vel = state.vel + dvel
    temp = state.temp + dtemp  # impact heating

    has = best["j"] >= 0
    partner, contact_t, deepest, t_pair = _timers(state, best["j"], has, h)

    # ---- event gates on mutual partners ----------------------------------
    jc = deepest.long().clamp(0, n - 1)
    mutual = has & (deepest[jc] == i_ar)
    q, appr = best["q"], best["approaching"]
    m_i, m_j = state.mass, state.mass[jc]
    merge_m = (mutual & appr & (t_pair > f32(cfg.merge_time))
               & (q < f32(cfg.fracture_threshold) * 2.0))
    fract_m = (mutual & appr & ~merge_m & (q > f32(cfg.fracture_threshold))
               & ((m_i > f32(cfg.min_fragment_mass)) | (m_j > f32(cfg.min_fragment_mass))))
    lower = i_ar < jc
    primary_m = merge_m & lower
    primary_f = fract_m & lower

    # ---- merges, in place into the lower slot ----------------------------
    # The merge gates are bitwise symmetric between mutual partners, so the
    # higher slot's kill is arithmetic, not a scatter.
    tot = m_i + m_j
    safe_tot = torch.where(tot > 0, tot, 1.0)
    mpos = (pos * m_i[:, None] + pos[jc] * m_j[:, None]) / safe_tot[:, None]
    mvel = (vel * m_i[:, None] + vel[jc] * m_j[:, None]) / safe_tot[:, None]
    mtemp = (temp * m_i + temp[jc] * m_j) / safe_tot
    mmat = torch.where(m_i > m_j, state.mat, state.mat[jc])  # heavier body's
    killed = merge_m & (i_ar > jc)
    pm2 = primary_m[:, None]
    pos = torch.where(pm2, mpos, pos)
    vel = torch.where(pm2, mvel, torch.where(killed[:, None], 0.0, vel))
    temp = torch.where(primary_m, mtemp, torch.where(killed, 0.0, temp))
    mat = torch.where(primary_m, mmat, state.mat)
    mass = torch.where(primary_m, tot, torch.where(killed, 0.0, m_i))

    # ---- fractures: up to F events, fragments -----------------------------
    fi, f_valid = take_rows(primary_f, cfg.max_fractures)
    fi = fi.long()
    fj = jc[fi]
    fa, fb = mass[fi], mass[fj]  # the pre-merge masses: events are exclusive
    f_tot = fa + fb
    f_safe = torch.where(f_valid, f_tot, 1.0)
    com = (pos[fi] * fa[:, None] + pos[fj] * fb[:, None]) / f_safe[:, None]
    base_vel = (vel[fi] * fa[:, None] + vel[fj] * fb[:, None]) / f_safe[:, None]
    f_energy = torch.where(f_valid, best["energy"][fi], 0.0)
    f_temp = torch.maximum(temp[fi], temp[fj]) + (f_energy / f_safe) * 0.1
    f_mat = torch.where(fa > fb, mat[fi], mat[fj])  # heavier parent's
    f_radius_sum = radius[fi] + radius[fj]
    midpoint = 0.5 * (pos[fi] + pos[fj])

    if draws is None:
        draws = draw_fracture_uniforms(cfg, state.generator, dev)
    frag = _make_fragments(draws, cfg, f_valid, com, base_vel, f_energy, f_tot,
                           f_temp, f_mat, f_radius_sum)

    # kill the fracture parents (index n drops)
    fkill = torch.zeros(n, dtype=torch.bool, device=dev)
    yes = torch.ones_like(f_valid)
    fkill = _set_at(fkill, torch.where(f_valid, fi, n), yes)
    fkill = _set_at(fkill, torch.where(f_valid, fj, n), yes)
    mass = torch.where(fkill, 0.0, mass)
    vel = torch.where(fkill[:, None], 0.0, vel)
    temp = torch.where(fkill, 0.0, temp)

    # ---- fragments into the first dead slots ------------------------------
    fk = frag["mask"].shape[0]
    slot_of_rank, sv = take_rows(mass <= 0.0, fk)
    slot_of_rank = torch.where(sv, slot_of_rank.long(), n)
    frank = torch.cumsum(frag["mask"].long(), 0) - 1
    slot = torch.where(frag["mask"], slot_of_rank[frank.clamp(0, fk - 1)], n)
    placed = frag["mask"] & (slot < n)
    slot = torch.where(placed, slot, n)
    mass = _set_at(mass, slot, frag["mass"])
    pos = _set_at(pos, slot, frag["pos"])
    vel = _set_at(vel, slot, frag["vel"])
    temp = _set_at(temp, slot, frag["temp"])
    mat = _set_at(mat, slot, frag["mat"])

    # ---- reset the contact record of every reborn slot --------------------
    touched = _set_at(primary_m | killed | fkill, slot, torch.ones_like(placed))
    t_b = touched if partner.dim() == 1 else touched[:, None]
    partner = torch.where(t_b, -1, partner)
    contact_t = torch.where(t_b, 0.0, contact_t)

    # ---- event log ---------------------------------------------------------
    def count(x):
        return x.sum(dtype=torch.int32)

    mi_idx, m_valid = take_rows(primary_m, cfg.max_merges)
    mi_idx = mi_idx.long()
    n_merges, n_fracts = count(primary_m), count(primary_f)
    n_dropped = ((n_fracts - count(f_valid)) + (n_merges - count(m_valid))
                 + (count(frag["mask"]) - count(placed)))
    events = ScaledEvents(
        merge_pos=pos[mi_idx],
        merge_mass=torch.where(m_valid, mass[mi_idx], 0.0),
        merge_mask=m_valid,
        fracture_pos=midpoint,
        fracture_energy=f_energy,
        fracture_mask=f_valid,
        spawn_pos=frag["pos"],
        spawn_temp=frag["temp"],
        spawn_mask=placed,
        n_merges=n_merges,
        n_fractures=n_fracts,
        n_bounces=n_bounces,
        n_overflow=n_overflow,
        n_dropped=n_dropped,
        cell_too_small=too_small,
        touched=touched,
    )
    new_state = state.replace(pos=pos, vel=vel, mass=mass, mat=mat, temp=temp,
                              partner=partner, contact_t=contact_t)
    return new_state, events


# granular_full_kdk_scan's P3M parameters (its `p3m` keys) and their defaults,
# and the keys of a p3m_tune_for result that it does not read
P3M_SCAN_DEFAULTS = dict(n_cells=16, max_per_cell=32, max_residual=8192, pp_buckets=None,
                         affected_cap=256)
P3M_CENSUS_KEYS = ("g", "a_over_h", "n_residual", "n_affected", "pair_lanes")


def granular_full_kdk_scan(
    state: GranularState,
    cfg: SimConfig,
    box_size: float,
    n_steps: int,
    n_cells: int = 32,
    max_per_cell: int = 16,
    band_cells: Optional[int] = None,
    packed_caps: Optional[tuple[int, int]] = None,
    max_blocks: Optional[int] = None,
    buckets: Optional[tuple[tuple[int, int, int], ...]] = None,
    force_impl: str = "auto",
    pm_grid: int = 128,
    log_events: bool = False,
    green_hat: Optional[torch.Tensor] = None,
    draws: Optional[list] = None,
    p3m: Optional[dict] = None,
    windows_per_block: int = 1,
    construction: str = "auto",
):
    """Full-physics granular loop at scale: n_steps KDK substeps of
    h = dt / sub_steps with gravity, the fused collision pass with
    merge/fracture/timers, and thermal decay, in the reference's order.

    Returns (state, totals), or (state, totals, events) with
    log_events=True: totals sums the per-step counters (max for n_overflow
    and n_uncorrected, OR for cell_too_small); events is the per-step
    ScaledEvents stacked along a leading axis (touched left empty).

    force_impl: `sim.gravity`'s auto | dense | blocked | pairwise, "pm" (the
    particle-mesh solver on a pm_grid^3 isolated mesh over [0, box)^3; pass
    green_hat = isolated_green_hat(box, pm_grid) to compute it once per
    scene), "p3m" (`ops.p3m.p3m_acceleration` with the kernels K4 and K5 on
    the pm_grid^3 mesh; pass the smoothed green_hat =
    isolated_green_hat(box, pm_grid, smoothing_length(box, n_cells),
    smoothed=True) to build it once per scene; totals["n_uncorrected"] is
    the most bodies any force evaluation left without their short-range
    term) or "zero" (no gravity).

    p3m: P3M's parameters, as `ops.p3m.p3m_tune_for` returns them or with
    the same keys, each passed on to p3m_acceleration: n_cells (the JAX
    scan's p3m_cells, default 16), max_per_cell (p3m_k, 32), max_residual
    (p3m_max_residual, 8192), pp_buckets (p3m_pp_buckets, None) and
    affected_cap (256; the JAX scan has no such parameter and always uses
    256). The tune's other keys are not read: the mesh is pm_grid.
    draws: None, or one `Draws` per step.

    The collision layout: n_cells, max_per_cell, band_cells, packed_caps,
    max_blocks, buckets, windows_per_block and construction go to
    `ops.collide.binned_collision_pass`; with their defaults, the full-column
    layout at 16 bodies a cell on a 32^3 grid."""
    dev = state.device
    if force_impl == "pm":
        from nbx_torch.ops.pm import isolated_green_hat, pm_acceleration

        if green_hat is None:
            green_hat = isolated_green_hat(box_size, pm_grid, device=dev)
    elif force_impl == "p3m":
        from nbx_torch.ops.p3m import p3m_acceleration, smoothing_length
        from nbx_torch.ops.pm import isolated_green_hat

        unknown = set(p3m or {}) - set(P3M_SCAN_DEFAULTS) - set(P3M_CENSUS_KEYS)
        if unknown:
            raise ValueError(f"unknown P3M parameters {sorted(unknown)}")
        p3m_kw = dict(P3M_SCAN_DEFAULTS)
        p3m_kw.update((k, v) for k, v in (p3m or {}).items() if k in P3M_SCAN_DEFAULTS)
        if green_hat is None:
            green_hat = isolated_green_hat(box_size, pm_grid, smoothing_length(box_size, p3m_kw["n_cells"]),
                                           smoothed=True, device=dev)
    if draws is not None and len(draws) != n_steps:
        raise ValueError(f"draws holds {len(draws)} entries for {n_steps} steps")

    h = substep_size(cfg)
    half = f32(0.5 * h)

    z = torch.zeros((), dtype=torch.int32, device=dev)

    def force(pos, mass):
        """(acc, n_uncorrected): P3M's count of bodies without their
        short-range term, 0 for every other force."""
        if force_impl == "zero":
            return torch.zeros_like(pos), z
        if force_impl == "pm":
            return pm_acceleration(pos, mass, cfg.G, box_size, g=pm_grid, isolated=True,
                                   green_hat=green_hat), z
        if force_impl == "p3m":
            return p3m_acceleration(pos, mass, cfg.G, box_size, g=pm_grid, eps=cfg.softening,
                                    pp_impl="kernel", green_hat=green_hat, **p3m_kw)
        return gravity(pos, mass, cfg.G, cfg.softening, force_impl), z

    nb = nm = nf = ovf = drop = z
    small = torch.zeros((), dtype=torch.bool, device=dev)
    acc, unc = force(state.pos, state.mass)
    st = state
    evs = []
    for t in range(n_steps):
        with span("nbx.substep"):
            vel = st.vel + acc * half
            pos = st.pos + vel * h
            acc, n_unc = force(pos, st.mass)
            unc = torch.maximum(unc, n_unc)
            st = st.replace(pos=pos, vel=vel)
            st, ev = resolve_collisions_scaled(
                st, cfg, h, box_size, n_cells, max_per_cell, band_cells, packed_caps,
                max_blocks, buckets, None if draws is None else draws[t],
                windows_per_block=windows_per_block, construction=construction,
            )
            # slots reborn by a merge or a fracture are newborn: acc = 0
            acc = torch.where(ev.touched[:, None], 0.0, acc)
            st = st.replace(vel=st.vel + acc * half, temp=thermal.decay(st.temp, cfg.heat_decay))
        nb, nm, nf = nb + ev.n_bounces, nm + ev.n_merges, nf + ev.n_fractures
        ovf = torch.maximum(ovf, ev.n_overflow)
        drop = drop + ev.n_dropped
        small = small | ev.cell_too_small
        if log_events:
            evs.append(dataclasses.replace(
                ev, touched=torch.zeros((0,), dtype=torch.bool, device=dev)))
    totals = dict(n_bounces=nb, n_merges=nm, n_fractures=nf, n_overflow=ovf,
                  n_dropped=drop, cell_too_small=small, n_uncorrected=unc)
    if log_events:
        return st, totals, _stack(evs)
    return st, totals
