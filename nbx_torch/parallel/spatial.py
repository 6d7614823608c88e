"""Spatially owned granular physics over a mesh of ranks: halo exchange,
O(N/D) memory (port of `nbx/parallel/spatial.py`).

The design is the JAX module's (see its docstring), on `torch.distributed`:

  * ownership is spatial: the collision grid's g x layers split into D slabs
    of W = g / D layers (with a 2-D mesh ("bx", "by"), x and y layers both);
    rank d holds the bodies of slab d in a fixed-capacity [nl] slot array
    (dead slots mass 0), and a persistent `uid` carries identity across
    ranks: contact timers key on the partner's uid;
  * migration: after the drift, bodies that left the slab go to the +-1
    neighbour through fixed-cap buffers (mig_cap rows a side) and land in
    dead slots; a body past the cap waits a step (n_mig_wait), one that
    finds no dead slot is dropped and counted (n_dropped);
  * halo exchange: each rank sends its boundary cell layer (halo_cap rows a
    side) to each neighbour, and the collision pass runs on a local
    [W + 2, g, g] slab grid (`ops.collide.packed_collision_blocks_local` /
    `bucketed_collision_blocks_local`): owned columns are targets, halo
    columns sources;
  * the event protocol: three exchanges (halo features; the halo rows'
    partner, timer and post-delta state; fracture kill flags back to the
    secondary parent's owner), gates evaluated by both owners on
    bitwise-symmetric pair quantities, merges into the lower-uid slot,
    fragments in the primary owner's dead slots;
  * gravity: "pm" deposits each rank's bodies on the pm_grid^3 CIC grid,
    sums the grid over the mesh (`all_reduce`) and solves it on every rank;
    "p3m" adds the erfc short range at a = cell / 3 inside the collision
    kernel (K7, `ops.collide.collide_fused_grav`), over the pairs the halo
    already brings; "zero" has none.

The JAX step's departures from the single-device scan are kept: fracture
draws are per rank (the JAX step folds the rank into its key; here each
rank's uniforms come in through `draws=`, or from the state's per-rank
generator), the fracture cap is per rank, partner ties on bitwise-equal
depths break by local row, and under target-cap overflow the dropped set at
a slab boundary follows each rank's local sort.

Exchanges: the JAX step's cyclic `ppermute` becomes one
`dist.batch_isend_irecv` per exchange and axis (a send to each neighbour and
a receive from each, tagged by direction). On an axis of size 1 the JAX
ppermute delivers to itself; here that is a local copy (a send to one's own
rank is refused by gloo). The wrapped sends of boundary ranks are kept:
their rows lie outside the receiver's grid, as in the JAX step. Reductions
are `all_reduce` over the whole mesh, which must span the process group's
world.

Everything the step computes stays on the mesh's device; the host reads
nothing back. A step on the card runs at world size 1 (NCCL puts one rank
on a card).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from nbx_torch import thermal
from nbx_torch.collisions import Draws, _make_fragments, draw_fracture_uniforms
from nbx_torch.collisions_scaled import _set_at
from nbx_torch.config import SimConfig, body_radius, f32
from nbx_torch.ops.collide import bucketed_collision_blocks_local, packed_collision_blocks_local
from nbx_torch.ops.p3m import take_rows
from nbx_torch.parallel.shard import _mark, mesh_device
from nbx_torch.profiling import spanned
from nbx_torch.state import make_generator

FORCE_IMPLS = ("pm", "p3m", "zero")


@dataclasses.dataclass(frozen=True)
class SpatialState:
    """This rank's slot arrays [nl]: only bodies inside its slab (or dead
    slots, or migrants in transit). uid_next is replicated on every rank: the
    next fresh uid for fragments. `generator` draws this rank's fracture
    uniforms when the step is given none."""

    pos: torch.Tensor  # [nl, 3] f32
    vel: torch.Tensor  # [nl, 3] f32
    acc: torch.Tensor  # [nl, 3] f32 (carried KDK acceleration)
    mass: torch.Tensor  # [nl] f32 (0 = dead slot)
    mat: torch.Tensor  # [nl] i32
    temp: torch.Tensor  # [nl] f32
    uid: torch.Tensor  # [nl] i32 persistent identity (-1 = dead slot)
    partner_uid: torch.Tensor  # [nl] i32 deepest partner's uid (-1 = none)
    contact_t: torch.Tensor  # [nl] f32
    uid_next: torch.Tensor  # [] i32 (replicated)
    generator: torch.Generator

    @property
    def device(self) -> torch.device:
        return self.pos.device

    def replace(self, **kwargs) -> "SpatialState":
        return dataclasses.replace(self, **kwargs)


class _Split(NamedTuple):
    two_d: bool
    d_x: int
    d_y: int
    w_x: int  # owned x layers a rank
    w_y: int  # owned y layers a rank (g for a 1-D mesh)
    me_x: int  # this rank's mesh coordinates
    me_y: int

    @property
    def me_lin(self) -> int:
        return self.me_x * self.d_y + self.me_y


def _mesh_split(mesh: DeviceMesh, n_cells: int) -> _Split:
    """The slab decomposition of a 1-axis or 2-axis mesh. A 1-axis mesh
    splits the grid's g x layers into d_x slabs (w_y = g); a 2-axis mesh
    ("bx", "by") splits x and y layers."""
    g = n_cells
    shape = tuple(mesh.mesh.shape)
    if len(shape) == 1:
        d = shape[0]
        if g % d:
            raise ValueError(f"n_cells={g} must divide over {d} devices")
        return _Split(False, d, 1, g // d, g, mesh.get_local_rank(0), 0)
    if len(shape) != 2:
        raise ValueError(f"spatial step wants a 1- or 2-axis mesh: {mesh.mesh_dim_names}")
    d_x, d_y = shape
    if g % d_x or g % d_y:
        raise ValueError(f"n_cells={g} must divide over the ({d_x}, {d_y}) mesh")
    return _Split(True, d_x, d_y, g // d_x, g // d_y, mesh.get_local_rank(0), mesh.get_local_rank(1))


def _destinations(pos: np.ndarray, box_size: float, g: int, sp: _Split) -> np.ndarray:
    """Each body's owning rank (linear mesh index), host-side."""
    cell = box_size / g
    cx = np.clip((pos[:, 0] / cell).astype(np.int64), 0, g - 1)
    dest = np.clip(cx // sp.w_x, 0, sp.d_x - 1) * sp.d_y
    if sp.two_d:
        cy = np.clip((pos[:, 1] / cell).astype(np.int64), 0, g - 1)
        dest = dest + np.clip(cy // sp.w_y, 0, sp.d_y - 1)
    return dest


def spatial_state_for(
    mesh: DeviceMesh,
    pos,
    vel,
    mass,
    box_size: float,
    n_cells: int,
    mat=None,
    temp=None,
    nl: int | None = None,
    slack: float = 1.5,
    seed: int = 0,
) -> SpatialState:
    """This rank's share of a global scene (host-side numpy, the same scene
    on every rank): the rows of the bodies inside its slab, in index order,
    then dead slots. nl (slots a rank) defaults to the most-loaded slab's
    count times `slack`, rounded up to 8: the headroom absorbs migration and
    fragment births before drops are counted. Dead input rows (mass <= 0)
    are dropped; a body's uid is its index in the input. The state lies on
    the mesh's device; its generator is seeded from (seed, rank)."""
    g = n_cells
    sp = _mesh_split(mesh, g)
    d = sp.d_x * sp.d_y
    pos = np.asarray(pos, np.float32)
    vel = np.asarray(vel, np.float32)
    mass = np.asarray(mass, np.float32)
    n = pos.shape[0]
    mat = np.zeros(n, np.int32) if mat is None else np.asarray(mat, np.int32)
    temp = np.zeros(n, np.float32) if temp is None else np.asarray(temp, np.float32)
    keep = mass > 0.0
    uid0 = np.nonzero(keep)[0].astype(np.int32)
    pos, vel, mass, mat, temp = pos[keep], vel[keep], mass[keep], mat[keep], temp[keep]
    dest = _destinations(pos, box_size, g, sp)
    counts = np.bincount(dest, minlength=d)
    if nl is None:
        nl = max(8, int(np.ceil(counts.max() * slack / 8)) * 8)
    if counts.max() > nl:
        raise ValueError(f"slab {counts.argmax()} holds {counts.max()} bodies > nl={nl}")
    rows = np.nonzero(dest == sp.me_lin)[0]
    k = rows.size
    dev = mesh_device(mesh)

    def slots(x, fill, dtype):
        out = np.full((nl, *x.shape[1:]), fill, dtype)
        out[:k] = x[rows]
        return torch.from_numpy(out).to(dev)

    z3 = torch.zeros((nl, 3), dtype=torch.float32, device=dev)
    return SpatialState(
        pos=slots(pos, 0.0, np.float32), vel=slots(vel, 0.0, np.float32), acc=z3,
        mass=slots(mass, 0.0, np.float32), mat=slots(mat, 0, np.int32), temp=slots(temp, 0.0, np.float32),
        uid=slots(uid0, -1, np.int32),
        partner_uid=torch.full((nl,), -1, dtype=torch.int32, device=dev),
        contact_t=torch.zeros((nl,), dtype=torch.float32, device=dev),
        uid_next=torch.tensor(n, dtype=torch.int32, device=dev),
        generator=make_generator(dev, int(np.random.SeedSequence([seed, sp.me_lin]).generate_state(1)[0])),
    )


def spatial_buckets_for(
    mesh: DeviceMesh,
    pos,
    box_size: float,
    n_cells: int,
    band_cells: int,
    split_quantile: float = 0.8,
    slack: float = 1.25,
    block_slack: float = 1.3,
) -> tuple[tuple[int, int, int], ...]:
    """Per-rank bucket sizing for make_spatial_granular_step(buckets=...),
    host-side on the global positions: caps from `bucketed_layout_for`, and
    each bucket's block budget the worst rank's count of its windows (times
    block_slack, a multiple of 8), since every rank launches its own budget
    of blocks. Python ints: call per scene, or when n_overflow goes
    nonzero."""
    from nbx_torch.ops.collide import (_window_counts, _window_max_strip_runs, bucket_flags_host,
                                       bucketed_layout_for)

    g = n_cells
    sp = _mesh_split(mesh, g)
    if isinstance(pos, torch.Tensor):
        pos = pos.detach().cpu().numpy()
    cnt, cnt_s = _window_counts(pos, box_size, g, band_cells)
    mrun = _window_max_strip_runs(pos, box_size, g, band_cells, cnt_s=cnt_s)
    caps = bucketed_layout_for(pos, box_size, g, band_cells, split_quantile=split_quantile, slack=slack,
                               block_slack=block_slack)
    cols = np.arange(g * g)
    ci, cj = cols // g, cols % g
    rank = (ci // sp.w_x) * sp.d_y
    if sp.two_d:
        rank = rank + np.clip(cj // sp.w_y, 0, sp.d_y - 1)
    rank = np.broadcast_to(rank[:, None], cnt.shape)
    out = []
    for (t, sc, _), fl in zip(caps, bucket_flags_host(cnt, mrun, caps)):
        m = int(np.bincount(rank[fl], minlength=sp.d_x * sp.d_y).max()) if fl.any() else 0
        out.append((t, sc, max(8, -(-int(np.ceil(m * block_slack)) // 8) * 8)))
    return tuple(out)


# ---- exchanges ------------------------------------------------------------------

class _Axis(NamedTuple):
    size: int
    left: int  # global rank of the -1 neighbour (cyclic)
    right: int  # global rank of the +1 neighbour


def _axis(mesh: DeviceMesh, sp: _Split, dim: int) -> _Axis:
    size = sp.d_x if dim == 0 else sp.d_y
    grid = mesh.mesh.reshape(sp.d_x, sp.d_y)

    def rank(dx: int, dy: int) -> int:
        return int(grid[(sp.me_x + dx) % sp.d_x, (sp.me_y + dy) % sp.d_y])

    if dim == 0:
        return _Axis(size, rank(-1, 0), rank(1, 0))
    return _Axis(size, rank(0, -1), rank(0, 1))


def _shift(ax: _Axis, to_right: torch.Tensor, to_left: torch.Tensor):
    """The JAX step's pair of cyclic ppermutes along one axis: to_right goes
    to the +1 neighbour and to_left to the -1 neighbour. Returns (from_left,
    from_right): what the -1 neighbour sent right and the +1 neighbour sent
    left. On an axis of size 1 both come back to this rank."""
    if ax.size == 1:
        return to_right, to_left
    to_right, to_left = to_right.contiguous(), to_left.contiguous()
    from_left, from_right = torch.empty_like(to_right), torch.empty_like(to_left)
    ops = [
        dist.P2POp(dist.isend, to_right, ax.right, tag=0),
        dist.P2POp(dist.irecv, from_left, ax.left, tag=0),
        dist.P2POp(dist.isend, to_left, ax.left, tag=1),
        dist.P2POp(dist.irecv, from_right, ax.right, tag=1),
    ]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return from_left, from_right


def _payload(rows_f: torch.Tensor, rows_i: torch.Tensor, idx: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Rows idx of (floats [n, F], int32 [n, I]) as one float32 [k, F + I]
    message, the ints carried by their bits; invalid rows are zeros and -1."""
    pf = torch.where(valid[:, None], rows_f[idx.long()], 0.0)
    pi = torch.where(valid[:, None], rows_i[idx.long()], -1)
    return torch.cat([pf, pi.contiguous().view(torch.float32)], dim=1)


def _split(msg: torch.Tensor, nf: int):
    """(floats [k, nf], int32 [k, I]) of a _payload message."""
    return msg[:, :nf], msg[:, nf:].contiguous().view(torch.int32)


@spanned("nbx.spatial.exchange")
def _exchange(ax: _Axis, rows_f, rows_i, sel_r, sel_l):
    """Send the rows selected by sel_r = (idx, valid) to the +1 neighbour
    and sel_l to the -1 neighbour; returns ((floats, ints) from the -1
    neighbour, (floats, ints) from the +1 neighbour)."""
    nf = rows_f.shape[1]
    a, b = _shift(ax, _payload(rows_f, rows_i, *sel_r), _payload(rows_f, rows_i, *sel_l))
    return _split(a, nf), _split(b, nf)


def _count(mask: torch.Tensor) -> torch.Tensor:
    return mask.sum(dtype=torch.int64)


# ---- the step ---------------------------------------------------------------------

def render_spatial(mesh: DeviceMesh, state: SpatialState, cfg: SimConfig, cam, width: int = 640,
                   height: int = 360, exposure: float = 4.0) -> torch.Tensor:
    """Render from spatial ownership: every rank splats its own slab's live
    slots (material colours, temperature glow) into an HDR buffer, one
    all_reduce (sum) over the mesh composites the additive image, and the
    tonemap runs on every rank. No body is gathered; the frame is [H, W, 3]
    whatever N is. The splats commute, so the composite equals the gathered
    state's single-device splat up to float32 summation order (bit for bit
    at D = 1)."""
    from nbx_torch.render.colormap import tonemap
    from nbx_torch.render.splat import splat_bodies_hdr

    mats = cfg.materials
    radius = body_radius(state.mass, state.mat, mats)
    hdr = splat_bodies_hdr(state.pos, radius, state.temp, state.mat, state.mass > 0.0, mats.color1, mats.color2,
                           cam, width=width, height=height)
    for dim in range(mesh.ndim):
        dist.all_reduce(hdr, group=mesh.get_group(dim))
    return tonemap(hdr, exposure)


def make_spatial_granular_step(
    mesh: DeviceMesh,
    cfg: SimConfig,
    box_size: float,
    n_cells: int,
    band_cells: int,
    packed_caps: tuple[int, int],
    halo_cap: int,
    mig_cap: int,
    force_impl: str = "pm",
    pm_grid: int = 128,
    buckets: Optional[tuple[tuple[int, int, int], ...]] = None,
):
    """The halo-exchange granular step of this rank (module docstring). Every
    rank of the mesh builds it and calls it, step for step.

    With buckets=((t1, s1, m1), ...) the local pass runs the
    occupancy-bucketed layout (size it with spatial_buckets_for) and
    packed_caps is ignored. The mesh may have one axis (x slabs) or two
    ("bx", "by": x and y slabs); in 2-D each protocol phase runs per axis, x
    first: migration hops x then y in one step, the y halo forwards the
    corner rows of the x halo, and fracture kill flags retrace that route.

    Returns step(state: SpatialState, h: float, draws: Draws | None = None)
    -> (state, counters): counters are the at-scale scan's n_bounces,
    n_merges, n_fractures, n_overflow, n_dropped, cell_too_small, and the
    protocol's n_mig_wait (movers past mig_cap, delayed a step), n_halo_over
    (boundary bodies past halo_cap) and in_transit (bodies between slabs),
    each summed (cell_too_small: or-ed) over the mesh, as 0-dim tensors on
    the device. `draws` are this rank's fracture uniforms; None draws them
    from state.generator."""
    g = n_cells
    sp = _mesh_split(mesh, g)
    n_dev = sp.d_x * sp.d_y
    if force_impl not in FORCE_IMPLS:
        raise ValueError(
            "spatial step supports force_impl 'pm' | 'p3m' | 'zero' (direct-sum gravity needs the "
            "all-gather design: make_sharded_granular_step)"
        )
    if n_dev != dist.get_world_size():
        raise ValueError(f"the mesh holds {n_dev} ranks, the world {dist.get_world_size()}: "
                         "the spatial step reduces over the whole world")
    dev = mesh_device(mesh)
    cfg = cfg.to(dev)
    green_hat = None
    if force_impl in ("pm", "p3m"):
        from nbx_torch.ops.pm import _isolated_solve_r, cic_deposit, cic_gather, isolated_green_hat

        if force_impl == "p3m":
            # the split scale tied to the collision grid (a = cell / 3): the
            # erfc short range then reaches +-1 cell, the halo's reach, and is
            # summed inside the collision kernel (K7)
            if pm_grid < 3 * g:
                raise ValueError(f"p3m needs pm_grid >= 3 * n_cells (= {3 * g}) so the mesh resolves the "
                                 f"split scale a = cell/3; got {pm_grid}")
            green_hat = isolated_green_hat(box_size, pm_grid, box_size / g / 3.0, smoothed=True, device=dev)
        else:
            green_hat = isolated_green_hat(box_size, pm_grid, device=dev)

    f_cap = cfg.max_fractures
    H, M = halo_cap, mig_cap
    n_halo = 4 * H if sp.two_d else 2 * H
    ax_x = _axis(mesh, sp, 0)
    ax_y = _axis(mesh, sp, 1) if sp.two_d else None
    x0_cell = sp.me_x * sp.w_x - 1
    y0_cell = sp.me_y * sp.w_y - 1 if sp.two_d else 0
    slab_y = sp.w_y if sp.two_d else None
    short_gravity = (cfg.G, box_size / g / 3.0, cfg.softening) if force_impl == "p3m" else None
    cell = torch.full((), f32(box_size / g), dtype=torch.float32, device=dev)
    i32 = torch.int32

    def cell_of(x: torch.Tensor) -> torch.Tensor:
        return (x / cell).to(i32).clamp(0, g - 1)

    def migrate(pos, vel, mass, mat, temp, uid, p_uid, ct, coord: int, me: int, w: int, ax: _Axis):
        """One +-1 hop along one axis; returns the slots and (wait, drop)."""
        nl = pos.shape[0]
        alive = mass > 0.0
        dest = (cell_of(pos[:, coord]) // w).clamp(0, ax.size - 1)
        go_r = alive & (dest > me)
        go_l = alive & (dest < me)
        sel_r = take_rows(go_r, M)
        sel_l = take_rows(go_l, M)
        wait = _count(go_r) - _count(sel_r[1]) + _count(go_l) - _count(sel_l[1])
        mig_f = torch.cat([pos, vel, mass[:, None], temp[:, None], ct[:, None]], dim=1)  # [nl, 9]
        mig_i = torch.stack([mat, uid, p_uid], dim=1)  # [nl, 3]
        (rf_l, ri_l), (rf_r, ri_r) = _exchange(ax, mig_f, mig_i, sel_r, sel_l)
        # kill the sent rows
        sent = torch.zeros(nl, dtype=torch.bool, device=dev)
        for idx, v in (sel_r, sel_l):
            sent = _mark(sent, torch.where(v, idx.long(), nl))
        mass = torch.where(sent, 0.0, mass)
        uid = torch.where(sent, -1, uid)
        # arrivals into the first dead slots, in arrival order
        arr_f = torch.cat([rf_l, rf_r])  # [2M, 9]
        arr_i = torch.cat([ri_l, ri_r])  # [2M, 3]
        ok = (arr_i[:, 1] >= 0) & (arr_f[:, 6] > 0.0)
        slot_of, sv = take_rows(mass <= 0.0, 2 * M)
        slot_of = torch.where(sv, slot_of.long(), nl)
        rrank = torch.cumsum(ok.long(), 0) - 1
        slot = torch.where(ok, slot_of[rrank.clamp(0, 2 * M - 1)], nl)
        placed = ok & (slot < nl)
        slot = torch.where(placed, slot, nl)
        drop = _count(ok) - _count(placed)
        pos = _set_at(pos, slot, arr_f[:, 0:3])
        vel = _set_at(vel, slot, arr_f[:, 3:6])
        mass = _set_at(mass, slot, arr_f[:, 6])
        temp = _set_at(temp, slot, arr_f[:, 7])
        ct = _set_at(ct, slot, arr_f[:, 8])
        mat = _set_at(mat, slot, arr_i[:, 0])
        uid = _set_at(uid, slot, arr_i[:, 1])
        p_uid = _set_at(p_uid, slot, arr_i[:, 2])
        return pos, vel, mass, mat, temp, uid, p_uid, ct, wait, drop

    def step(state: SpatialState, h: float, draws: Optional[Draws] = None):
        h32 = f32(h)
        half = f32(0.5 * h32)
        pos, vel, acc, mass = state.pos, state.vel, state.acc, state.mass
        mat, temp, uid, p_uid, ct = state.mat, state.temp, state.uid, state.partner_uid, state.contact_t
        nl = pos.shape[0]

        # ---- KDK first half ----------------------------------------------------
        vel = vel + acc * half
        pos = pos + vel * h32

        # ---- migration: one +-1 hop an axis a step, x then y -------------------
        pos, vel, mass, mat, temp, uid, p_uid, ct, wait_t, drop_t = migrate(
            pos, vel, mass, mat, temp, uid, p_uid, ct, 0, sp.me_x, sp.w_x, ax_x)
        if sp.two_d:
            pos, vel, mass, mat, temp, uid, p_uid, ct, w2, d2 = migrate(
                pos, vel, mass, mat, temp, uid, p_uid, ct, 1, sp.me_y, sp.w_y, ax_y)
            wait_t, drop_t = wait_t + w2, drop_t + d2

        # ---- halo exchange 1: boundary cell layers -------------------------------
        alive = mass > 0.0
        cx = cell_of(pos[:, 0])
        transit = (cx // sp.w_x).clamp(0, sp.d_x - 1) != sp.me_x
        if sp.two_d:
            transit = transit | ((cell_of(pos[:, 1]) // sp.w_y).clamp(0, sp.d_y - 1) != sp.me_y)
        in_transit = alive & transit
        settled = alive & ~in_transit
        # an axis of size 1 has no neighbour: its halo selection is empty (the
        # JAX ppermute would deliver boundary bodies back as clones)
        if sp.d_x > 1:
            lay_l = settled & (cx == sp.me_x * sp.w_x)
            lay_r = settled & (cx == (sp.me_x + 1) * sp.w_x - 1)
        else:
            lay_l = lay_r = torch.zeros(nl, dtype=torch.bool, device=dev)
        selh_l = take_rows(lay_l, H)
        selh_r = take_rows(lay_r, H)
        halo_over = _count(lay_l) - _count(selh_l[1]) + _count(lay_r) - _count(selh_r[1])
        hal_f = torch.cat([pos, vel, mass[:, None]], dim=1)  # [nl, 7]
        hal_i = torch.stack([mat, uid], dim=1)  # [nl, 2]
        # my right layer -> the right neighbour's left halo, and so on
        (hf_L, hi_L), (hf_R, hi_R) = _exchange(ax_x, hal_f, hal_i, selh_r, selh_l)
        hf = torch.cat([hf_L, hf_R])
        hi = torch.cat([hi_L, hi_R])

        # ---- halo phase y (2-D): own rows and the forwarded x-halo corners -----
        if sp.two_d:
            hal_fc = torch.cat([hal_f, hf])
            hal_ic = torch.cat([hal_i, hi])
            cyc = cell_of(hal_fc[:, 1])
            # x-halo rows qualify only if their x cell lies in my local grid: an
            # x-boundary rank also receives the cyclic wrap's rows
            cx_h = cell_of(hf[:, 0]) - x0_cell
            halo_ok = (hf[:, 6] > 0.0) & (cx_h >= 0) & (cx_h < sp.w_x + 2)
            cand = torch.cat([settled, halo_ok])
            if sp.d_y > 1:
                lay_d = cand & (cyc == sp.me_y * sp.w_y)
                lay_u = cand & (cyc == (sp.me_y + 1) * sp.w_y - 1)
            else:
                lay_d = lay_u = torch.zeros_like(cand)
            sely_d = take_rows(lay_d, H)
            sely_u = take_rows(lay_u, H)
            halo_over = halo_over + (_count(lay_d) - _count(sely_d[1]) + _count(lay_u) - _count(sely_u[1]))
            (yf_D, yi_D), (yf_U, yi_U) = _exchange(ax_y, hal_fc, hal_ic, sely_u, sely_d)
            hf = torch.cat([hf, yf_D, yf_U])
            hi = torch.cat([hi, yi_D, yi_U])
        pos_h, vel_h, mass_h = hf[:, 0:3], hf[:, 3:6], hf[:, 6]
        mat_h, uid_h = hi[:, 0], hi[:, 1]

        # ---- gravity on the post-migration slots --------------------------------
        if force_impl == "zero":
            acc_new = torch.zeros_like(pos)
        else:
            rho = cic_deposit(pos, mass, box_size, pm_grid, periodic=False)
            dist.all_reduce(rho)
            acc_grid = _isolated_solve_r(rho, cfg.G, box_size, pm_grid, green_hat)
            acc_new = cic_gather(acc_grid, pos, box_size, pm_grid, periodic=False)
            # p3m: the erfc short range joins from the collision kernel below

        # ---- the collision pass on the local slab grid -----------------------------
        pos_a = torch.cat([pos, pos_h])
        vel_a = torch.cat([vel, vel_h])
        mass_a = torch.cat([mass, mass_h])
        mat_a = torch.cat([mat, mat_h])
        uid_a = torch.cat([uid, uid_h])
        rad_a = body_radius(mass_a, mat_a, cfg.materials)
        n_all = nl + n_halo
        args = (pos_a, vel_a, mass_a, rad_a, box_size, g, band_cells)
        layout = dict(y0_cell=y0_cell, slab_y=slab_y, short_gravity=short_gravity)
        if buckets is not None:
            outs = bucketed_collision_blocks_local(*args, buckets, cfg.restitution, cfg.friction, x0_cell,
                                                   sp.w_x, **layout)
        else:
            outs = packed_collision_blocks_local(*args, packed_caps, cfg.restitution, cfg.friction, x0_cell,
                                                 sp.w_x, **layout)
        if short_gravity is not None:
            out_d, out_j, out_g, novf = outs
            acc_new = acc_new + out_g[:nl]
        else:
            out_d, out_j, novf = outs
        bounces = out_d[:nl, 7].sum()
        r_max = rad_a.max()
        od = out_d[:nl]

        # the partner's pair quantities from the pre-delta local state
        has = out_j[:nl] >= 0
        jcl = torch.where(has, out_j[:nl].long(), n_all - 1).clamp(0, n_all - 1)
        dd = pos_a[jcl] - pos
        r2b = (dd * dd).sum(-1)
        invb = torch.rsqrt(torch.where(r2b > 0.0, r2b, 1.0))
        vnb = ((vel_a[jcl] - vel) * dd).sum(-1) * invb
        m_j = mass_a[jcl]
        m_sum = mass + m_j
        r_msb = 1.0 / torch.where(m_sum > 0.0, m_sum, 1.0)
        e_b = 0.5 * (mass * m_j * r_msb) * vnb * vnb
        q_l = torch.where(has, e_b * r_msb, 0.0)
        appr_l = has & (vnb < 0.0)

        # the pass's Jacobi deltas on the owned rows
        pos = pos + od[:, 3:6]
        vel = vel + od[:, 0:3]
        temp = temp + od[:, 6]

        # ---- contact timers on the partner's uid --------------------------------
        pu_new = torch.where(has, uid_a[jcl], -1)
        same = has & (pu_new == p_uid) & (pu_new >= 0)
        ct = torch.where(has, torch.where(same, ct + h32, h32), 0.0)

        # ---- exchange 2: the halo rows' decision fields and post-delta state ----
        dec_f = torch.cat([pos, vel, temp[:, None], ct[:, None]], dim=1)  # [nl, 8]
        dec_i = pu_new[:, None]
        (df_L, di_L), (df_R, di_R) = _exchange(ax_x, dec_f, dec_i, selh_r, selh_l)
        df = torch.cat([df_L, df_R])
        di = torch.cat([di_L, di_R])
        if sp.two_d:
            # phase y forwards halo phase y's selection of [own; x-halo] rows
            (dfy_D, diy_D), (dfy_U, diy_U) = _exchange(ax_y, torch.cat([dec_f, df]), torch.cat([dec_i, di]),
                                                       sely_u, sely_d)
            df = torch.cat([df, dfy_D, dfy_U])
            di = torch.cat([di, diy_D, diy_U])
        pos2_a = torch.cat([pos, df[:, 0:3]])
        vel2_a = torch.cat([vel, df[:, 3:6]])
        temp2_a = torch.cat([temp, df[:, 6]])
        ct_a = torch.cat([ct, df[:, 7]])
        pu_a = torch.cat([pu_new, di[:, 0]])

        # ---- event gates on mutual partners -------------------------------------
        mutual = has & (uid >= 0) & (pu_a[jcl] == uid)
        t_pair = torch.minimum(ct, ct_a[jcl])
        merge_m = (mutual & appr_l & (t_pair > f32(cfg.merge_time))
                   & (q_l < f32(cfg.fracture_threshold) * 2.0))
        fract_m = (mutual & appr_l & ~merge_m & (q_l > f32(cfg.fracture_threshold))
                   & ((mass > f32(cfg.min_fragment_mass)) | (m_j > f32(cfg.min_fragment_mass))))
        lower = uid < pu_new
        prim_m = merge_m & lower
        kill_m = merge_m & ~lower
        prim_f = fract_m & lower

        # ---- merges in place into the lower-uid slot -----------------------------
        tot = mass + m_j
        safe_tot = torch.where(tot > 0, tot, 1.0)
        mpos = (pos * mass[:, None] + pos2_a[jcl] * m_j[:, None]) / safe_tot[:, None]
        mvel = (vel * mass[:, None] + vel2_a[jcl] * m_j[:, None]) / safe_tot[:, None]
        mtemp = (temp * mass + temp2_a[jcl] * m_j) / safe_tot
        mmat = torch.where(mass > m_j, mat, mat_a[jcl])  # the heavier body's

        # the fracture payload, before the merge and kill writes
        f_safe = torch.where(fract_m, tot, 1.0)
        f_com = (pos * mass[:, None] + pos2_a[jcl] * m_j[:, None]) / f_safe[:, None]
        f_bvel = (vel * mass[:, None] + vel2_a[jcl] * m_j[:, None]) / f_safe[:, None]
        e_best = torch.where(fract_m, e_b, 0.0)
        f_temp = torch.maximum(temp, temp2_a[jcl]) + (e_best / f_safe) * 0.1
        f_mat = torch.where(mass > m_j, mat, mat_a[jcl])
        f_rsum = rad_a[:nl] + rad_a[jcl]

        pm2 = prim_m[:, None]
        pos = torch.where(pm2, mpos, pos)
        vel = torch.where(pm2, mvel, torch.where(kill_m[:, None], 0.0, vel))
        temp = torch.where(prim_m, mtemp, torch.where(kill_m, 0.0, temp))
        mat = torch.where(prim_m, mmat, mat)
        mass = torch.where(prim_m, tot, torch.where(kill_m, 0.0, mass))
        uid = torch.where(kill_m, -1, uid)

        # ---- fractures: this rank's extraction and fragments ----------------------
        fi, f_valid = take_rows(prim_f, f_cap)
        fi = fi.long()
        if draws is None:
            draws = draw_fracture_uniforms(cfg, state.generator, dev)
        frag = _make_fragments(draws, cfg, f_valid, f_com[fi], f_bvel[fi],
                               torch.where(f_valid, e_best[fi], 0.0), tot[fi], f_temp[fi], f_mat[fi],
                               f_rsum[fi])
        # kill the accepted parents: my rows directly, a halo partner's through
        # kill flags that retrace the halo's route
        fkill = torch.zeros(nl, dtype=torch.bool, device=dev)
        fkill = _mark(fkill, torch.where(f_valid, fi, nl))
        fj = torch.where(f_valid, jcl[fi], n_all)
        fkill = _mark(fkill, torch.where(fj < nl, fj, nl))
        flag_h = torch.zeros(n_halo, dtype=torch.float32, device=dev)
        flag_h = _mark(flag_h, torch.where(fj >= nl, fj - nl, n_halo))
        flag_x = flag_h[:2 * H]
        if sp.two_d:
            # y returns first: flags of my y-halo rows go back to their sender,
            # aligned with its phase-y selection over [own; x-halo]; own rows
            # die there, x-halo rows go on in the x return (the corner's hop)
            flag_y = flag_h[2 * H:]
            back_up, back_dn = _shift(ax_y, flag_y[H:], flag_y[:H])
            # back_dn aligns with my upward selection, back_up with my downward
            yk_u = torch.where(sely_u[1] & (back_dn > 0), sely_u[0].long(), nl + 2 * H)
            yk_d = torch.where(sely_d[1] & (back_up > 0), sely_d[0].long(), nl + 2 * H)
            xfwd = torch.zeros(2 * H, dtype=torch.float32, device=dev)
            for yk in (yk_u, yk_d):
                fkill = _mark(fkill, torch.where(yk < nl, yk, nl))
                xfwd = _mark(xfwd, torch.where((yk >= nl) & (yk < nl + 2 * H), yk - nl, 2 * H))
            flag_x = torch.maximum(flag_x, xfwd)
        back_r, back_l = _shift(ax_x, flag_x[H:], flag_x[:H])
        # back_l aligns with my right layer's selection, back_r with my left's
        fkill = _mark(fkill, torch.where(selh_r[1] & (back_l > 0), selh_r[0].long(), nl))
        fkill = _mark(fkill, torch.where(selh_l[1] & (back_r > 0), selh_l[0].long(), nl))
        mass = torch.where(fkill, 0.0, mass)
        vel = torch.where(fkill[:, None], 0.0, vel)
        temp = torch.where(fkill, 0.0, temp)
        uid = torch.where(fkill, -1, uid)

        # ---- fragments into the first dead slots -----------------------------------
        n_fk = frag["mask"].shape[0]  # F * K
        slot_of2, sv2 = take_rows(mass <= 0.0, n_fk)
        slot_of2 = torch.where(sv2, slot_of2.long(), nl)
        frank = torch.cumsum(frag["mask"].long(), 0) - 1
        fslot = torch.where(frag["mask"], slot_of2[frank.clamp(0, n_fk - 1)], nl)
        fplaced = frag["mask"] & (fslot < nl)
        fslot = torch.where(fplaced, fslot, nl)
        mass = _set_at(mass, fslot, frag["mass"])
        pos = _set_at(pos, fslot, frag["pos"])
        vel = _set_at(vel, fslot, frag["vel"])
        temp = _set_at(temp, fslot, frag["temp"])
        mat = _set_at(mat, fslot, frag["mat"])
        new_uid = state.uid_next + sp.me_lin * n_fk + torch.arange(n_fk, dtype=i32, device=dev)
        uid = _set_at(uid, fslot, new_uid)
        uid_next = state.uid_next + n_dev * n_fk

        # ---- reset the contact record of every touched slot ------------------------
        touched = _mark(prim_m | kill_m | fkill, fslot)
        pu_new = torch.where(touched, -1, pu_new)
        ct = torch.where(touched, 0.0, ct)
        acc_new = torch.where(touched[:, None], 0.0, acc_new)  # newborns: acc = 0

        # ---- second half-kick, thermal decay ----------------------------------------
        vel = vel + acc_new * half
        temp = thermal.decay(temp, cfg.heat_decay)

        # ---- counters, summed over the mesh -------------------------------------------
        dropped = (_count(prim_f) - _count(f_valid)) + (_count(frag["mask"]) - _count(fplaced)) + drop_t
        ints = torch.stack([_count(prim_m), _count(prim_f), novf.long(), dropped, wait_t, halo_over,
                            _count(in_transit)])
        dist.all_reduce(ints)
        dist.all_reduce(bounces)
        dist.all_reduce(r_max, op=dist.ReduceOp.MAX)
        ints = ints.to(i32)
        counters = dict(
            n_merges=ints[0], n_fractures=ints[1], n_bounces=(bounces / 2.0).to(i32), n_overflow=ints[2],
            n_dropped=ints[3], cell_too_small=2.0 * r_max > cell, n_mig_wait=ints[4], n_halo_over=ints[5],
            in_transit=ints[6],
        )
        new_state = state.replace(pos=pos, vel=vel, acc=acc_new, mass=mass, mat=mat, temp=temp, uid=uid,
                                  partner_uid=pu_new, contact_t=ct, uid_next=uid_next)
        return new_state, counters

    return step
