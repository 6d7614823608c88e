"""Device meshes and the all-gather multi-device paths (port of
`nbx/parallel/shard.py`).

A mesh here is a `torch.distributed.device_mesh.DeviceMesh` over the ranks of
an initialised process group, one rank a device: ("b",), or a factored 2-D
mesh. Nothing here starts processes or names a cluster: the caller runs
`torch.distributed.init_process_group` in every rank, with its address, world
size and rank. The meshes are built on the card ("cuda", one rank a card,
NCCL) unless the caller asks for the CPU ("cpu", gloo).

The all-gather design is the JAX module's (see its docstring): rank d of a
mesh of D holds rows [d N/D, (d + 1) N/D) of every body field (a 2-D mesh
("b", "j") holds shard b |j| + j) and every step is the same program on each
rank, on `torch.distributed` collectives over the mesh's groups:

  * `lax.all_gather(tiled=True)` is `dist.all_gather_into_tensor`; the
    fields one gather takes travel as one float32 message (int32 and bool
    fields by their bits);
  * `psum_scatter` is `dist.reduce_scatter_tensor`, `psum` / `pmax` are
    `dist.all_reduce` (counters as int32; flags as an int32 MAX);
  * `ppermute` (the ring) is one `dist.batch_isend_irecv` a hop: a send to
    rank + 1 and a receive from rank - 1, which on a ring of 2 are one peer.

Paths: the gravity-only KDK step (1-D, 2-D and ring), the energies and
`run_sharded`; `render_sharded` (each rank splats its rows, one all_reduce
composites the HDR image); the dense full-physics step; the column-slab sharded
collision pass and the granular step on it, whose collision pass is
`ops.collide.packed_collision_blocks_slab` (the kernel K2) over the slab of
columns [d g^2/D, (d + 1) g^2/D) of the gathered state: each rank's rows
outside its slab are zero deltas and partner -1, and a reduce-scatter (sum
for the deltas, max for the partners) rebuilds each rank's rows of the
whole-grid pass exactly. Fractures are replicated arithmetic on gathered
events, as in the JAX step: every rank must get the same fracture uniforms
(`draws=`, or the step's own generator, seeded alike on every rank).

The forces run where the tensors lie: K1 (`ops.pairwise.pairwise_acc`) and
K3 (`potential_per_body`) on the card, their plain versions on the CPU. The
JAX package's `impl` ("auto" | "pallas" | "jnp") is accepted and changes
nothing. Nothing a step computes is read back to the host.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from nbx_torch import thermal
from nbx_torch.collisions import Draws, _make_fragments, draw_fracture_uniforms
from nbx_torch.collisions_scaled import _set_at
from nbx_torch.config import SimConfig, body_radius, f32, inverse_mass
from nbx_torch.ops.collide import packed_collision_blocks_slab, partner_record
from nbx_torch.ops.p3m import take_rows
from nbx_torch.ops.pairwise import pairwise_acc, potential_per_body
from nbx_torch.profiling import span, spanned
from nbx_torch.state import make_generator

IMPLS = ("auto", "pallas", "jnp")  # the JAX package's force impls; the device decides here
GRANULAR_FORCES = ("auto", "pallas", "jnp", "pm", "zero")


def make_mesh(n_devices: int | None = None, axes=("b",), device_type: str = "cuda") -> DeviceMesh:
    """A 1-D mesh of n_devices ranks (default: the whole world) named
    axes[0], or with two axes a near-square factored 2-D mesh (a, n / a), a
    the largest divisor of n not above sqrt(n), as the JAX package factors
    it. Rank r sits at (r // (n / a), r % (n / a)). Every rank of the world
    must call it (a 2-D mesh makes a group for each row and column)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group (torch.distributed.init_process_group)")
    n = n_devices or dist.get_world_size()
    if n > dist.get_world_size():
        raise ValueError(f"a mesh of {n} ranks in a world of {dist.get_world_size()}")
    if len(axes) == 1:
        shape = (n,)
    elif len(axes) == 2:
        a = int(n**0.5)
        while n % a:
            a -= 1
        shape = (a, n // a)
    else:
        raise ValueError(f"make_mesh takes one or two axes, got {axes}")
    return DeviceMesh(device_type, torch.arange(n).reshape(shape), mesh_dim_names=tuple(axes))


@contextlib.contextmanager
def local_world(backend: str):
    """A process group of this process alone (rank 0 of a world of 1, an
    in-memory store) with `backend` ("nccl", "gloo", or "cpu:gloo,cuda:nccl"
    for meshes on the card and on the CPU in one process), for a
    multi-device path on one device; destroyed on exit. If a group is
    initialised already, it is used as it is and left alone."""
    if dist.is_initialized():
        yield
        return
    dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device of this rank's tensors on the mesh."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


# ---- mesh axes and collectives ---------------------------------------------------

class _Axis(NamedTuple):
    group: dist.ProcessGroup
    size: int
    index: int  # this rank's coordinate along the axis (its rank in `group`)
    ranks: tuple  # the global ranks along the axis through this rank, in axis order


def _axis(mesh: DeviceMesh, dim: int) -> _Axis:
    coord = mesh.get_coordinate()
    line = list(coord)
    line[dim] = slice(None)
    ranks = tuple(int(r) for r in mesh.mesh[tuple(line)].tolist())
    group = mesh.get_group(dim)
    index = coord[dim]
    if dist.get_group_rank(group, dist.get_rank()) != index:
        raise RuntimeError(f"mesh axis {dim}: group rank {dist.get_group_rank(group, dist.get_rank())} is not "
                           f"the mesh coordinate {index}")
    return _Axis(group, len(ranks), index, ranks)


def _axis_1d(mesh: DeviceMesh, what: str) -> _Axis:
    if mesh.ndim != 1:
        raise ValueError(f"{what} wants a 1-D mesh ('b',), got axes {mesh.mesh_dim_names}")
    return _axis(mesh, 0)


def _as_f32(x: torch.Tensor) -> torch.Tensor:
    """[n, k] float32 columns of a float32, int32 or bool [n] / [n, k] field
    (the ints by their bits, bools as int32 0 / 1)."""
    x = x[:, None] if x.dim() == 1 else x
    if x.dtype == torch.bool:
        x = x.to(torch.int32)
    return x.view(torch.float32) if x.dtype == torch.int32 else x


@spanned("nbx.gather")
def _gather(ax: _Axis, *fields: torch.Tensor) -> list:
    """lax.all_gather(tiled=True) of this rank's rows of each field along the
    axis, in one collective: each field's [size n, ...] rows of every rank in
    axis order, with its dtype."""
    msg = torch.cat([_as_f32(f) for f in fields], dim=1).contiguous()
    out = msg.new_empty((ax.size * msg.shape[0], msg.shape[1]))
    dist.all_gather_into_tensor(out, msg, group=ax.group)
    res, c = [], 0
    for f in fields:
        k = 1 if f.dim() == 1 else f.shape[1]
        col = out[:, c:c + k]
        c += k
        if f.dtype != torch.float32:
            col = col.contiguous().view(torch.int32)
            if f.dtype == torch.bool:
                col = col != 0
        res.append(col[:, 0] if f.dim() == 1 else col)
    return res


@spanned("nbx.reduce_scatter")
def _reduce_scatter(ax: _Axis, x: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """psum_scatter(tiled=True) of x [size n, ...] along the axis: this rank's
    chunk of the reduction over the axis."""
    x = x.contiguous()
    out = x.new_empty((x.shape[0] // ax.size, *x.shape[1:]))
    dist.reduce_scatter_tensor(out, x, op=op, group=ax.group)
    return out


def _ppermute(x: torch.Tensor, to: int, frm: int) -> torch.Tensor:
    """One ring hop: send x to global rank `to`, receive its like from
    global rank `frm` (one peer on a ring of 2)."""
    x = x.contiguous()
    got = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, to), dist.P2POp(dist.irecv, got, frm)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return got


def _count(mask: torch.Tensor) -> torch.Tensor:
    return mask.sum(dtype=torch.int32)


def _check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")


@spanned("nbx.gravity")
def _local_acc(pos_all, mass_all, pos_local, G: float, eps: float, impl: str = "auto") -> torch.Tensor:
    """Force of all bodies on the local shard (the rectangular problem): K1
    on the card, its plain version on the CPU. `impl` (checked by the
    callers) is accepted for callers written for the JAX package; the
    tensors' device decides."""
    return pairwise_acc(pos_all, mass_all, G, eps, target_pos=pos_local)


# ---- placement ---------------------------------------------------------------------

def _shard_index(mesh: DeviceMesh) -> int:
    """This rank's shard of the body axis: its row-major index on the mesh
    (b |j| + j on a 2-D mesh, the layout P(("b", "j")))."""
    idx = 0
    for c, s in zip(mesh.get_coordinate(), mesh.mesh.shape):
        idx = idx * int(s) + c
    return idx


def _placer(mesh: DeviceMesh, n: int):
    """put(x, dtype): this rank's rows of a global array (numpy or torch) on
    the mesh's device. N must divide evenly (pad with mass-0 bodies)."""
    d = mesh.size()
    if n % d:
        raise ValueError(f"N={n} not divisible by mesh size {d}; pad with mass-0")
    nl = n // d
    rows = slice(_shard_index(mesh) * nl, (_shard_index(mesh) + 1) * nl)
    dev = mesh_device(mesh)

    def put(x, dtype=torch.float32):
        return torch.as_tensor(x)[rows].to(dev, dtype).contiguous()

    return put


class ShardedState(NamedTuple):
    """Gravity-only phase state: this rank's rows of the body axis."""

    pos: torch.Tensor  # [N/D, 3]
    vel: torch.Tensor  # [N/D, 3]
    acc: torch.Tensor  # [N/D, 3]
    mass: torch.Tensor  # [N/D]


def shard_state(mesh: DeviceMesh, pos, vel, mass) -> ShardedState:
    """This rank's shard of a global scene (the same arrays on every rank) on
    a 1-D mesh, on the mesh's device. N must divide evenly (pad with mass-0
    bodies otherwise: they exert zero force). acc starts at 0, as a newborn
    body's does."""
    if mesh.ndim != 1:
        raise ValueError(f"shard_state places on a 1-D mesh; use shard_state2d on {mesh.mesh_dim_names}")
    return _shard_gravity(mesh, pos, vel, mass)


def shard_state2d(mesh: DeviceMesh, pos, vel, mass) -> ShardedState:
    """The 2-D mesh's placement: the body axis over both axes, "b" major and
    "j" minor (shard b |j| + j), the layout make_sharded_step_2d expects."""
    if mesh.ndim != 2:
        raise ValueError(f"shard_state2d places on a 2-D mesh ('b', 'j'), got {mesh.mesh_dim_names}")
    return _shard_gravity(mesh, pos, vel, mass)


def _shard_gravity(mesh, pos, vel, mass) -> ShardedState:
    put = _placer(mesh, len(pos))
    p = put(pos)
    return ShardedState(p, put(vel), torch.zeros_like(p), put(mass))


# ---- gravity-only steps --------------------------------------------------------------

def _halves(h: float) -> tuple[float, float]:
    h32 = f32(h)
    return h32, f32(0.5 * h32)


def make_sharded_step(mesh: DeviceMesh, impl: str = "auto"):
    """The sharded KDK substep on a 1-D mesh: step(state, G, eps, h) ->
    state. Half-kick, drift, all-gather of positions and masses, the force
    of every body on this rank's rows, half-kick: the integration semantics
    of the single-device gravity path (`integrators.kdk_step`)."""
    _check_impl(impl)
    ax = _axis_1d(mesh, "make_sharded_step")

    @spanned("nbx.shard.step")
    def step(state: ShardedState, G: float, eps: float, h: float) -> ShardedState:
        h32, half = _halves(h)
        vel = state.vel + state.acc * half
        pos = state.pos + vel * h32
        pos_all, mass_all = _gather(ax, pos, state.mass)
        acc = _local_acc(pos_all, mass_all, pos, G, eps, impl)
        vel = vel + acc * half
        return ShardedState(pos, vel, acc, state.mass)

    return step


def make_sharded_step_2d(mesh: DeviceMesh, impl: str = "auto"):
    """The 2-D mesh's variant (mesh axes ("b", "j"), shard_state2d's
    layout): each rank gathers its "b" row's bodies over "j" and a strided
    1/|j| subset of the sources over "b", computes the partial force of that
    subset on the row, and a reduce-scatter over "j" completes the sum and
    returns this rank's rows."""
    _check_impl(impl)
    if mesh.ndim != 2:
        raise ValueError(f"make_sharded_step_2d wants a 2-D mesh ('b', 'j'), got {mesh.mesh_dim_names}")
    ax_b, ax_j = _axis(mesh, 0), _axis(mesh, 1)

    @spanned("nbx.shard.step")
    def step(state: ShardedState, G: float, eps: float, h: float) -> ShardedState:
        h32, half = _halves(h)
        vel = state.vel + state.acc * half
        pos = state.pos + vel * h32
        (pos_b,) = _gather(ax_j, pos)  # the "b" row's bodies
        src_pos, src_mass = _gather(ax_b, pos, state.mass)  # this "j" column's sources
        partial = _local_acc(src_pos, src_mass, pos_b, G, eps, impl)
        acc = _reduce_scatter(ax_j, partial)  # chunk j of the row: this rank's rows
        vel = vel + acc * half
        return ShardedState(pos, vel, acc, state.mass)

    return step


def make_sharded_step_ring(mesh: DeviceMesh, impl: str = "auto"):
    """The ring variant on a 1-D mesh: the source chunk travels the ring in
    D - 1 hops (send to rank + 1, receive from rank - 1), this rank's force
    of each chunk summed before its hop and the last chunk's after the loop,
    chunk-major. Equal to make_sharded_step up to the float32 order of the
    sum. At D = 1 there is no hop."""
    _check_impl(impl)
    ax = _axis_1d(mesh, "make_sharded_step_ring")
    to = ax.ranks[(ax.index + 1) % ax.size]
    frm = ax.ranks[(ax.index - 1) % ax.size]

    @spanned("nbx.shard.step")
    def step(state: ShardedState, G: float, eps: float, h: float) -> ShardedState:
        h32, half = _halves(h)
        vel = state.vel + state.acc * half
        pos = state.pos + vel * h32
        src = torch.cat([pos, state.mass[:, None]], dim=1)  # (x, y, z, m) of the chunk in hand
        acc = torch.zeros_like(pos)
        for _ in range(ax.size - 1):
            acc = acc + _local_acc(src[:, :3], src[:, 3], pos, G, eps, impl)
            src = _ppermute(src, to, frm)
        acc = acc + _local_acc(src[:, :3], src[:, 3], pos, G, eps, impl)
        vel = vel + acc * half
        return ShardedState(pos, vel, acc, state.mass)

    return step


def render_sharded(mesh: DeviceMesh, state: ShardedState, cam, radius_scale: float = 0.8, width: int = 640,
                   height: int = 360, exposure: float = 4.0) -> torch.Tensor:
    """Render a sharded state on the device: every rank splats its own rows
    (radius cbrt(m) radius_scale, rock colours, cold) into an HDR buffer,
    one all_reduce (sum) over the mesh composites the additive image, and
    the tonemap runs on every rank. The frame is [H, W, 3] whatever N is; at
    D = 1 it is the single-device splat bit for bit."""
    from nbx_torch.config import default_materials
    from nbx_torch.render.colormap import tonemap
    from nbx_torch.render.splat import splat_bodies_hdr

    dev = state.pos.device
    mats = default_materials(dev)
    n_loc = state.pos.shape[0]
    radius = torch.pow(state.mass, 1.0 / 3.0) * radius_scale
    hdr = splat_bodies_hdr(state.pos, radius, torch.zeros(n_loc, device=dev),
                           torch.zeros(n_loc, dtype=torch.int32, device=dev),
                           torch.ones(n_loc, dtype=torch.bool, device=dev), mats.color1, mats.color2, cam,
                           width=width, height=height)
    for dim in range(mesh.ndim):
        dist.all_reduce(hdr, group=mesh.get_group(dim))
    return tonemap(hdr, exposure)


def sharded_energy(mesh: DeviceMesh, state: ShardedState, G: float, eps: float, impl: str = "auto"):
    """Total (KE, PE) over the 1-D mesh, as 0-dim tensors on every rank: the
    potential of every body on this rank's rows through K3
    (`potential_per_body` with target_pos / target_mass, which drops each
    row's self term), then an all_reduce."""
    _check_impl(impl)
    ax = _axis_1d(mesh, "sharded_energy")
    ke = 0.5 * (state.mass * (state.vel * state.vel).sum(-1)).sum()
    pos_all, mass_all = _gather(ax, state.pos, state.mass)
    phi = potential_per_body(pos_all, mass_all, G, eps, target_pos=state.pos, target_mass=state.mass)
    e = torch.stack([ke, 0.5 * (state.mass * phi).sum()])
    dist.all_reduce(e, group=ax.group)
    return e[0], e[1]


def run_sharded(
    state: ShardedState,
    step_fn,
    G: float,
    eps: float,
    h: float,
    n_steps: int,
    diag_every: int = 0,
    mesh: Optional[DeviceMesh] = None,
    impl: str = "auto",
):
    """n_steps of the sharded substep. Returns (state, energies): with
    diag_every > 0 (needs `mesh`), energies is [n_steps // diag_every, 2]
    (KE, PE) after every diag_every steps, the steps past the last sample
    run after it; else None."""
    if diag_every <= 0:
        for _ in range(n_steps):
            state = step_fn(state, G, eps, h)
        return state, None
    if mesh is None:
        raise ValueError("diag_every > 0 requires the mesh for the reduced diagnostics")
    chunks = n_steps // diag_every
    samples = []
    for _ in range(chunks):
        for _ in range(diag_every):
            state = step_fn(state, G, eps, h)
        samples.append(torch.stack(sharded_energy(mesh, state, G, eps, impl)))
    for _ in range(n_steps - chunks * diag_every):
        state = step_fn(state, G, eps, h)
    energies = torch.stack(samples) if samples else state.pos.new_zeros((0, 2))
    return state, energies


# ---- full physics --------------------------------------------------------------------

class ShardedBodyState(NamedTuple):
    """Full-physics state: this rank's rows of the gravity and collision
    fields. partner is the GLOBAL id of each body's deepest partner (-1 =
    none), contact_t its contact timer (the at-scale collision semantics of
    `collisions_scaled`)."""

    pos: torch.Tensor  # [N/D, 3]
    vel: torch.Tensor  # [N/D, 3]
    acc: torch.Tensor  # [N/D, 3]
    mass: torch.Tensor  # [N/D] (0 = dead)
    mat: torch.Tensor  # [N/D] i32
    temp: torch.Tensor  # [N/D]
    partner: torch.Tensor  # [N/D] i32
    contact_t: torch.Tensor  # [N/D]


def shard_body_state(mesh: DeviceMesh, pos, vel, mass, mat=None, temp=None) -> ShardedBodyState:
    """This rank's shard of a global scene on a 1-D mesh (the same arrays on
    every rank), on the mesh's device; acc 0, no partners. N must divide
    evenly."""
    if mesh.ndim != 1:
        raise ValueError(f"shard_body_state places on a 1-D mesh, got {mesh.mesh_dim_names}")
    n = len(pos)
    put = _placer(mesh, n)
    p = put(pos)
    nl = p.shape[0]
    return ShardedBodyState(
        pos=p, vel=put(vel), acc=torch.zeros_like(p), mass=put(mass),
        mat=put(torch.zeros(n) if mat is None else mat, torch.int32),
        temp=put(torch.zeros(n) if temp is None else temp),
        partner=torch.full((nl,), -1, dtype=torch.int32, device=p.device),
        contact_t=torch.zeros((nl,), dtype=torch.float32, device=p.device),
    )


def _step_draws(cfg: SimConfig, dev):
    """draw(draws): the given fracture uniforms, or the next ones of the
    step's generator, seeded alike (0) on every rank."""
    gen = make_generator(dev, 0)

    def draw(draws: Optional[Draws]) -> Draws:
        return draws if draws is not None else draw_fracture_uniforms(cfg, gen, dev)

    return draw


def _place_fragments(frag: dict, mass_g: torch.Tensor, me: int, nl: int):
    """The global dead-slot census, identical on every rank: the r-th
    fragment goes to the r-th dead slot of the gathered masses. Returns
    (placed [F K] bool, lslot [F K] i64: this rank's row of each fragment
    that lands in its shard, nl for the others)."""
    n = mass_g.shape[0]
    fk = frag["mask"].shape[0]  # F * K
    slot_of, sv = take_rows(mass_g <= 0.0, fk)
    slot_of = torch.where(sv, slot_of.long(), n)
    frank = torch.cumsum(frag["mask"].long(), 0) - 1
    slot = torch.where(frag["mask"], slot_of[frank.clamp(0, fk - 1)], n)
    placed = frag["mask"] & (slot < n)
    mine = placed & (slot >= me * nl) & (slot < (me + 1) * nl)
    return placed, torch.where(mine, slot - me * nl, nl)


def _write_fragments(frag, lslot, mass, pos, vel, temp, mat):
    return (_set_at(mass, lslot, frag["mass"]), _set_at(pos, lslot, frag["pos"]), _set_at(vel, lslot, frag["vel"]),
            _set_at(temp, lslot, frag["temp"]), _set_at(mat, lslot, frag["mat"]))


def _mark(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x.at[idx].set(1 / True, mode="drop") for idx in [0, n]: index n drops.
    The ones are a device tensor: a Python scalar would make the scatter wait
    on the host."""
    return _set_at(x, idx, torch.ones(idx.shape, dtype=x.dtype, device=x.device))


def make_sharded_physics_step(mesh: DeviceMesh, cfg: SimConfig, impl: str = "auto"):
    """The sharded full-physics KDK substep on a 1-D mesh: gravity, bounce,
    impact heating, contact timers on the deepest partner, merges and
    fractures across ranks. Each rank resolves its rows against the gathered
    state with dense [N/D, N] pair tensors (the interactive-scale reference;
    make_sharded_granular_step is the at-scale path). Event decisions come
    from replicated data: the two owners of a pair compute its quantities
    alike, and one more gather of the partner, timer and gate fields lets
    both reach the same merge or fracture decision. The lower global id
    hosts a merged body; fragments go, by a census of the gathered dead
    slots that every rank makes alike, to the dead slots in index order,
    each rank writing those in its shard.

    The deepest partner is the first largest overlap depth (argmax, ties to
    the smallest global id). Returns step(state, h, draws=None) -> (state,
    counters): n_merges, n_bounces (pairs: the sum over ranks // 2),
    n_fractures and n_dropped (replicated: the sum // D), 0-dim int32
    tensors on every rank. draws are the fracture uniforms, the same on
    every rank; None draws them from the step's generator (seeded alike on
    every rank)."""
    _check_impl(impl)
    ax = _axis_1d(mesh, "make_sharded_physics_step")
    dev = mesh_device(mesh)
    cfg = cfg.to(dev)
    draw = _step_draws(cfg, dev)
    one_e = f32(1.0 + f32(cfg.restitution))
    fric = f32(cfg.friction)
    merge_time = f32(cfg.merge_time)
    thr = f32(cfg.fracture_threshold)
    min_frag = f32(cfg.min_fragment_mass)

    @spanned("nbx.shard.step")
    def step(state: ShardedBodyState, h: float, draws: Optional[Draws] = None):
        h32, half = _halves(h)
        pos, vel, acc, mass, mat, temp, partner, t_prev = state
        nl = pos.shape[0]
        me = ax.index
        gidx = me * nl + torch.arange(nl, dtype=torch.int32, device=dev)

        # ---- KDK first half and gravity -------------------------------------------
        vel = vel + acc * half
        pos = pos + vel * h32
        radius = body_radius(mass, mat, cfg.materials)
        pos_g, vel_g, mass_g, radius_g = _gather(ax, pos, vel, mass, radius)
        acc_new = _local_acc(pos_g, mass_g, pos, cfg.G, cfg.softening, impl)
        n = pos_g.shape[0]

        # ---- collisions: local rows against every body ----------------------------
        col = torch.arange(n, dtype=torch.int32, device=dev)
        d = pos_g[None, :, :] - pos[:, None, :]  # [nl, N] i -> j
        r2 = (d * d).sum(-1)
        min_d = radius[:, None] + radius_g[None, :]
        alive2 = (mass[:, None] > 0) & (mass_g[None, :] > 0)
        overlap = alive2 & (gidx[:, None] != col[None, :]) & (r2 < min_d * min_d)
        dist_ = torch.sqrt(torch.where(r2 > 0, r2, 1.0))
        nrm = d / dist_[:, :, None]
        rv = vel_g[None, :, :] - vel[:, None, :]
        vn = (rv * nrm).sum(-1)
        appr = overlap & (vn < 0)

        inv_l = inverse_mass(mass)
        inv_sum = inv_l[:, None] + inverse_mass(mass_g)[None, :]
        safe_is = torch.where(inv_sum > 0, inv_sum, 1.0)
        j_imp = torch.where(appr, -one_e * vn / safe_is, 0.0)
        t_raw = rv - vn[:, :, None] * nrm
        t_len = torch.sqrt((t_raw * t_raw).sum(-1))
        t_hat = t_raw / torch.where(t_len > 0, t_len, 1.0)[:, :, None]
        jt = torch.where(appr, -t_len * fric / safe_is, 0.0)
        imp = j_imp[:, :, None] * nrm + jt[:, :, None] * t_hat
        vel = vel - imp.sum(1) * inv_l[:, None]
        corr = torch.where(appr, (min_d - dist_) / safe_is * 0.8, 0.0)
        pos = pos - (corr[:, :, None] * nrm).sum(1) * inv_l[:, None]
        m_sum = mass[:, None] + mass_g[None, :]
        safe_ms = torch.where(m_sum > 0, m_sum, 1.0)
        e_full = 0.5 * (mass[:, None] * mass_g[None, :] / safe_ms) * vn * vn
        temp = temp + torch.where(appr, e_full, 0.0).sum(1) * inv_l * 0.2
        n_bounce = _count(appr)

        # ---- the deepest partner and its timer --------------------------------------
        depth = torch.where(overlap, min_d - dist_, float("-inf"))
        at_best = torch.argmax(depth, dim=1, keepdim=True)  # the first maximum: the smallest global id

        def atj(m):
            return m.gather(1, at_best)[:, 0]

        best_j = at_best[:, 0].to(torch.int32)
        has = atj(depth) > 0
        q_l = torch.where(has, atj(e_full / safe_ms), 0.0)
        appr_l = has & (atj(vn) < 0)
        same = (best_j == partner) & has
        t_new = torch.where(has, torch.where(same, t_prev + h32, h32), 0.0)
        partner_new = torch.where(has, best_j, -1)

        # ---- the merge gate from gathered decision fields ---------------------------
        pos2_g, vel2_g, temp2_g, mat_g, partner_g, t_g, appr_g = _gather(
            ax, pos, vel, temp, mat, partner_new, t_new, appr_l)
        jc = partner_new.long().clamp(0, n - 1)
        mutual = has & (partner_g[jc] == gidx)
        t_pair = torch.minimum(t_new, t_g[jc])
        gate = mutual & appr_l & appr_g[jc]
        mergeable = gate & (t_pair > merge_time) & (q_l < thr * 2.0)
        primary = mergeable & (gidx < jc)
        killed = mergeable & (gidx > jc)

        mj = mass_g[jc]
        tot = mass + mj
        safe_tot = torch.where(tot > 0, tot, 1.0)
        mpos = (pos * mass[:, None] + pos2_g[jc] * mj[:, None]) / safe_tot[:, None]
        mvel = (vel * mass[:, None] + vel2_g[jc] * mj[:, None]) / safe_tot[:, None]
        mtemp = (temp * mass + temp2_g[jc] * mj) / safe_tot
        mmat = torch.where(mass > mj, mat, mat_g[jc])  # the heavier body's

        # ---- the fracture gate, exclusive with merges --------------------------------
        fract = gate & ~mergeable & (q_l > thr) & ((mass > min_frag) | (mj > min_frag))
        primary_f = fract & (gidx < jc)
        # the event payload from the values before the merge writes (the gates
        # are exclusive, so a fracture parent is no merge's)
        e_best = torch.where(fract, atj(e_full), 0.0)
        f_tot = torch.where(fract, mass + mj, 1.0)
        f_com = (pos * mass[:, None] + pos2_g[jc] * mj[:, None]) / f_tot[:, None]
        f_bvel = (vel * mass[:, None] + vel2_g[jc] * mj[:, None]) / f_tot[:, None]
        f_temp = torch.maximum(temp, temp2_g[jc]) + (e_best / f_tot) * 0.1
        f_mat = torch.where(mass > mj, mat, mat_g[jc])
        f_rsum = radius + radius_g[jc]

        pm = primary[:, None]
        pos = torch.where(pm, mpos, pos)
        vel = torch.where(pm, mvel, torch.where(killed[:, None], 0.0, vel))
        temp = torch.where(primary, mtemp, torch.where(killed, 0.0, temp))
        mat = torch.where(primary, mmat, mat)
        mass = torch.where(primary, tot, torch.where(killed, 0.0, mass))

        # ---- fractures: kill the parents, replicated event extraction ----------------
        mass = torch.where(fract, 0.0, mass)
        vel = torch.where(fract[:, None], 0.0, vel)
        temp = torch.where(fract, 0.0, temp)
        pf_g, com_g, bvel_g, eb_g, ftot_g, ftemp_g, fmat_g, frsum_g, mass_g2 = _gather(
            ax, primary_f, f_com, f_bvel, e_best, f_tot, f_temp, f_mat, f_rsum, mass)
        fi, f_valid = take_rows(pf_g, cfg.max_fractures)
        fi = fi.long()
        frag = _make_fragments(draw(draws), cfg, f_valid, com_g[fi], bvel_g[fi],
                               torch.where(f_valid, eb_g[fi], 0.0), ftot_g[fi], ftemp_g[fi], fmat_g[fi],
                               frsum_g[fi])  # alike on every rank: the same uniforms and gathered inputs
        placed, lslot = _place_fragments(frag, mass_g2, me, nl)
        mass, pos, vel, temp, mat = _write_fragments(frag, lslot, mass, pos, vel, temp, mat)

        touched = _mark(primary | killed | fract, lslot)
        partner_new = torch.where(touched, -1, partner_new)
        t_new = torch.where(touched, 0.0, t_new)
        # merged and newborn bodies carry acc = 0: the pre-merge acc holds the
        # dead partner's pull
        acc_new = torch.where(touched[:, None], 0.0, acc_new)

        # ---- second half-kick and thermal decay ----------------------------------------
        vel = vel + acc_new * half
        temp = torch.where(mass > 0, temp * f32(cfg.heat_decay), 0.0)
        temp = torch.where(temp < thermal.SNAP_TO_ZERO, 0.0, temp)
        dropped = (_count(pf_g) - _count(f_valid)) + (_count(frag["mask"]) - _count(placed))
        ints = torch.stack([_count(primary), n_bounce, _count(primary_f), dropped])
        dist.all_reduce(ints, group=ax.group)
        counters = dict(n_merges=ints[0], n_bounces=ints[1] // 2, n_fractures=ints[2],
                        n_dropped=ints[3] // ax.size)
        return ShardedBodyState(pos, vel, acc_new, mass, mat, temp, partner_new, t_new), counters

    return step


# ---- the column-slab collision pass and the granular step ---------------------------

def _slab_split(ax: _Axis, n_cells: int) -> int:
    """Columns a rank of the column-slab split; the g^2 columns must divide
    over the mesh."""
    n_cols = n_cells * n_cells
    if n_cols % ax.size:
        raise ValueError(f"n_cells^2 = {n_cols} columns must divide over {ax.size} devices")
    return n_cols // ax.size


@spanned("nbx.collide.pass")
def _slab_pass(ax: _Axis, n_slab: int, pos_g, vel_g, mass_g, rad_g, box_size, g, band_cells, packed_caps,
               restitution, friction):
    """This rank's slab of the packed pass over the gathered state, reduced
    to this rank's rows: (deltas [nl, 8], partners [nl] i32 global ids,
    n_overflow [] i32 of this slab alone)."""
    out_d, out_j, novf = packed_collision_blocks_slab(pos_g, vel_g, mass_g, rad_g, box_size, g, band_cells,
                                                      packed_caps, restitution, friction, ax.index * n_slab, n_slab)
    # one nonzero term a body: the owner slab's; -1 on every other slab
    od = _reduce_scatter(ax, out_d)
    oj = _reduce_scatter(ax, out_j, dist.ReduceOp.MAX)
    return od, oj, novf


def _cell_too_small(ax: _Axis, radius: torch.Tensor, box_size: float, g: int) -> torch.Tensor:
    """2 max(r) > cell over the mesh, reduced as an int32 MAX."""
    cell = torch.full((), f32(box_size / g), dtype=torch.float32, device=radius.device)
    flag = (2.0 * radius.max() > cell).to(torch.int32)
    dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=ax.group)
    return flag > 0


def make_sharded_binned_collision_pass(
    mesh: DeviceMesh,
    box_size: float,
    n_cells: int,
    band_cells: int,
    packed_caps: tuple[int, int],
    restitution: float = 0.2,
    friction: float = 0.5,
):
    """The column-slab sharded band-packed collision pass on a 1-D mesh: the
    multi-device form of `ops.collide.binned_collision_pass` with
    packed_caps. Rank d gathers the four fields, runs the slab [d g^2/D,
    (d + 1) g^2/D) of the pass (`packed_collision_blocks_slab`, K2) on every
    body, and a reduce-scatter over the mesh gives it its rows of the
    whole-grid pass. Raises ValueError when g^2 does not divide over the
    mesh.

    Returns pass(pos, vel, mass, radius) -> binned_collision_pass's tuple
    (dvel, dpos, dtemp, best, n_bounces, n_overflow, cell_too_small): the
    per-body outputs are this rank's rows (best["j"] global ids), the
    counters 0-dim tensors alike on every rank."""
    ax = _axis_1d(mesh, "make_sharded_binned_collision_pass")
    n_slab = _slab_split(ax, n_cells)

    def collision_pass(pos, vel, mass, radius):
        pos_g, vel_g, mass_g, rad_g = _gather(ax, pos, vel, mass, radius)
        od, oj, novf = _slab_pass(ax, n_slab, pos_g, vel_g, mass_g, rad_g, box_size, n_cells, band_cells,
                                  packed_caps, restitution, friction)
        ints = torch.stack([od[:, 7].sum().to(torch.int32), novf])
        dist.all_reduce(ints, group=ax.group)
        with span("nbx.shard.partner"):
            best = partner_record(oj, pos, vel, mass, src=(pos_g, vel_g, mass_g))
        return (od[:, 0:3], od[:, 3:6], od[:, 6], best, ints[0] // 2, ints[1],
                _cell_too_small(ax, radius, box_size, n_cells))

    return collision_pass


def make_sharded_granular_step(
    mesh: DeviceMesh,
    cfg: SimConfig,
    box_size: float,
    n_cells: int,
    band_cells: int,
    packed_caps: tuple[int, int],
    force_impl: str = "auto",
    pm_grid: int = 128,
):
    """The sharded full-physics granular step at scale on a 1-D mesh: KDK
    gravity, the column-slab packed collision pass (K2) and the event
    machinery of `collisions_scaled` (contact timers, merges, fractures,
    heating, thermal decay), on this rank's rows against gathered decision
    fields. Step for step the single-device sequence [half-kick, drift,
    force, resolve_collisions_scaled(packed_caps), acc 0 on touched slots,
    half-kick, thermal.decay] with the same layout, at any D.

    force_impl: "auto" (or "pallas", "jnp"): the direct sum of every body on
    this rank's rows (K1 on the card); "pm": particle-mesh on a pm_grid^3
    isolated mesh, the gathered bodies deposited on every rank and the
    field gathered at this rank's rows; "zero": contact dynamics only.

    Returns step(state: ShardedBodyState, h, draws=None) -> (state,
    counters): n_merges, n_fractures, n_bounces, n_overflow, n_dropped (0-dim
    int32, summed on the device) and cell_too_small (0-dim bool), alike on
    every rank. draws: the fracture uniforms, the same on every rank; None
    draws them from the step's generator (seeded alike on every rank).
    Nothing is read back to the host."""
    if force_impl not in GRANULAR_FORCES:
        raise ValueError(f"force_impl must be one of {GRANULAR_FORCES}, got {force_impl!r}")
    ax = _axis_1d(mesh, "make_sharded_granular_step")
    n_slab = _slab_split(ax, n_cells)
    dev = mesh_device(mesh)
    cfg = cfg.to(dev)
    draw = _step_draws(cfg, dev)
    merge_time = f32(cfg.merge_time)
    thr = f32(cfg.fracture_threshold)
    min_frag = f32(cfg.min_fragment_mass)
    if force_impl == "pm":
        from nbx_torch.ops.pm import cic_deposit, cic_gather, isolated_green_hat, pm_solve_grid

        green_hat = isolated_green_hat(box_size, pm_grid, device=dev)

    def force(pos_g, mass_g, pos):
        if force_impl == "zero":
            return torch.zeros_like(pos)
        if force_impl == "pm":
            rho = cic_deposit(pos_g, mass_g, box_size, pm_grid, periodic=False)
            grid = pm_solve_grid(rho, cfg.G, box_size, pm_grid, True, True, green_hat)
            return cic_gather(grid, pos, box_size, pm_grid, periodic=False)
        return _local_acc(pos_g, mass_g, pos, cfg.G, cfg.softening)

    @spanned("nbx.shard.step")
    def step(state: ShardedBodyState, h: float, draws: Optional[Draws] = None):
        h32, half = _halves(h)
        pos, vel, acc, mass, mat, temp, partner, t_prev = state
        nl = pos.shape[0]
        me = ax.index
        gidx = me * nl + torch.arange(nl, dtype=torch.int32, device=dev)

        # ---- KDK first half, the force on the drifted state ---------------------------
        vel = vel + acc * half
        pos = pos + vel * h32
        radius = body_radius(mass, mat, cfg.materials)
        pos_g, vel_g, mass_g, rad_g = _gather(ax, pos, vel, mass, radius)
        n = pos_g.shape[0]
        acc_new = force(pos_g, mass_g, pos)

        # ---- this rank's column slab of the packed pass -------------------------------
        od, j_idx, n_overflow = _slab_pass(ax, n_slab, pos_g, vel_g, mass_g, rad_g, box_size, n_cells,
                                           band_cells, packed_caps, cfg.restitution, cfg.friction)
        bounces = od[:, 7].sum().to(torch.int32)
        with span("nbx.shard.partner"):
            best = partner_record(j_idx, pos, vel, mass, src=(pos_g, vel_g, mass_g))
        has = j_idx >= 0
        q_l, appr_l, m_j = best["q"], best["approaching"], best["m_j"]

        # the pass's Jacobi deltas (resolve_collisions_scaled)
        pos = pos + od[:, 3:6]
        vel = vel + od[:, 0:3]
        temp = temp + od[:, 6]

        # ---- contact timers on the deepest partner ------------------------------------
        contact_t = torch.where(has, torch.where(j_idx == partner, t_prev + h32, h32), 0.0)
        partner_new = torch.where(has, j_idx, -1)

        # ---- event gates on mutual partners -----------------------------------------------
        partner_g, t_g, pos2_g, vel2_g, temp2_g, mat_g = _gather(ax, partner_new, contact_t, pos, vel, temp, mat)
        jc = partner_new.long().clamp(0, n - 1)
        mutual = has & (partner_g[jc] == gidx)
        t_pair = torch.minimum(contact_t, t_g[jc])
        # vn, q and E are bitwise symmetric between the two owners, so gates on
        # this rank's values reach the partner's decision
        merge_m = mutual & appr_l & (t_pair > merge_time) & (q_l < thr * 2.0)
        fract_m = (mutual & appr_l & ~merge_m & (q_l > thr)
                   & ((mass > min_frag) | (m_j > min_frag)))
        primary_m = merge_m & (gidx < jc)
        killed_m = merge_m & (gidx > jc)
        primary_f = fract_m & (gidx < jc)

        # ---- merges in place into the lower id ----------------------------------------------
        mjc = mass_g[jc]
        tot = mass + mjc
        safe_tot = torch.where(tot > 0, tot, 1.0)
        mpos = (pos * mass[:, None] + pos2_g[jc] * mjc[:, None]) / safe_tot[:, None]
        mvel = (vel * mass[:, None] + vel2_g[jc] * mjc[:, None]) / safe_tot[:, None]
        mtemp = (temp * mass + temp2_g[jc] * mjc) / safe_tot
        mmat = torch.where(mass > mjc, mat, mat_g[jc])  # the heavier body's

        # the fracture payload before the merge writes (the gates are exclusive)
        f_safe = torch.where(fract_m, tot, 1.0)
        f_com = (pos * mass[:, None] + pos2_g[jc] * mjc[:, None]) / f_safe[:, None]
        f_bvel = (vel * mass[:, None] + vel2_g[jc] * mjc[:, None]) / f_safe[:, None]
        e_best = torch.where(fract_m, best["energy"], 0.0)
        f_temp = torch.maximum(temp, temp2_g[jc]) + (e_best / f_safe) * 0.1
        f_mat = torch.where(mass > mjc, mat, mat_g[jc])
        f_rsum = radius + rad_g[jc]

        pm2 = primary_m[:, None]
        pos = torch.where(pm2, mpos, pos)
        vel = torch.where(pm2, mvel, torch.where(killed_m[:, None], 0.0, vel))
        temp = torch.where(primary_m, mtemp, torch.where(killed_m, 0.0, temp))
        mat = torch.where(primary_m, mmat, mat)
        mass = torch.where(primary_m, tot, torch.where(killed_m, 0.0, mass))

        # ---- fractures: replicated extraction and fragments -----------------------------
        pf_g, com_g, bvel_g, eb_g, ftot_g, ftemp_g, fmat_g, frsum_g = _gather(
            ax, primary_f, f_com, f_bvel, e_best, tot, f_temp, f_mat, f_rsum)
        fi, f_valid = take_rows(pf_g, cfg.max_fractures)  # alike on every rank
        fi = fi.long()
        fj = partner_g.long().clamp(0, n - 1)[fi]
        frag = _make_fragments(draw(draws), cfg, f_valid, com_g[fi], bvel_g[fi],
                               torch.where(f_valid, eb_g[fi], 0.0), ftot_g[fi], ftemp_g[fi], fmat_g[fi],
                               frsum_g[fi])
        # kill the parents of the accepted (capped) events only: events past
        # the cap survive and are counted into n_dropped
        kill_g = torch.zeros(n, dtype=torch.bool, device=dev)
        kill_g = _mark(kill_g, torch.where(f_valid, fi, n))
        kill_g = _mark(kill_g, torch.where(f_valid, fj, n))
        fkill = kill_g[me * nl:(me + 1) * nl]
        mass = torch.where(fkill, 0.0, mass)
        vel = torch.where(fkill[:, None], 0.0, vel)
        temp = torch.where(fkill, 0.0, temp)

        (mass_g2,) = _gather(ax, mass)
        placed, lslot = _place_fragments(frag, mass_g2, me, nl)
        mass, pos, vel, temp, mat = _write_fragments(frag, lslot, mass, pos, vel, temp, mat)

        touched = _mark(primary_m | killed_m | fkill, lslot)
        partner_new = torch.where(touched, -1, partner_new)
        contact_t = torch.where(touched, 0.0, contact_t)
        acc_new = torch.where(touched[:, None], 0.0, acc_new)  # newborns: acc = 0

        # ---- second half-kick, thermal decay --------------------------------------------
        vel = vel + acc_new * half
        temp = thermal.decay(temp, cfg.heat_decay)

        # ---- counters (ScaledEvents' scalars), reduced on the device ---------------------
        ints = torch.stack([_count(primary_m), _count(primary_f), bounces, n_overflow])
        dist.all_reduce(ints, group=ax.group)
        n_merges, n_fracts = ints[0], ints[1]
        # the merge log keeps max_merges events; the fracture cap and the
        # fragments' slots are replicated
        n_dropped = ((n_fracts - _count(f_valid)) + (n_merges - n_merges.clamp(max=cfg.max_merges))
                     + (_count(frag["mask"]) - _count(placed)))
        counters = dict(n_merges=n_merges, n_fractures=n_fracts, n_bounces=ints[2] // 2, n_overflow=ints[3],
                        n_dropped=n_dropped, cell_too_small=_cell_too_small(ax, radius, box_size, n_cells))
        new_state = ShardedBodyState(pos, vel, acc_new, mass, mat, temp, partner_new, contact_t)
        return new_state, counters

    return step
