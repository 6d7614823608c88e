"""Fixed-capacity structure-of-arrays simulation state (port of `nbx/state.py`).

The same layout as the JAX package: every array has the fixed capacity C as
its leading dimension and an `alive` mask says which slots hold bodies.

  - births take the lowest-index free slot;
  - when full, the oldest body (smallest insertion seq) is evicted (FIFO);
  - deaths clear the slot (mass -> 0, so the body exerts no gravity).

Shapes never depend on the data, and nothing here that the frame step calls
reads a value back to the host, so a frame can later be captured as a CUDA
graph.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .config import CUDA, SimConfig, body_radius

_I32_MAX = 2**31 - 1


@dataclasses.dataclass(frozen=True)
class SimState:
    """State of C = capacity slots.

    `generator` takes the place of the JAX state's PRNG `key`: fracture draws
    come from it (`collisions.resolve_collisions`). A torch.Generator is
    mutable, so states derived from one another share it, and a draw
    advances it for all of them.

    contact[i, j] holds accumulated contact seconds for the overlapping pair
    (i, j); None when collisions are disabled (no O(C^2) memory for large-N
    gravity-only runs).
    """

    pos: torch.Tensor  # [C, 3] f32
    vel: torch.Tensor  # [C, 3] f32
    acc: torch.Tensor  # [C, 3] f32, zero for newborn bodies
    mass: torch.Tensor  # [C] f32, 0 for dead slots
    temp: torch.Tensor  # [C] f32
    mat: torch.Tensor  # [C] i32 material code
    alive: torch.Tensor  # [C] bool
    seq: torch.Tensor  # [C] i32 insertion order, drives FIFO eviction
    next_seq: torch.Tensor  # [] i32
    step_count: torch.Tensor  # [] i32
    generator: torch.Generator
    contact: Optional[torch.Tensor] = None  # [C, C] f32 or None

    @property
    def capacity(self) -> int:
        return self.pos.shape[0]

    @property
    def device(self) -> torch.device:
        return self.pos.device

    @property
    def n_alive(self) -> torch.Tensor:
        return self.alive.sum(dtype=torch.int32)

    def radius(self, cfg: SimConfig) -> torch.Tensor:
        return body_radius(self.mass, self.mat, cfg.materials)

    def replace(self, **kwargs) -> "SimState":
        return dataclasses.replace(self, **kwargs)


def make_generator(device, seed: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def empty_state(cfg: SimConfig, device=CUDA, seed: int = 0) -> SimState:
    """All-dead state at full capacity on `device` (the card unless the
    caller asks for the CPU); `seed` seeds the fracture generator."""
    c = cfg.capacity
    f = dict(dtype=torch.float32, device=device)
    i = dict(dtype=torch.int32, device=device)
    return SimState(
        pos=torch.zeros((c, 3), **f),
        vel=torch.zeros((c, 3), **f),
        acc=torch.zeros((c, 3), **f),
        mass=torch.zeros((c,), **f),
        temp=torch.zeros((c,), **f),
        mat=torch.zeros((c,), **i),
        alive=torch.zeros((c,), dtype=torch.bool, device=device),
        seq=torch.zeros((c,), **i),
        next_seq=torch.zeros((), **i),
        step_count=torch.zeros((), **i),
        generator=make_generator(device, seed),
        contact=torch.zeros((c, c), **f) if cfg.collisions else None,
    )


def allocate_slot(state: SimState) -> tuple[SimState, torch.Tensor, torch.Tensor]:
    """Pick a slot for a new body; evict the oldest body if full.

    Returns (state, slot, evicted) with 0-d tensors: the lowest-index free
    slot, else the alive body with the smallest insertion seq."""
    free = ~state.alive
    any_free = free.any()
    # torch has no argmax on bool; on an integer cast it keeps the
    # first-index tie rule the JAX package relies on.
    free_slot = free.to(torch.int32).argmax()
    oldest = torch.where(state.alive, state.seq, _I32_MAX).argmin()
    slot = torch.where(any_free, free_slot, oldest)
    return state, slot, ~any_free


def _as(x, like: torch.Tensor, dtype) -> torch.Tensor:
    return torch.as_tensor(x, dtype=dtype, device=like.device)


def add_body(
    state: SimState, mass, pos, vel, mat, temp=0.0
) -> tuple[SimState, torch.Tensor]:
    """Insert one body. Returns (new_state, evicted_flag); newborn acc = 0."""
    state, slot, evicted = allocate_slot(state)
    s = slot.reshape(1)
    f32, i32 = torch.float32, torch.int32

    def put(arr, value, dtype):
        value = _as(value, arr, dtype).broadcast_to((1,) + arr.shape[1:])
        return arr.index_put((s,), value)

    contact = state.contact
    if contact is not None:
        contact = contact.index_fill(0, s, 0.0).index_fill(1, s, 0.0)
    return (
        state.replace(
            pos=put(state.pos, pos, f32),
            vel=put(state.vel, vel, f32),
            acc=put(state.acc, 0.0, f32),
            mass=put(state.mass, mass, f32),
            temp=put(state.temp, temp, f32),
            mat=put(state.mat, mat, i32),
            alive=put(state.alive, True, torch.bool),
            seq=state.seq.index_put((s,), state.next_seq.reshape(1)),
            next_seq=state.next_seq + 1,
            contact=contact,
        ),
        evicted,
    )


def _put_drop(arr: torch.Tensor, slot: torch.Tensor, value) -> torch.Tensor:
    """arr.at[slot].set(value, mode="drop") for slot in [0, C]: index C means
    "dropped". Writes into a buffer one row longer and cuts that row off."""
    pad = torch.zeros((1,) + arr.shape[1:], dtype=arr.dtype, device=arr.device)
    buf = torch.cat([arr, pad])
    shape = (slot.shape[0],) + arr.shape[1:]
    if isinstance(value, torch.Tensor):
        value = value.to(arr.dtype).expand(shape)
    else:  # a fill, not a host-to-device copy: the step stays free of syncs
        value = torch.full(shape, value, dtype=arr.dtype, device=arr.device)
    return buf.index_put((slot,), value)[:-1]


def add_bodies_batch(
    state: SimState,
    mass: torch.Tensor,  # [B]
    pos: torch.Tensor,  # [B, 3]
    vel: torch.Tensor,  # [B, 3]
    mat: torch.Tensor,  # [B] i32
    temp: torch.Tensor,  # [B]
    mask: torch.Tensor,  # [B] bool; invalid births are skipped
) -> tuple[SimState, torch.Tensor]:
    """Insert up to B bodies in one vectorized pass, equivalent to B
    sequential add_body calls: the k-th valid birth takes the k-th slot in
    allocation priority order (free slots by ascending index, then alive
    slots by ascending insertion seq). Births beyond the capacity are
    dropped. Returns (state, n_evicted)."""
    c = state.capacity
    dev = state.device
    slot_idx = torch.arange(c, device=dev)
    # Allocation priority (alive asc, then slot for free / seq for alive) as
    # one stable sort on a combined int64 key: jnp.lexsort's order.
    key = (state.alive.to(torch.int64) << 32) | torch.where(
        state.alive, state.seq.to(torch.int64), slot_idx
    )
    order = torch.sort(key, stable=True).indices
    rank = torch.cumsum(mask.to(torch.int64), 0) - 1  # [B] compacted position
    mask = mask & (rank < c)  # births beyond capacity are dropped, not aliased
    slot = torch.where(mask, order[rank.clamp(0, c - 1)], c)  # c = dropped
    n_valid = mask.sum(dtype=torch.int32)
    n_free = (~state.alive).sum(dtype=torch.int32)
    n_evicted = torch.clamp(n_valid - n_free, min=0)

    seq_new = state.next_seq + rank.to(torch.int32)
    contact = state.contact
    if contact is not None:
        keep = _put_drop(torch.ones((c,), dtype=torch.bool, device=dev), slot, False)
        contact = torch.where(keep[:, None] & keep[None, :], contact, 0.0)
    return (
        state.replace(
            pos=_put_drop(state.pos, slot, pos),
            vel=_put_drop(state.vel, slot, vel),
            acc=_put_drop(state.acc, slot, 0.0),
            mass=_put_drop(state.mass, slot, mass),
            temp=_put_drop(state.temp, slot, temp),
            mat=_put_drop(state.mat, slot, mat),
            alive=_put_drop(state.alive, slot, True),
            seq=_put_drop(state.seq, slot, seq_new),
            next_seq=state.next_seq + n_valid,
            contact=contact,
        ),
        n_evicted,
    )


def add_bodies(state: SimState, mass, pos, vel, mat, temp=None) -> SimState:
    """Bulk insert n bodies, equivalent to n sequential add_body calls.

    Batches of at most `capacity` births never evict a birth of their own
    batch, so each batch is one add_bodies_batch."""
    dev = state.device
    mass = torch.as_tensor(mass, dtype=torch.float32, device=dev)
    n = mass.shape[0]
    pos = torch.as_tensor(pos, dtype=torch.float32, device=dev)
    vel = torch.as_tensor(vel, dtype=torch.float32, device=dev)
    mat = torch.as_tensor(mat, dtype=torch.int32, device=dev)
    if temp is None:
        temp = torch.zeros((n,), dtype=torch.float32, device=dev)
    temp = torch.as_tensor(temp, dtype=torch.float32, device=dev)
    c = state.capacity
    for a in range(0, n, c):
        b = slice(a, min(a + c, n))
        mask = torch.ones((b.stop - a,), dtype=torch.bool, device=dev)
        state, _ = add_bodies_batch(
            state, mass[b], pos[b], vel[b], mat[b], temp[b], mask
        )
    return state


def compact_arrays(state: SimState) -> dict:
    """Host-side: alive bodies in insertion (seq) order as numpy arrays —
    the render/inspection view of the dynamic body list."""
    alive = state.alive.cpu().numpy()
    seq = state.seq.cpu().numpy()
    order = np.argsort(seq[alive], kind="stable")
    idx = np.nonzero(alive)[0][order]
    return dict(
        pos=state.pos.cpu().numpy()[idx],
        vel=state.vel.cpu().numpy()[idx],
        mass=state.mass.cpu().numpy()[idx],
        temp=state.temp.cpu().numpy()[idx],
        mat=state.mat.cpu().numpy()[idx],
        seq=seq[idx],
        slot=idx,
    )
