"""The strict-sequential collision sweep (the pair loop of
`nbx.collisions.resolve_collisions_sequential`, nbx/collisions.py:350-578).

The JAX package runs the reference's in-place (i, j) pair loop as one
`lax.fori_loop` over the flattened c*c pair space: pair p is (i, j) =
(p // c, p % c), live when i < j, both bodies are alive and neither was
removed earlier in the sweep. A live pair overlaps when dist2 < (r_i +
r_j)^2, with the radii fixed for the sweep; an overlapping pair adds h to
its contact timer; an approaching one (vn < 0) heats both bodies in place,
then, in this order of precedence,

  * merges (timer > merge_time and q < 2 fracture_threshold): its payload,
    the mass-weighted position, velocity and temperature, the summed mass
    and the heavier body's material, taken before any correction, goes to
    the next of max_merges slots, or counts as dropped;
  * fractures (q > fracture_threshold, a body above min_fragment_mass):
    after the position correction, its payload (centre of mass, base
    velocity, energy, summed mass, temperature, material, radius sum,
    midpoint) goes to the next of max_fractures slots, or counts as dropped;
  * or bounces, with the position correction and the normal and friction
    impulses applied in place.

A merge or a fracture removes both bodies from the rest of the sweep and
zeroes the pair's timer. Every later pair sees all of it. After the loop the
timers of pairs that did not overlap are pruned to 0.

`sweep` runs the kernel `nbx_torch/csrc/collide_sequential.cu` (one launch,
one block) on CUDA tensors and its plain PyTorch version `sweep_reference` on
CPU tensors; any other device raises. The plain version is the CPU path and
the kernel's yardstick on the card; it reads every decision back to the host.

Both use the fact that a live pair that does not overlap changes nothing:
its timer stays, its heat, correction and impulse are zeros (only the sign
of an exact zero could differ, and no later comparison or product reads
it). So row i tests all its candidates j >= j0 against the current positions
at once, applies the first hit in j order, and resumes at hit + 1: exact,
since only an applied pair moves pos[i] or pos[j]. Sums of three terms are
taken left to right and every constant is a float32, so the kernel, which
rounds each operation to nearest without contraction, matches the plain
version bitwise.

The timers come back pruned: the output matrix holds each overlapping pair's
timer (0 where it fired) and 0 elsewhere.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from nbx_torch.config import SimConfig, f32
from nbx_torch.ops.collide import _check
from nbx_torch.ops.pairwise import _launch

CORRECTION = 0.8  # Baumgarte position-correction factor, as in collisions.py
# The kernel keeps 41 bytes a body in shared memory (csrc/collide_sequential.cu);
# 5,632 bodies take 230,912 of the 232,448 bytes a block may use.
MAX_CAPACITY = 5632
# counts[6]: the sweep's counters, and the overlap tests it made (a row's
# live candidates up to and including each hit, or to the row's end)
COUNTS = ("n_bounces", "m_cnt", "m_drop", "f_cnt", "f_drop", "n_tests")
MERGE_WIDTH = 8  # mbuf rows: position (3), velocity (3), mass, temperature
FRACTURE_WIDTH = 13  # fbuf rows: centre of mass (3), base velocity (3), energy, mass, temperature,
# radius sum, midpoint (3)


@dataclasses.dataclass(frozen=True)
class Sweep:
    """What one sweep returns: the bodies after it, the pruned timers, the
    removed flags, the counters and the merge and fracture records."""

    pos: torch.Tensor  # [C, 3]
    vel: torch.Tensor  # [C, 3]
    temp: torch.Tensor  # [C]
    contact: torch.Tensor  # [C, C], pruned
    removed: torch.Tensor  # [C] bool
    counts: torch.Tensor  # [6] i32, COUNTS
    mbuf: torch.Tensor  # [max_merges, MERGE_WIDTH]
    mmat: torch.Tensor  # [max_merges] i32
    fbuf: torch.Tensor  # [max_fractures, FRACTURE_WIDTH]
    fmat: torch.Tensor  # [max_fractures] i32

    def count(self, name: str) -> torch.Tensor:
        """One counter as a 0-d int32 tensor."""
        return self.counts[COUNTS.index(name)]


@dataclasses.dataclass(frozen=True)
class _Constants:
    """The sweep's float32 constants, as Python floats."""

    h: float
    merge_time: float
    merge_q: float  # 2 fracture_threshold
    fracture_q: float
    min_fragment_mass: float
    correction: float
    restitution1: float  # 1 + restitution
    friction: float

    @classmethod
    def of(cls, cfg: SimConfig, h: float) -> "_Constants":
        ft = f32(cfg.fracture_threshold)
        return cls(f32(h), f32(cfg.merge_time), f32(ft * 2.0), ft, f32(cfg.min_fragment_mass), f32(CORRECTION),
                   f32(1.0 + f32(cfg.restitution)), f32(cfg.friction))


def _outputs(pos, vel, temp, contact, cfg: SimConfig) -> dict:
    """The outputs a sweep fills, made on the inputs' device: the bodies to
    be overwritten, the zeroed timers and record buffers."""
    mm, ff = cfg.max_merges, cfg.max_fractures
    z = dict(device=pos.device)
    return dict(
        pos=torch.empty_like(pos), vel=torch.empty_like(vel), temp=torch.empty_like(temp),
        contact=torch.zeros_like(contact),
        removed=torch.empty(pos.shape[0], dtype=torch.bool, **z),
        counts=torch.empty(len(COUNTS), dtype=torch.int32, **z),
        mbuf=torch.zeros((mm, MERGE_WIDTH), dtype=torch.float32, **z),
        mmat=torch.zeros(mm, dtype=torch.int32, **z),
        fbuf=torch.zeros((ff, FRACTURE_WIDTH), dtype=torch.float32, **z),
        fmat=torch.zeros(ff, dtype=torch.int32, **z),
    )


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a . b over the last axis, left to right: (a0 b0 + a1 b1) + a2 b2."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _weighted(a_i, m_i, a_j, m_j, tot):
    return (a_i * m_i + a_j * m_j) / tot


def _apply_pair(i: int, j: int, b: dict, out: dict, live: np.ndarray, n: dict, k: _Constants,
                cfg: SimConfig) -> None:
    """Pair (i, j), known to overlap, applied in place: the plain version of
    the kernel's `apply_pair`, operation for operation."""
    pos, vel, temp, mass, inv = b["pos"], b["vel"], b["temp"], b["mass"], b["inv_m"]
    d = pos[j] - pos[i]
    dist2 = _dot3(d, d)
    min_dist = b["radius"][i] + b["radius"][j]
    c_new = b["contact"][i, j] + k.h
    timer = c_new
    dist = torch.sqrt(torch.where(dist2 > 0, dist2, 1.0))
    normal = d / dist
    rel = vel[j] - vel[i]
    vn = _dot3(rel, normal)
    if bool(vn < 0):  # approaching
        mi, mj, inv_i, inv_j = mass[i], mass[j], inv[i], inv[j]
        inv_sum = inv_i + inv_j
        safe_inv_sum = torch.where(inv_sum > 0, inv_sum, 1.0)
        m_sum = mi + mj
        tot = torch.where(m_sum > 0, m_sum, 1.0)
        mu = mi * mj / tot
        energy = 0.5 * mu * vn * vn
        q = energy / tot
        temp[i] = temp[i] + energy * inv_i * 0.2  # heating, before the branch
        temp[j] = temp[j] + energy * inv_j * 0.2
        merge = bool(c_new > k.merge_time) and bool(q < k.merge_q)
        fract = (not merge and bool(q > k.fracture_q)
                 and (bool(mi > k.min_fragment_mass) or bool(mj > k.min_fragment_mass)))
        mat = b["mat"][i] if bool(mi > mj) else b["mat"][j]
        if merge:  # payload at fire time, before any correction
            if n["m_cnt"] < cfg.max_merges:
                s = n["m_cnt"]
                out["mbuf"][s] = torch.cat([
                    _weighted(pos[i], mi, pos[j], mj, tot), _weighted(vel[i], mi, vel[j], mj, tot),
                    m_sum[None], _weighted(temp[i], mi, temp[j], mj, tot)[None]])
                out["mmat"][s] = mat
                n["m_cnt"] += 1
            else:
                n["m_drop"] += 1
        else:  # fracture and bounce: position correction
            cv = (min_dist - dist) / safe_inv_sum * k.correction * normal
            pos[i] = pos[i] + -cv * inv_i
            pos[j] = pos[j] + cv * inv_j
        if fract:  # payload after the correction
            if n["f_cnt"] < cfg.max_fractures:
                s = n["f_cnt"]
                f_temp = torch.maximum(temp[i], temp[j]) + energy / tot * 0.1
                out["fbuf"][s] = torch.cat([
                    _weighted(pos[i], mi, pos[j], mj, tot), _weighted(vel[i], mi, vel[j], mj, tot),
                    torch.stack([energy, m_sum, f_temp, min_dist]), 0.5 * (pos[i] + pos[j])])
                out["fmat"][s] = mat
                n["f_cnt"] += 1
            else:
                n["f_drop"] += 1
        if merge or fract:  # both bodies leave the sweep; the pair's timer is deleted
            live[i] = live[j] = False
            timer = torch.zeros_like(c_new)
        else:  # bounce: normal and friction impulses in place
            j_imp = -k.restitution1 * vn / safe_inv_sum
            tr = rel - vn * normal
            t_len = torch.sqrt(_dot3(tr, tr))
            jt = -t_len * k.friction / safe_inv_sum
            imp = j_imp * normal + jt * (tr / torch.where(t_len > 0, t_len, 1.0))
            vel[i] = vel[i] + -imp * inv_i
            vel[j] = vel[j] + imp * inv_j
            n["n_bounces"] += 1
    out["contact"][i, j] = timer
    out["contact"][j, i] = timer


def sweep_reference(pos, vel, temp, mass, radius, inv_m, mat, alive, contact, h: float,
                    cfg: SimConfig) -> Sweep:
    """The sweep in plain PyTorch ops (module docstring), on any device. It
    reads each row's hits and each decision back to the host."""
    c = pos.shape[0]
    k = _Constants.of(cfg, h)
    out = _outputs(pos, vel, temp, contact, cfg)
    b = dict(pos=pos.clone(), vel=vel.clone(), temp=temp.clone(), mass=mass, radius=radius, inv_m=inv_m, mat=mat,
             contact=contact)
    live = alive.cpu().numpy().copy()
    n = dict.fromkeys(COUNTS, 0)
    for i in range(c):
        if not live[i]:
            continue
        j0 = i + 1
        while j0 < c:
            d = b["pos"][j0:] - b["pos"][i]
            min_dist = radius[i] + radius[j0:]
            cand = live[j0:]
            hits = np.flatnonzero((_dot3(d, d) < min_dist * min_dist).cpu().numpy() & cand)
            if hits.size == 0:
                n["n_tests"] += int(cand.sum())
                break
            n["n_tests"] += int(cand[:hits[0] + 1].sum())
            _apply_pair(i, j0 + int(hits[0]), b, out, live, n, k, cfg)
            if not live[i]:
                break
            j0 += int(hits[0]) + 1
    for name in ("pos", "vel", "temp"):
        out[name].copy_(b[name])
    out["removed"].copy_(alive & ~torch.from_numpy(live).to(alive.device))
    out["counts"].copy_(torch.tensor([n[name] for name in COUNTS], dtype=torch.int32))
    return Sweep(**out)


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def sweep(pos, vel, temp, mass, radius, inv_m, mat, alive, contact, h: float, cfg: SimConfig) -> Sweep:
    """One strict-sequential sweep (module docstring) over C bodies: pos,
    vel [C, 3], temp, mass, radius, inv_m [C] float32, mat [C] int32, alive
    [C] bool, contact [C, C] float32, all contiguous. The kernel on CUDA
    tensors (C at most MAX_CAPACITY, else ValueError), `sweep_reference` on
    CPU tensors, and
    ValueError on any other device. `sweep.launches` counts the kernel's
    launches."""
    dev = pos.device
    if dev.type == "cpu":
        return sweep_reference(pos, vel, temp, mass, radius, inv_m, mat, alive, contact, h, cfg)
    if dev.type != "cuda":
        raise ValueError(f"the sequential sweep runs on CPU or CUDA tensors, got {dev}")
    c = pos.shape[0]
    if c > MAX_CAPACITY:
        raise ValueError(f"the sequential sweep's kernel takes at most {MAX_CAPACITY} bodies "
                         f"(capacity {c}): its body arrays live in one block's shared memory")
    for name, t, dtype, shape in (("pos", pos, torch.float32, (c, 3)), ("vel", vel, torch.float32, (c, 3)),
                                  ("temp", temp, torch.float32, (c,)), ("mass", mass, torch.float32, (c,)),
                                  ("radius", radius, torch.float32, (c,)), ("inv_m", inv_m, torch.float32, (c,)),
                                  ("mat", mat, torch.int32, (c,)), ("alive", alive, torch.bool, (c,)),
                                  ("contact", contact, torch.float32, (c, c))):
        _check(name, t, dtype, shape, dev)
    out = _outputs(pos, vel, temp, contact, cfg)
    _launch_into(out, (pos, vel, temp, mass, radius, inv_m, mat, alive, contact), h, cfg)
    sweep.launches += 1
    return Sweep(**out)


def _launch_into(out: dict, args: tuple, h: float, cfg: SimConfig) -> None:
    """Launch the kernel on checked inputs `args` (sweep's first nine) into
    the outputs `out` (`_outputs`), uncounted: `sweep` counts its launches."""
    k = _Constants.of(cfg, h)
    _launch("collide_sequential", [_P] * 19 + [_I] * 3 + [_F] * 8 + [_P], args[0].device,
            *(t.data_ptr() for t in args),
            *(out[name].data_ptr() for name in ("pos", "vel", "temp", "removed", "contact", "counts", "mbuf",
                                                "mmat", "fbuf", "fmat")),
            args[0].shape[0], cfg.max_merges, cfg.max_fractures, k.h, k.merge_time, k.merge_q, k.fracture_q,
            k.min_fragment_mass, k.correction, k.restitution1, k.friction)


sweep.launches = 0
