"""Plain float64 reference of softened direct-sum gravity and of the KDK
substep, and the gaps by which a run's answers may differ from it.

It imports torch and numpy only: nothing of the program under test. It is
given the inputs the benchmark made (the scene, or the positions, velocities
and masses at the start of a call, which it follows from) and computes
everything else anew, the force at the call's start included.

The law, per target i over every source j (the self pair adds m_i x 0 = 0):

    a_i = G sum_j m_j (x_j - x_i) / (|x_j - x_i|^2 + eps^2)^(3/2)

In float64, in blocks of targets. |x_j - x_i|^2 + eps^2 comes from one
matrix product of [x_i, |x_i|^2 + eps^2, 1] and [-2 x_j, 1, |x_j|^2]: a
float64 rounding of |x|^2 (|x| the coordinates' size), far below float32's
on every pair the scenes hold. The mass-weighted sums come from a second
product with [m_j x_j, m_j].

Beside each force it gives the force's scale, G sum_j m_j / (|x_j - x_i|^2 +
eps^2), no smaller than the sum of its terms' sizes: a float32 sum is good
to some roundings of that sum, whatever the terms cancel to, and a bfloat16
one to some of its roundings. The gaps are measured against it, so that a
run's reading does not grow as the scene clusters and its terms cancel more.
"""

from __future__ import annotations

import numpy as np
import torch

# Elements of one block's [targets, sources] float64 matrix: 2 GiB.
BLOCK_ELEMENTS = 1 << 28


def f32(x: float) -> float:
    """x rounded to float32, as a Python float."""
    return float(np.float32(x))


def accelerations(src_pos: torch.Tensor, src_mass: torch.Tensor, tgt_pos: torch.Tensor, G: float,
                  softening: float) -> tuple[torch.Tensor, torch.Tensor]:
    """([Nt, 3], [Nt]) float64: the force law above of every source on each
    target, and its scale G sum_j m_j / (|x_j - x_i|^2 + eps^2); softening
    eps taken at its float32 value."""
    x, m, t = src_pos.double(), src_mass.double(), tgt_pos.double()
    eps2 = f32(softening) ** 2
    right = torch.cat([-2.0 * x, torch.ones_like(m)[:, None], (x * x).sum(1, keepdim=True)], 1).T.contiguous()
    weights = torch.cat([x * m[:, None], m[:, None]], 1)  # [Ns, 4]
    out = torch.empty((t.shape[0], 3), dtype=torch.float64, device=t.device)
    scale = torch.empty((t.shape[0],), dtype=torch.float64, device=t.device)
    block = max(1, BLOCK_ELEMENTS // max(1, x.shape[0]))
    for i0 in range(0, t.shape[0], block):
        ti = t[i0:i0 + block]
        left = torch.cat([ti, (ti * ti).sum(1, keepdim=True) + eps2, torch.ones_like(ti[:, :1])], 1)
        w = left @ right  # |x_j - x_i|^2 + eps^2
        w.reciprocal_()
        scale[i0:i0 + block] = w @ m
        w.pow_(1.5)
        s = w @ weights  # [B, 4]: sum_j w m_j x_j, sum_j w m_j
        out[i0:i0 + block] = s[:, :3] - ti * s[:, 3:]
        del w
    return out * G, scale * G


def kdk(pos: torch.Tensor, vel: torch.Tensor, mass: torch.Tensor, G: float, softening: float, h: float,
        substeps: int, rows=slice(None), a0: torch.Tensor | None = None):
    """`substeps` KDK substeps of h from the positions and velocities of
    every body, in float64: half-kick, drift, the force at the new
    positions, half-kick. The first half-kick takes a0, the force at `pos`
    on every body, worked out here where it is not given (a caller that has
    it already in blocks of rows passes it). Returns (pos, vel, acc, scale,
    mean scale) after the last substep for the bodies `rows` (all by
    default): the last force's scale and the mean of the substeps' forces'
    scales. Every substep before the last takes the force on every body, the
    last only on `rows`."""
    x, v = pos.double(), vel.double()
    a = accelerations(x, mass, x, G, softening)[0] if a0 is None else a0.double()
    half = 0.5 * h
    scales = 0.0
    for s in range(substeps):
        v = v + a * half
        x = x + v * h
        if s == substeps - 1:
            a_rows, scale = accelerations(x, mass, x[rows], G, softening)
            return x[rows], v[rows] + a_rows * half, a_rows, scale, (scales + scale) / substeps
        a, scale = accelerations(x, mass, x, G, softening)
        scales = scales + scale[rows]
        v = v + a * half
    raise ValueError(f"substeps must be at least 1, got {substeps}")


EPS32 = 2.0 ** -23  # float32's ulp of 1


def acc_gap(program: torch.Tensor, reference: torch.Tensor, scale: torch.Tensor) -> float:
    """The widest gap of a body's acceleration from the reference's, over
    its force's scale: max_i |a_p - a_r| / scale_i."""
    delta = (program.double() - reference.double()).norm(dim=1)
    return float((delta / scale).max())


def dvel_gap(program: torch.Tensor, reference: torch.Tensor, start: torch.Tensor, dt: float, kicks: int,
             scale: torch.Tensor) -> float:
    """The widest gap of a body's velocity after a call from the reference's,
    past what float32 storage of the velocity allows, over the kick the
    forces' scale gives in the call's time dt:
    max_i max(0, |v_p - v_r| - kicks eps32 max(|v_0|, |v_r|)) / (dt scale_i),
    v_0 the velocity both started from and `kicks` the half-kicks, each of
    which rounds the stored velocity once (at most one ulp, eps32 |v|)."""
    r = reference.double()
    delta = (program.double() - r).norm(dim=1)
    stored = kicks * EPS32 * torch.maximum(start.double().norm(dim=1), r.norm(dim=1))
    return float(((delta - stored).clamp(min=0.0) / (dt * scale)).max())
