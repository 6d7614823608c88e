"""Dense softened pairwise gravity — small-N path and plain reference (port of
`nbx/forces.py`).

Plummer softening, f = G / (d^2 + eps^2)^(3/2), acc_i += f * m_j * (p_j - p_i).
The i == j term is exactly zero (finite f times zero displacement) as long as
eps > 0; the dense forms mask the diagonal and zero distances explicitly.

`accelerations_blocked` avoids the O(N^2) memory of the dense form with a loop
over row blocks; above `sim._DENSE_MAX` bodies a CUDA tensor goes to the
kernel of `nbx_torch.ops.pairwise` instead.
"""

from __future__ import annotations

import torch

from .config import f32


def eps2_of(softening: float) -> float:
    """eps^2 rounded as the JAX package rounds it (a float32 square)."""
    return f32(f32(softening) ** 2)


def accelerations(pos: torch.Tensor, mass: torch.Tensor, G: float, softening: float) -> torch.Tensor:
    """Direct-sum softened gravity, O(N^2) memory. pos [N,3], mass [N] -> acc [N,3]."""
    d = pos[None, :, :] - pos[:, None, :]  # d[i, j] = p_j - p_i
    r2 = (d * d).sum(-1) + eps2_of(softening)
    n = pos.shape[0]
    # Guard zero distances for eps == 0: the diagonal, and coincident pairs
    # (dead slots all parked at the origin): 0^-1.5 * 0 = nan.
    zero = (r2 <= 0.0) | torch.eye(n, dtype=torch.bool, device=pos.device)
    safe = torch.where(zero, 1.0, r2)
    f = G * torch.rsqrt(safe) / safe
    w = torch.where(zero, 0.0, f * mass[None, :])
    return torch.einsum("ij,ijc->ic", w, d)


def accelerations_blocked(
    pos: torch.Tensor, mass: torch.Tensor, G: float, softening: float, block: int = 1024
) -> torch.Tensor:
    """Same physics, O(N * block) memory, one row block at a time.

    N must be a multiple of `block` (pad with mass-0 bodies otherwise)."""
    n = pos.shape[0]
    if n % block:
        raise ValueError(f"N={n} not divisible by block={block}")
    eps2 = eps2_of(softening)
    out = []
    for i0 in range(0, n, block):
        pi = pos[i0 : i0 + block]
        d = pos[None, :, :] - pi[:, None, :]  # [B, N, 3]
        r2 = (d * d).sum(-1) + eps2
        safe = torch.where(r2 > 0, r2, 1.0)
        f = G * torch.rsqrt(safe) / safe
        w = torch.where(r2 > 0, f * mass[None, :], 0.0)
        out.append(torch.einsum("ij,ijc->ic", w, d))
    return torch.cat(out)


def acc_and_jerk(
    pos: torch.Tensor, mass: torch.Tensor, vel: torch.Tensor, G: float, softening: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """Softened acceleration and its time derivative (jerk):

        acc_i  = G sum_j m_j d_ij / s^3,           s^2 = |d|^2 + eps^2
        jerk_i = G sum_j m_j [ v_ij / s^3 - 3 (d_ij . v_ij) d_ij / s^5 ]

    with the pair masking of accelerations()."""
    d = pos[None, :, :] - pos[:, None, :]
    dv = vel[None, :, :] - vel[:, None, :]
    r2 = (d * d).sum(-1) + eps2_of(softening)
    n = pos.shape[0]
    zero = (r2 <= 0.0) | torch.eye(n, dtype=torch.bool, device=pos.device)
    safe = torch.where(zero, 1.0, r2)
    inv = torch.rsqrt(safe)
    inv3 = inv / safe  # s^-3
    w = torch.where(zero, 0.0, G * mass[None, :] * inv3)
    acc = torch.einsum("ij,ijc->ic", w, d)
    rv = (d * dv).sum(-1)  # d . v per pair
    jerk = torch.einsum("ij,ijc->ic", w, dv) - torch.einsum(
        "ij,ijc->ic", w * 3.0 * rv / safe, d
    )
    return acc, jerk


def potential_energy(
    pos: torch.Tensor, mass: torch.Tensor, G: float, softening: float, block: int | None = None
) -> torch.Tensor:
    """Softened potential energy consistent with the force law:
    U = -G * sum_{i<j} m_i m_j / sqrt(d^2 + eps^2)."""
    eps2 = eps2_of(softening)
    n = pos.shape[0]
    if block is None:
        d = pos[None, :, :] - pos[:, None, :]
        r2 = (d * d).sum(-1) + eps2
        zero = (r2 <= 0.0) | torch.eye(n, dtype=torch.bool, device=pos.device)
        inv_r = torch.rsqrt(torch.where(zero, 1.0, r2))
        mm = torch.where(zero, 0.0, mass[:, None] * mass[None, :])
        return -0.5 * G * (mm * inv_r).sum()

    if n % block:
        raise ValueError(f"N={n} not divisible by block={block}")
    col = torch.arange(n, device=pos.device)
    total = []
    for i0 in range(0, n, block):
        pi = pos[i0 : i0 + block]
        mi = mass[i0 : i0 + block]
        d = pos[None, :, :] - pi[:, None, :]
        r2 = (d * d).sum(-1) + eps2
        row = torch.arange(i0, i0 + block, device=pos.device)
        zero = (row[:, None] == col[None, :]) | (r2 <= 0.0)
        r2 = torch.where(zero, 1.0, r2)
        mm = torch.where(zero, 0.0, mi[:, None] * mass[None, :])
        total.append((mm * torch.rsqrt(r2)).sum())
    return -0.5 * G * torch.stack(total).sum()


def kinetic_energy(vel: torch.Tensor, mass: torch.Tensor) -> torch.Tensor:
    return 0.5 * (mass * (vel * vel).sum(-1)).sum()
