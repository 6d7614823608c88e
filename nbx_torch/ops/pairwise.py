"""Softened direct sums over many bodies (port of `pairwise_acc` (precision
"f32r"), `pairwise_acc_jerk`, `potential_per_body` and `potential_energy` of
`nbx/ops/pairwise.py`).

Each wrapper sends a CUDA tensor to its hand-written kernel and a CPU tensor
to its plain PyTorch version (`*_reference`):

- `pairwise_acc`: `nbx_torch/csrc/pairwise_f32r.cu` (K1);
- `pairwise_acc_jerk`: `nbx_torch/csrc/pairwise_accjerk.cu` (K6);
- `potential_per_body`: `nbx_torch/csrc/potential.cu` (K3).

There is no fallback from one to the other: a CUDA call launches the kernel
or raises. Each wrapper's `.launches` counts its kernel launches. The kernels
take float32 only and need softening > 0: none masks the diagonal.
"""

from __future__ import annotations

import ctypes

import torch

from nbx_torch.forces import eps2_of
from nbx_torch.ops import _build


def pairwise_acc_reference(
    pos: torch.Tensor,
    mass: torch.Tensor,
    G: float,
    softening: float,
    target_pos: torch.Tensor | None = None,
    block: int = 1024,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel's sum, in blocks of `block`
    targets: acc_i = G sum_j m_j d (|d|^2 + eps^2)^-3/2, d = p_j - p_i, no
    diagonal mask (the self pair contributes 0 for eps > 0)."""
    if target_pos is None:
        target_pos = pos
    eps2 = eps2_of(softening)
    out = []
    for i0 in range(0, target_pos.shape[0], block):
        t = target_pos[i0 : i0 + block]
        d = pos[None, :, :] - t[:, None, :]  # [B, Ns, 3]
        r2 = (d * d).sum(-1) + eps2
        inv = torch.rsqrt(r2)
        w = inv * inv * inv * mass[None, :]
        out.append((w[:, :, None] * d).sum(1))
    if not out:
        return target_pos.new_zeros((0, 3))
    return torch.cat(out) * G


def _check(name: str, t: torch.Tensor, shape: tuple, device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")


def _on_card(fn: str, pos: torch.Tensor, softening: float) -> bool:
    """True for a CUDA tensor (the kernel), False for a CPU one (the plain
    version); raises on softening <= 0 and on other devices."""
    if not softening > 0:
        raise ValueError(f"{fn} needs softening > 0, got {softening}")
    if pos.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn} runs on CPU or CUDA tensors, got {pos.device}")
    return pos.device.type == "cuda"


def _entry(kernel: str, argtypes: list):
    fn = getattr(_build.load(kernel), f"nbx_{kernel}")
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _launch(kernel: str, argtypes: list, device: torch.device, *args) -> None:
    """Launch csrc/<kernel>.cu's entry on the device's current stream; raise
    on a refused launch."""
    with torch.cuda.device(device):
        err = _entry(kernel, argtypes)(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError_t {err}")


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def pairwise_acc(
    pos: torch.Tensor,
    mass: torch.Tensor,
    G: float,
    softening: float,
    target_pos: torch.Tensor | None = None,
) -> torch.Tensor:
    """Softened gravitational acceleration of all sources on the targets.

    pos [Ns, 3], mass [Ns] -> acc at target_pos [Nt, 3] (targets default to
    the sources), float32. G and softening are Python floats; softening must
    be > 0, since the self pair is defined only then."""
    if target_pos is None:
        target_pos = pos
    if not _on_card("pairwise_acc", pos, softening):
        return pairwise_acc_reference(pos, mass, G, softening, target_pos)

    ns, nt = pos.shape[0], target_pos.shape[0]
    _check("pos", pos, (ns, 3), pos.device)
    _check("mass", mass, (ns,), pos.device)
    _check("target_pos", target_pos, (nt, 3), pos.device)
    src = torch.cat([pos, mass[:, None]], dim=1)  # [Ns, 4] float4 (x, y, z, m)
    tgt = target_pos.contiguous()
    acc = torch.empty((nt, 3), dtype=torch.float32, device=pos.device)
    if nt == 0:
        return acc
    _launch("pairwise_f32r", [_P, _P, _P, _I, _I, _F, _F, _P], pos.device,
            tgt.data_ptr(), src.data_ptr(), acc.data_ptr(), nt, ns, float(G), eps2_of(softening))
    pairwise_acc.launches += 1
    return acc


pairwise_acc.launches = 0


def pairwise_acc_jerk_reference(
    pos: torch.Tensor,
    mass: torch.Tensor,
    vel: torch.Tensor,
    G: float,
    softening: float,
    target_pos: torch.Tensor | None = None,
    target_vel: torch.Tensor | None = None,
    block: int = 1024,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K6's sums, in blocks of `block` targets:
    w = m_j / s^3, acc_i = G sum_j w d, jerk_i = G sum_j w (dv - 3 (d.dv)/s^2
    d), s^2 = |d|^2 + eps^2, no diagonal mask (the self pair adds 0 for
    eps > 0)."""
    if target_pos is None:
        target_pos, target_vel = pos, vel
    eps2 = eps2_of(softening)
    accs, jerks = [], []
    for i0 in range(0, target_pos.shape[0], block):
        d = pos[None, :, :] - target_pos[i0 : i0 + block, None, :]  # [B, Ns, 3]
        dv = vel[None, :, :] - target_vel[i0 : i0 + block, None, :]
        inv = torch.rsqrt((d * d).sum(-1) + eps2)
        inv2 = inv * inv
        w = (inv * inv2 * mass[None, :])[:, :, None]  # m_j / s^3
        c = (3.0 * (d * dv).sum(-1) * inv2)[:, :, None]  # 3 (d.dv) / s^2
        accs.append((w * d).sum(1))
        jerks.append((w * (dv - c * d)).sum(1))
    if not accs:
        empty = target_pos.new_zeros((0, 3))
        return empty, empty.clone()
    return torch.cat(accs) * G, torch.cat(jerks) * G


def pairwise_acc_jerk(
    pos: torch.Tensor,
    mass: torch.Tensor,
    vel: torch.Tensor,
    G: float,
    softening: float,
    target_pos: torch.Tensor | None = None,
    target_vel: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Softened acceleration and jerk of all sources on the targets, the
    Hermite scheme's force evaluation (`integrators.hermite_step`).

    pos, vel [Ns, 3], mass [Ns] -> (acc [Nt, 3], jerk [Nt, 3]) at
    target_pos, target_vel (both or neither; they default to the sources),
    float32. softening must be > 0."""
    if (target_pos is None) != (target_vel is None):
        raise ValueError("pairwise_acc_jerk takes target_pos and target_vel together")
    if target_pos is None:
        target_pos, target_vel = pos, vel
    if not _on_card("pairwise_acc_jerk", pos, softening):
        return pairwise_acc_jerk_reference(pos, mass, vel, G, softening, target_pos, target_vel)

    ns, nt = pos.shape[0], target_pos.shape[0]
    dev = pos.device
    for name, t, shape in (("pos", pos, (ns, 3)), ("mass", mass, (ns,)), ("vel", vel, (ns, 3)),
                           ("target_pos", target_pos, (nt, 3)), ("target_vel", target_vel, (nt, 3))):
        _check(name, t, shape, dev)
    # [Ns, 8]: two float4 a source, (x, y, z, m) and (vx, vy, vz, 0)
    src = torch.cat([pos, mass[:, None], vel, mass.new_zeros((ns, 1))], dim=1)
    tp, tv = target_pos.contiguous(), target_vel.contiguous()
    acc = torch.empty((nt, 3), dtype=torch.float32, device=dev)
    jerk = torch.empty((nt, 3), dtype=torch.float32, device=dev)
    if nt == 0:
        return acc, jerk
    _launch("pairwise_accjerk", [_P, _P, _P, _P, _P, _I, _I, _F, _F, _P], dev,
            tp.data_ptr(), tv.data_ptr(), src.data_ptr(), acc.data_ptr(), jerk.data_ptr(), nt, ns,
            float(G), eps2_of(softening))
    pairwise_acc_jerk.launches += 1
    return acc, jerk


pairwise_acc_jerk.launches = 0


def _remove_self_term(phi: torch.Tensor, G: float, softening: float, target_mass: torch.Tensor):
    """phi + G m_i / eps: the i == j term of the sum, as `nbx` removes it."""
    return phi + G * target_mass / softening


def potential_per_body_reference(
    pos: torch.Tensor,
    mass: torch.Tensor,
    G: float,
    softening: float,
    target_pos: torch.Tensor | None = None,
    target_mass: torch.Tensor | None = None,
    block: int = 1024,
) -> torch.Tensor:
    """Plain PyTorch version of `potential_per_body`: K3's sum
    -G sum_j m_j (|d|^2 + eps^2)^-1/2 in blocks of `block` targets, self term
    included, then the self term removed as the wrapper removes it."""
    if target_pos is None:
        target_pos = pos
    if target_mass is None:
        target_mass = mass
    eps2 = eps2_of(softening)
    out = []
    for i0 in range(0, target_pos.shape[0], block):
        d = pos[None, :, :] - target_pos[i0 : i0 + block, None, :]  # [B, Ns, 3]
        out.append((torch.rsqrt((d * d).sum(-1) + eps2) * mass[None, :]).sum(1))
    phi = torch.cat(out) * -G if out else target_pos.new_zeros((0,))
    return _remove_self_term(phi, G, softening, target_mass)


def potential_per_body(
    pos: torch.Tensor,
    mass: torch.Tensor,
    G: float,
    softening: float,
    target_pos: torch.Tensor | None = None,
    target_mass: torch.Tensor | None = None,
) -> torch.Tensor:
    """phi_i = -G sum_{j != i} m_j / sqrt(d^2 + eps^2) per target, [Nt]
    float32.

    Targets default to the sources. When the targets are a subset of the
    sources (the sharded path), pass target_pos and target_mass: each target
    must appear exactly once among the sources, since the kernel's sum holds
    its self term -G m_i / eps and the wrapper subtracts it. Total potential
    energy U = 0.5 sum_i m_i phi_i (`potential_energy`). softening must be
    > 0."""
    if target_pos is None:
        target_pos = pos
    if target_mass is None:
        target_mass = mass
    if not _on_card("potential_per_body", pos, softening):
        return potential_per_body_reference(pos, mass, G, softening, target_pos, target_mass)

    ns, nt = pos.shape[0], target_pos.shape[0]
    dev = pos.device
    for name, t, shape in (("pos", pos, (ns, 3)), ("mass", mass, (ns,)),
                           ("target_pos", target_pos, (nt, 3)), ("target_mass", target_mass, (nt,))):
        _check(name, t, shape, dev)
    src = torch.cat([pos, mass[:, None]], dim=1)  # [Ns, 4] float4 (x, y, z, m)
    tgt = target_pos.contiguous()
    phi = torch.empty((nt,), dtype=torch.float32, device=dev)
    if nt == 0:
        return phi
    _launch("potential", [_P, _P, _P, _I, _I, _F, _F, _P], dev,
            tgt.data_ptr(), src.data_ptr(), phi.data_ptr(), nt, ns, float(G), eps2_of(softening))
    potential_per_body.launches += 1
    return _remove_self_term(phi, G, softening, target_mass)


potential_per_body.launches = 0


def potential_energy(pos: torch.Tensor, mass: torch.Tensor, G: float, softening: float) -> torch.Tensor:
    """Total softened potential energy 0.5 sum_i m_i phi_i through
    `potential_per_body` (K3 on the card)."""
    return 0.5 * (mass * potential_per_body(pos, mass, G, softening)).sum()
