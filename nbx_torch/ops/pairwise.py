"""Softened direct-sum gravity for many bodies (port of `pairwise_acc` of
`nbx/ops/pairwise.py`, precision "f32r").

`pairwise_acc` sends a CUDA tensor to the hand-written kernel of
`nbx_torch/csrc/pairwise_f32r.cu` and a CPU tensor to
`pairwise_acc_reference`, the plain PyTorch version of the same sum. There is
no fallback from one to the other: a CUDA call launches the kernel or raises.
`pairwise_acc.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from nbx_torch.forces import eps2_of
from nbx_torch.ops import _build

_KERNEL = "pairwise_f32r"


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


def _entry():
    fn = _build.load(_KERNEL).nbx_pairwise_f32r
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
            ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


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
    if not softening > 0:
        raise ValueError(f"pairwise_acc needs softening > 0, got {softening}")
    if target_pos is None:
        target_pos = pos
    if pos.device.type == "cpu":
        return pairwise_acc_reference(pos, mass, G, softening, target_pos)
    if pos.device.type != "cuda":
        raise ValueError(f"pairwise_acc runs on CPU or CUDA tensors, got {pos.device}")

    ns, nt = pos.shape[0], target_pos.shape[0]
    _check("pos", pos, (ns, 3), pos.device)
    _check("mass", mass, (ns,), pos.device)
    _check("target_pos", target_pos, (nt, 3), pos.device)
    src = torch.cat([pos, mass[:, None]], dim=1)  # [Ns, 4] float4 (x, y, z, m)
    tgt = target_pos.contiguous()
    acc = torch.empty((nt, 3), dtype=torch.float32, device=pos.device)
    if nt == 0:
        return acc
    with torch.cuda.device(pos.device):
        err = _entry()(
            tgt.data_ptr(), src.data_ptr(), acc.data_ptr(), nt, ns,
            float(G), eps2_of(softening), torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"pairwise_f32r launch failed: cudaError_t {err}")
    pairwise_acc.launches += 1
    return acc


pairwise_acc.launches = 0
