"""Bloom post-process, the UnrealBloomPass analogue (port of
`nbx/render/bloom.py`): threshold the HDR buffer, blur it with separable
Gaussians at two scales, add it back scaled by `strength`.

Each 1-D pass is a zero-padded shift-and-add in float32 (the JAX package's
`_blur_axis`, tap by tap in the same order), so the blur never leaves fp32:
no convolution library picks a reduced-precision algorithm for it.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

STRENGTH = 1.2  # the reference's UnrealBloomPass strength
THRESHOLD = 0.3  # and threshold


def _gauss_kernel(sigma: float, radius: int) -> np.ndarray:
    """The normalised Gaussian taps, float32 as the JAX package computes them."""
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(np.float32(-0.5) * (x / np.float32(sigma)) ** 2).astype(np.float32)
    return (k / k.sum(dtype=np.float32)).astype(np.float32)


def _blur_axis(img: torch.Tensor, kernel: np.ndarray, axis: int) -> torch.Tensor:
    """Separable 1-D Gaussian along `axis` by shift-and-add over a zero-padded
    copy: zero padding clamps the halo at the image edges (a roll would wrap
    a bright edge body's glow onto the opposite border)."""
    radius = kernel.shape[0] // 2
    n = img.shape[axis]
    pad = [0, 0] * img.ndim  # F.pad lists the last axis first
    pad[2 * (img.ndim - 1 - axis)] = radius
    pad[2 * (img.ndim - 1 - axis) + 1] = radius
    padded = F.pad(img, pad)
    out = torch.zeros_like(img)
    for t in range(kernel.shape[0]):
        out.add_(padded.narrow(axis, t, n), alpha=float(kernel[t]))
    return out


def bloom(hdr: torch.Tensor, strength: float = STRENGTH, threshold: float = THRESHOLD, sigma: float = 3.0,
          radius: int = 8) -> torch.Tensor:
    """hdr + strength * blur(max(hdr - threshold, 0)) at two scales (a small
    and a 2.5x-wider pass, the mip chain's analogue)."""
    bright = torch.clamp(hdr - threshold, min=0.0)
    k1 = _gauss_kernel(sigma, radius)
    b1 = _blur_axis(_blur_axis(bright, k1, 0), k1, 1)
    k2 = _gauss_kernel(sigma * 2.5, radius * 2)
    b2 = _blur_axis(_blur_axis(bright, k2, 0), k2, 1)
    return hdr + strength * (0.6 * b1 + 0.4 * b2)
