"""Particle-mesh (PM) gravity (port of `nbx/ops/pm.py`).

    1. deposit mass onto a g^3 grid with cloud-in-cell (CIC) weights
    2. solve the Poisson equation in Fourier space (`torch.fft`)
    3. spectral gradient -> acceleration grids
    4. CIC-gather the accelerations back to the bodies

Periodic boundaries by construction; isolated (vacuum) boundaries by the 2x
zero-padded Hockney grid with a precomputed Green's-function transform. The
JAX package computes PM with XLA ops, not Pallas, so the port is torch ops:
the deposit is `index_add_`, the transforms `torch.fft`. Everything stays
float32 / complex64.

On a CUDA tensor `index_add_` adds with atomics, so the order of each grid
cell's sum, and its last bits, change from run to run; on the CPU the order is
fixed.
"""

from __future__ import annotations

import math

import torch

from nbx_torch.config import CUDA, f32
from nbx_torch.profiling import span, spanned

_F32 = torch.float32


def _scalar(x: float, device) -> torch.Tensor:
    """A float32 0-dim tensor on `device`, made by a fill (no host copy). A
    CUDA division by a host scalar multiplies by its reciprocal; dividing by
    this divides."""
    return torch.full((), x, dtype=_F32, device=device)


def spacing(box_size, g: int, device) -> torch.Tensor:
    """box / g as a float32 0-dim tensor on `device`, the box a Python float
    or a 0-dim tensor (a size computed on the device, as the two-level P3M
    submesh's): one correctly rounded float32 division either way, so both
    give the same bits and neither reads the device."""
    if isinstance(box_size, torch.Tensor):
        return box_size.to(device=device, dtype=_F32) / _scalar(float(g), device)
    return _scalar(f32(f32(box_size) / f32(g)), device)


def _cic_parts(pos: torch.Tensor, box_size, g: int):
    """CIC base cell + fractional offsets, cell-centred. pos in [0, box)^3;
    the box a Python float or a 0-dim tensor (`spacing`)."""
    h = spacing(box_size, g, pos.device)
    u = pos / h - 0.5
    i0 = torch.floor(u).to(torch.int32)
    return i0, u - i0


def _axis_index_weight(i: torch.Tensor, w: torch.Tensor, g: int, periodic: bool):
    """Periodic wraps the index; isolated clamps it and zeroes the weight of
    an out-of-range contribution, so mass outside [0, box) never aliases to
    the opposite face."""
    if periodic:
        return torch.remainder(i, g), w
    valid = (i >= 0) & (i < g)
    return i.clamp(0, g - 1), torch.where(valid, w, 0.0)


def _corners(pos: torch.Tensor, box_size, g: int, periodic: bool):
    """The 8 CIC corners as (flat grid index [N] i64, weight [N]), in the
    JAX package's (dx, dy, dz) order."""
    i0, f = _cic_parts(pos, box_size, g)
    for dx in (0, 1):
        wx = 1.0 - f[:, 0] if dx == 0 else f[:, 0]
        ix, wx = _axis_index_weight(i0[:, 0] + dx, wx, g, periodic)
        for dy in (0, 1):
            wy = 1.0 - f[:, 1] if dy == 0 else f[:, 1]
            iy, wy = _axis_index_weight(i0[:, 1] + dy, wy, g, periodic)
            for dz in (0, 1):
                wz = 1.0 - f[:, 2] if dz == 0 else f[:, 2]
                iz, wz = _axis_index_weight(i0[:, 2] + dz, wz, g, periodic)
                flat = ((ix.long() * g + iy) * g + iz)
                yield flat, wx * wy * wz


@spanned("nbx.pm.deposit")
def cic_deposit(pos: torch.Tensor, mass: torch.Tensor, box_size, g: int,
                periodic: bool = True) -> torch.Tensor:
    """Scatter mass to the [g, g, g] density grid (CIC). periodic=False drops
    contributions outside the grid: a body fully outside [0, box)^3 deposits
    nothing. box_size: a Python float or a 0-dim tensor, the same bits."""
    grid = torch.zeros(g * g * g, dtype=_F32, device=pos.device)
    for flat, w in _corners(pos, box_size, g, periodic):
        grid.index_add_(0, flat, mass * w)
    return grid.view(g, g, g)


@spanned("nbx.pm.gather")
def cic_gather(field: torch.Tensor, pos: torch.Tensor, box_size, g: int,
               periodic: bool = True) -> torch.Tensor:
    """Gather a [g, g, g, C] grid field to the bodies ([N, C]). periodic=False
    zeroes out-of-range weights: a body fully outside [0, box)^3 gathers
    zero. box_size: a Python float or a 0-dim tensor, the same bits."""
    flat_field = field.reshape(g * g * g, -1)
    out = None
    for flat, w in _corners(pos, box_size, g, periodic):
        term = flat_field[flat] * w[:, None]
        out = term if out is None else out + term
    return out


def out_of_box_count(pos: torch.Tensor, box_size: float) -> torch.Tensor:
    """Number of bodies with any coordinate outside [0, box), int32 [] (the
    PM domain-contract counter)."""
    box = f32(box_size)
    return ((pos < 0) | (pos >= box)).any(-1).sum(dtype=torch.int32)


def _fftfreq(n: int, d: float, device) -> torch.Tensor:
    return torch.fft.fftfreq(n, d=d, dtype=_F32, device=device)


def _kvec(g: int, box_size: float, device):
    k1 = 2 * math.pi * _fftfreq(g, f32(box_size) / g, device)
    kx, ky, kz = k1[:, None, None], k1[None, :, None], k1[None, None, :]
    return kx, ky, kz, kx**2 + ky**2 + kz**2


def _kvec_r(g: int, box_size: float, device):
    """fftfreq wavevectors for the rfftn half-spectrum (last axis halved)."""
    d = f32(box_size) / g
    k1 = 2 * math.pi * _fftfreq(g, d, device)
    kzr = 2 * math.pi * torch.fft.rfftfreq(g, d=d, dtype=_F32, device=device)
    return k1[:, None, None], k1[None, :, None], kzr[None, None, :]


def _cic_window_r(g: int, device) -> torch.Tensor:
    """_cic_window on the rfftn half-spectrum grid."""
    w1 = torch.sinc(_fftfreq(g, 1.0, device))
    wr = torch.sinc(torch.fft.rfftfreq(g, dtype=_F32, device=device))
    w = w1[:, None, None] ** 2 * w1[None, :, None] ** 2 * wr[None, None, :] ** 2
    return torch.clamp(w, min=0.05)


def _cic_window(g: int, device) -> torch.Tensor:
    """CIC assignment window W(k) = prod sinc^2(k h / 2) on the FFT grid,
    floored away from zero for a stable deconvolution."""
    w1 = torch.sinc(_fftfreq(g, 1.0, device))
    w = w1[:, None, None] ** 2 * w1[None, :, None] ** 2 * w1[None, None, :] ** 2
    return torch.clamp(w, min=0.05)


def isolated_green_hat(box_size: float, g: int, smooth_a: float = 0.0,
                       smoothed: bool = False, device=CUDA) -> torch.Tensor:
    """rfftn of the free-space Green's function on the 2g-padded Hockney grid
    ([2g, 2g, g + 1] complex64). It depends on (box, g) only, so a frame loop
    computes it once and passes it to pm_acceleration.

    smoothed=False: -1/r (the r = 0 cell takes -1/(h/2)). smoothed=True:
    -erf(r / smooth_a) / r, the P3M long-range kernel (-2/(a sqrt(pi)) at
    r = 0)."""
    gp = 2 * g
    h = f32(f32(box_size) / g)
    idx = torch.arange(gp, device=device)
    d1 = torch.minimum(idx, gp - idx).to(_F32) * h
    rx, ry, rz = d1[:, None, None], d1[None, :, None], d1[None, None, :]
    r = torch.sqrt(rx**2 + ry**2 + rz**2)
    safe_r = torch.where(r > 0, r, 1.0)
    if smoothed:
        a = f32(smooth_a)
        green = torch.where(
            r > 0, -torch.special.erf(r / a) / safe_r,
            -2.0 / f32(a * f32(math.sqrt(math.pi))),
        )
    else:
        green = torch.where(r > 0, -1.0 / safe_r, -1.0 / f32(0.5 * h))
    return torch.fft.rfftn(green)


def _i_times(k: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """1j * k * z for a real k, in complex64."""
    return torch.complex(torch.zeros_like(k), k) * z


@spanned("nbx.pm.solve")
def _isolated_solve_r(rho: torch.Tensor, G: float, box_size: float, g: int,
                      green_hat: torch.Tensor, deconvolve: bool = True) -> torch.Tensor:
    """[g, g, g, 3] acceleration grid from a [g]^3 density grid: Hockney
    zero-padding and the precomputed green_hat, real transforms
    (rfftn / irfftn) throughout."""
    gp = 2 * g
    dev = rho.device
    rho_p = torch.zeros((gp, gp, gp), dtype=_F32, device=dev)
    rho_p[:g, :g, :g] = rho
    phi_hat = torch.fft.rfftn(rho_p) * green_hat * f32(G)
    if deconvolve:
        phi_hat = phi_hat / _cic_window_r(gp, dev) ** 2
    kx, ky, kz = _kvec_r(gp, 2 * f32(box_size), dev)
    s = (gp, gp, gp)
    acc = [torch.fft.irfftn(_i_times(k, phi_hat), s=s) for k in (kx, ky, kz)]
    return -torch.stack(acc, dim=-1)[:g, :g, :g]


def pm_solve_grid(rho: torch.Tensor, G: float, box_size: float, g: int,
                  isolated: bool = True, deconvolve: bool = True,
                  green_hat: torch.Tensor | None = None) -> torch.Tensor:
    """[g, g, g, 3] acceleration grid from a deposited density grid."""
    dev = rho.device
    if isolated:
        if green_hat is None:
            green_hat = isolated_green_hat(box_size, g, device=dev)
        return _isolated_solve_r(rho, G, box_size, g, green_hat, deconvolve)
    with span("nbx.pm.solve"):  # the isolated solve opens its own
        kx, ky, kz, k2 = _kvec(g, box_size, dev)
        rho_hat = torch.fft.fftn(rho)
        vol = f32(f32(box_size) / g) ** 3
        safe_k2 = torch.where(k2 > 0, k2, 1.0)
        phi_hat = torch.where(
            k2 > 0, -4 * math.pi * f32(G) * rho_hat / (safe_k2 * f32(vol)), 0.0
        )
        if deconvolve:
            phi_hat = phi_hat / _cic_window(g, dev) ** 2
        acc = [torch.fft.ifftn(_i_times(k, phi_hat)).real for k in (kx, ky, kz)]
        return -torch.stack(acc, dim=-1)


@spanned("nbx.pm")
def pm_acceleration(pos: torch.Tensor, mass: torch.Tensor, G: float, box_size: float,
                    g: int = 128, isolated: bool = True, deconvolve: bool = True,
                    green_hat: torch.Tensor | None = None) -> torch.Tensor:
    """PM gravitational acceleration at each body, [N, 3].

    isolated=True solves vacuum boundaries on a 2x zero-padded grid with the
    free-space Green's function; False is fully periodic. deconvolve divides
    out the CIC window twice (deposit + gather). Pass green_hat
    (= isolated_green_hat(box, g)) to skip its transform per evaluation."""
    rho = cic_deposit(pos, mass, box_size, g, periodic=not isolated)
    acc_grid = pm_solve_grid(rho, G, box_size, g, isolated, deconvolve, green_hat)
    return cic_gather(acc_grid, pos, box_size, g, periodic=not isolated)


def pm_kdk_scan(pos: torch.Tensor, vel: torch.Tensor, mass: torch.Tensor, G: float,
                box_size: float, h: float, n_steps: int, g: int = 128,
                isolated: bool = True):
    """KDK leapfrog with PM forces, n_steps steps of size h. Periodic runs
    (isolated=False) wrap the drift back into [0, box).

    Returns (pos, vel, max_out_of_box): the most bodies outside [0, box)^3 at
    any step; isolated runs lose those bodies from the PM field."""
    def force(p):
        return pm_acceleration(p, mass, G, box_size, g, isolated)

    half = f32(0.5 * f32(h))
    acc = force(pos)
    oob = torch.zeros((), dtype=torch.int32, device=pos.device)
    for _ in range(n_steps):
        vel = vel + acc * half
        pos = pos + vel * f32(h)
        if not isolated:
            pos = torch.remainder(pos, f32(box_size))
        acc = force(pos)
        vel = vel + acc * half
        oob = torch.maximum(oob, out_of_box_count(pos, box_size))
    return pos, vel, oob
