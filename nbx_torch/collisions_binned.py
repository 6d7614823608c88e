"""Cell-binned bounce resolution (port of `nbx/collisions_binned.py`):
the bounce subsystem (impulse, friction, Baumgarte correction, impact
heating) past the dense resolver's [C, C] envelope, for granular scenes.

  * bodies binned into cells of size >= 2 * max radius (`ops.p3m.cell_bin_full`;
    bodies outside the box are clipped into the face cells);
  * each binned body resolves against the bodies of its 27-cell
    neighbourhood, each cell's first max_per_cell in index order;
  * both ordered copies of every pair are evaluated, each accumulating its
    own target's side of the impulse: the dense Jacobi application, so on a
    bounce-only scene the deltas match `nbx_torch.collisions` to float32
    reordering.

The JAX package evaluates [K, K] blocks of every cell's slots against each
neighbour cell's, K = max_per_cell, and scatters the slot rows back to
bodies. Here each body in the cell table is one target row against its 27
neighbour cells' K slots ([targets, 27, K] pairs): the same pairs and, for
each target, the same sums (each offset's K sources first, the offsets added
in the JAX package's order), without the empty target slots (cells hold a
few bodies where K is sized for the fullest) and without the scatter back.
Bodies past max_per_cell in their cell are neither targets nor sources and
get zero deltas, as in the JAX package. Every shape is fixed by N, the grid
and K: nothing is read back to the host.

Merges, fractures and contact timers stay with the dense and at-scale paths
(`collisions`, `collisions_scaled`).
"""

from __future__ import annotations

import torch

from nbx_torch import thermal
from nbx_torch.config import f32, inverse_mass
from nbx_torch.ops.p3m import _neighbors27, body_cells, cell_bin_full
from nbx_torch.ops.pm import out_of_box_count

CORRECTION = 0.8  # Baumgarte factor (index.html:350)
HEAT_FRACTION = 0.2  # impact heating fraction (index.html:335)
_N_OUT = 7  # a target's deltas: dvel (3), dpos (3), heat (1)


def resolve_bounces_binned(
    pos: torch.Tensor,  # [N, 3], binned over [0, box)^3
    vel: torch.Tensor,  # [N, 3]
    mass: torch.Tensor,  # [N] (0 = dead)
    radius: torch.Tensor,  # [N]
    box_size: float,
    n_cells: int,
    restitution: float = 0.2,
    friction: float = 0.5,
    max_per_cell: int = 32,
    chunk: int = 512,
):
    """One bounce sweep. Returns (dpos [N, 3], dvel [N, 3], dtemp [N],
    n_bounces [] i32, n_overflow [] i32, cell_too_small [] bool): deltas to
    add to the caller's state, the contacts (each counted once), the bodies
    left out of the cell table, and whether 2 max(radius) exceeds the cell
    (pairs can then reach past the 27-neighbourhood: surfaced, never silent).

    Targets are resolved in blocks of chunk * max_per_cell bodies, the
    target slots of the JAX package's chunk of `chunk` cells."""
    n = pos.shape[0]
    g, k = n_cells, max_per_cell
    dev = pos.device
    table, _, n_overflow, dropped = cell_bin_full(pos, box_size, g, k)
    neigh, on_grid = _neighbors27(body_cells(pos, box_size, g).long(), g)  # [N, 27]
    # one pad slot at index N: far outside the box, massless
    pos_p = torch.cat([pos, pos.new_full((1, 3), 2.0 * f32(box_size))])
    vel_p = torch.cat([vel, vel.new_zeros((1, 3))])
    mass_p = torch.cat([mass, mass.new_zeros((1,))])
    rad_p = torch.cat([radius, radius.new_zeros((1,))])
    inv_p = inverse_mass(mass_p)
    # a body left out of the table is no target: its mass reads 0 there
    tmass = torch.where(dropped, 0.0, mass)
    e = f32(restitution)
    # dvel and dpos are subtracted, heat added (the JAX package's order)
    sign = torch.where(torch.arange(_N_OUT, device=dev) < 6, -1.0, 1.0)

    out, n_b = [], torch.zeros((), dtype=torch.int64, device=dev)
    block = chunk * k
    for b0 in range(0, n, block):
        tgt = torch.arange(b0, min(b0 + block, n), device=dev)
        src = torch.where(on_grid[tgt, :, None], table[neigh[tgt]], n).long()  # [B, 27, K]
        tp, tv, tm, tr, tinv = pos[tgt], vel[tgt], tmass[tgt], radius[tgt], inv_p[tgt]
        sp, sv, sm, sr, sinv = pos_p[src], vel_p[src], mass_p[src], rad_p[src], inv_p[src]
        d = sp - tp[:, None, None, :]  # [B, 27, K, 3] i -> j
        r2 = (d * d).sum(-1)
        min_d = tr[:, None, None] + sr
        overlap = (src != tgt[:, None, None]) & (r2 < min_d * min_d) & (tm[:, None, None] > 0) & (sm > 0)
        dist = torch.sqrt(torch.where(r2 > 0, r2, 1.0))
        nrm = d / dist[..., None]
        rv = sv - tv[:, None, None, :]  # v_j - v_i
        vn = (rv * nrm).sum(-1)
        act = overlap & (vn < 0)  # approaching gate (index.html:327)
        inv_sum = tinv[:, None, None] + sinv
        safe_is = torch.where(inv_sum > 0, inv_sum, 1.0)
        j_imp = torch.where(act, -(1.0 + e) * vn / safe_is, 0.0)
        # tangential friction (index.html:364-369)
        t_raw = rv - vn[..., None] * nrm
        t_len = torch.sqrt((t_raw * t_raw).sum(-1))
        t_hat = t_raw / torch.where(t_len > 0, t_len, 1.0)[..., None]
        jt = torch.where(act, -t_len * friction / safe_is, 0.0)
        imp = j_imp[..., None] * nrm + jt[..., None] * t_hat
        # Baumgarte position correction (index.html:350-352)
        corr = torch.where(act, (min_d - dist) / safe_is * CORRECTION, 0.0)
        # impact heating (index.html:333-336): dT_i = E / m_i * 0.2
        m_sum = tm[:, None, None] + sm
        mu = tm[:, None, None] * sm / torch.where(m_sum > 0, m_sum, 1.0)
        energy = torch.where(act, 0.5 * mu * vn * vn, 0.0)
        # each offset's K sources summed first, times this target's 1/m
        per_offset = torch.cat([imp.sum(2) * tinv[:, None, None], (corr[..., None] * nrm).sum(2) * tinv[:, None, None],
                                (energy.sum(2) * tinv[:, None] * HEAT_FRACTION)[..., None]], -1) * sign  # [B, 27, 7]
        acc = torch.zeros((tgt.shape[0], _N_OUT), dtype=torch.float32, device=dev)
        for o in range(27):
            acc = acc + per_offset[:, o]
        out.append(acc)
        n_b = n_b + act.sum()
    res = torch.cat(out) if out else pos.new_zeros((0, _N_OUT))
    # each contact was counted from both sides
    n_bounces = (n_b // 2).to(torch.int32)
    cell_too_small = 2.0 * radius.max() > f32(box_size / g)
    return res[:, 3:6], res[:, 0:3], res[:, 6], n_bounces, n_overflow, cell_too_small


def granular_kdk_scan(
    pos, vel, mass, radius, G: float, eps: float, h: float, box_size: float, n_steps: int,
    n_cells: int = 32, max_per_cell: int = 32, restitution: float = 0.2, friction: float = 0.5,
    heat_decay: float = 0.998, temp=None, force_impl: str = "auto",
):
    """Granular dynamics loop: KDK gravity (`sim.gravity`'s auto | dense |
    blocked | pairwise; "auto" sends N > 2,048 on the card to
    `pairwise_acc`), binned bounces and thermal decay, in the reference's
    substep order (index.html:247-262). The acceleration starts at zero.

    Returns (pos, vel, temp, total_bounces, max_overflow, flags), flags the
    surfaced contract violations (never silent), all 0-dim device tensors:

      * cell_too_small: some step had 2 max(radius) > cell, so contacts may
        be missed;
      * max_out_of_box: the most bodies outside [0, box)^3 after any step.
        The binner clips escapees into the face cells, which crowds them and
        can overflow max_per_cell; positions are not wrapped (the box is a
        binning domain, not periodic space). Nonzero means grow box_size or
        recentre."""
    from nbx_torch.sim import gravity

    dev = pos.device
    if temp is None:
        temp = torch.zeros_like(mass)
    half, hh = f32(0.5 * h), f32(h)
    z = torch.zeros((), dtype=torch.int32, device=dev)
    nb = ovf = oob = z
    small = torch.zeros((), dtype=torch.bool, device=dev)
    p, v, t, a = pos, vel, temp, torch.zeros_like(pos)
    for _ in range(n_steps):
        v = v + a * half
        p = p + v * hh
        a = gravity(p, mass, G, eps, force_impl)
        dp, dv, dt, n_b, n_o, too_small = resolve_bounces_binned(
            p, v, mass, radius, box_size, n_cells, restitution, friction, max_per_cell)
        p, v, t = p + dp, v + dv, t + dt
        v = v + a * half
        t = thermal.decay(t, heat_decay)
        nb = nb + n_b
        ovf = torch.maximum(ovf, n_o)
        small = small | too_small
        oob = torch.maximum(oob, out_of_box_count(p, box_size))
    return p, v, t, nb, ovf, {"cell_too_small": small, "max_out_of_box": oob}
