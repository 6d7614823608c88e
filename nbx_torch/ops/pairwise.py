"""Softened direct sums over many bodies (port of `pairwise_acc`,
`pairwise_acc_jerk`, `potential_per_body` and `potential_energy` of
`nbx/ops/pairwise.py`).

Each wrapper sends a CUDA tensor to its hand-written kernel and a CPU tensor
to its plain PyTorch version (`*_reference`):

- `pairwise_acc`: precision "f32r" (the default) `nbx_torch/csrc/pairwise_f32r.cu`
  (K1: the symmetric sum where the targets are the sources and N lies in
  [SYM_MIN_N, SYM_MAX_N], `symmetric_k1`; the one-sided sum otherwise);
  "f32", "hyb" and "bf16" `nbx_torch/csrc/pairwise_precision.cu` (K1a,
  K1d, K1e), through `pairwise_acc_f32`, `_hyb`, `_bf16`; "fast"
  `nbx_torch/csrc/pairwise_fast.cu` and "mxu" `nbx_torch/csrc/pairwise_mxu.cu`
  (K1b, K1c, their bf16 products on the tensor cores), through
  `pairwise_acc_fast`, `_mxu`. Every one splits its sources over a second
  grid dimension (`source_splits`) and adds the splits' partials in a
  second pass;
- `pairwise_acc_jerk`: `nbx_torch/csrc/pairwise_accjerk.cu` (K6) and
  `potential_per_body`: `nbx_torch/csrc/potential.cu` (K3), their sources
  split as K1's.

There is no fallback from one to the other: a CUDA call launches the kernel
or raises. Each wrapper's `.launches` counts its kernel launches. The kernels
take float32 only and need softening > 0: none masks the diagonal.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from nbx_torch.forces import eps2_of
from nbx_torch.ops import _build

# The `precision` values of `pairwise_acc`, as in `nbx`. Each but "f32r"
# computes the same sum with its own formulation and rounding (the precision
# study of BASELINE config 4).
PRECISIONS = ("f32r", "f32", "fast", "hyb", "bf16", "mxu")
TILE = 256  # the card kernels' source tile, over which "fast", "hyb" and "mxu" centre
SPLIT_GRID = 512  # the blocks a split kernel's grid aims at (about 4 a Hopper SM)
TARGETS = 4  # targets a thread of K1, K1a, K1d and K1e (kTargets in their csrc/*.cu)
# Every direct sum of `pairwise_acc` splits its sources: K1 "f32r", K1a
# "f32", K1d "hyb" and K1e "bf16" (256 threads of TARGETS targets), K1b
# "fast" (a warp per 16 targets) and K1c "mxu" (a warp per 2 x 16): targets
# a block, floats a target of each split's partials.
SPLIT_KERNELS = {"f32r": (256 * TARGETS, 3), "f32": (256 * TARGETS, 4), "fast": (128, 4), "hyb": (256 * TARGETS, 3),
                 "bf16": (256 * TARGETS, 3), "mxu": (256, 3)}
# K1's symmetric sum (`pairwise_f32r_kernel_sym`): row tiles of SYM_ROWS
# bodies (kBlock in csrc/pairwise_f32r.cu), each against its diagonal and a
# balanced half-ring of column tiles, in units of TILE sources; its runs aim
# at SYM_GRID blocks (23.09 ms at 262,144, against 23.24 at 8,192 blocks and
# 25.4 at SPLIT_GRID's 512). It takes every evaluation whose targets are the
# sources from SYM_MIN_N bodies, the smallest measured size from which it
# beat the one-sided sum at every size (PERF.md, the kernel table's K1 row),
# to SYM_MAX_N, where its column slots (N^2 / (2 SYM_ROWS) x 12 bytes) reach
# 6.4 GB, 8% of an H100.
SYM_ROWS = 1024
SYM_GRID = 16384
SYM_MIN_N = 9216
SYM_MAX_N = 1 << 20
# K6 (`pairwise_acc_jerk`) splits its sources too: 256 threads of
# ACCJERK_TARGETS targets (kTargets in csrc/pairwise_accjerk.cu; 4 ran slower
# at the Hermite path's 16,384), six floats a target of each split's
# partials (acc and jerk).
ACCJERK_TARGETS = 2
ACCJERK_ROWS = 256 * ACCJERK_TARGETS
ACCJERK_WIDTH = 6
# K3 (`potential_per_body`) splits its sources too: 256 threads of
# POTENTIAL_TARGETS targets (csrc/potential.cu; 2 ran slower), one float a
# target of each split's partials.
POTENTIAL_TARGETS = 4
POTENTIAL_ROWS = 256 * POTENTIAL_TARGETS


def check_precision(precision: str) -> str:
    """`precision` if it is one of PRECISIONS; raises ValueError otherwise,
    whatever the device."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    return precision


def split_tiles(ns: int, splits: int, tile: int = TILE) -> int:
    """Tiles a split of ns sources into `splits` runs of whole tiles:
    ceil(tiles / splits), the last run holding what is left (at least one
    tile, also for ns = 0)."""
    return -(-max(1, -(-ns // tile)) // splits)


def source_splits(nt: int, ns: int, rows: int, tile: int = TILE, grid: int = SPLIT_GRID) -> int:
    """S, the source splits of a kernel with `rows` targets a block, from
    the shapes alone: runs of tiles // want whole tiles, want the fewest
    splits that put `grid` blocks in the grid, at most one a tile. So S
    >= want, every run holds a tile, and split_tiles(ns, S) gives the runs
    back. 1 wherever the target blocks alone reach `grid`."""
    tiles = max(1, -(-ns // tile))
    want = min(tiles, -(-grid // max(1, -(-nt // rows))))
    return -(-tiles // (tiles // want))


def symmetric_k1(targets_given: bool, targets_are_sources: bool, n: int) -> bool:
    """True where K1 takes its symmetric sum: the targets are the sources
    (none given, or `pos` itself) and SYM_MIN_N <= n <= SYM_MAX_N. False:
    the one-sided sum."""
    return (not targets_given or targets_are_sources) and SYM_MIN_N <= n <= SYM_MAX_N


class SymmetricPlan(NamedTuple):
    """The work of K1's symmetric sum over n bodies: `tiles` row tiles of
    `rows` bodies, `half` = tiles // 2 (the most column tiles a row tile
    takes), `units` source tiles of `tile` a row tile, each row tile's
    units spread over `runs` runs (one block each), and its scratch in
    floats: row partials [runs, n, 3] and column slots [tiles half, rows,
    3]."""

    n: int
    rows: int
    tile: int
    tiles: int
    half: int
    runs: int

    @property
    def units(self) -> int:
        return self.rows // self.tile

    @property
    def row_floats(self) -> int:
        return self.runs * self.n * 3

    @property
    def col_floats(self) -> int:
        return self.tiles * self.half * self.rows * 3

    def ring(self, a: int) -> int:
        """h(a): the column tiles (a + d) mod tiles, d = 1 ... h(a), that row
        tile a takes beside its diagonal."""
        return self.half - 1 if self.tiles % 2 == 0 and a >= self.half else self.half

    def block_units(self, a: int, r: int) -> list[tuple[int, int, int]]:
        """Block (a, r)'s units in order, (d, c, j0): tile offset d (0 the
        diagonal, one-sided), column tile c, first source j0, for units
        [r U / runs, (r + 1) U / runs) of row tile a's U; units past the last
        body left out, as the kernel skips them."""
        units = self.units * (1 + self.ring(a))
        out = []
        for u in range(r * units // self.runs, (r + 1) * units // self.runs):
            d = u // self.units
            c = (a + d) % self.tiles
            j0 = c * self.rows + (u % self.units) * self.tile
            if j0 < self.n:
                out.append((d, c, j0))
        return out

    def slot(self, a: int, d: int) -> int:
        """The column slot of row tile a's reactions on tile (a + d) mod
        tiles, d >= 1."""
        return a * self.half + d - 1

    def writers(self, c: int) -> list[tuple[int, int]]:
        """(a, d) of the row tiles whose reactions reach tile c, in the order
        the combine subtracts them: d = 1, 2, ..."""
        return [(a, d) for d in range(1, self.half + 1) if d <= self.ring(a := (c - d) % self.tiles)]


def symmetric_plan(n: int, rows: int = SYM_ROWS, tile: int = TILE, grid: int = SYM_GRID) -> SymmetricPlan:
    """K1's symmetric sum over n >= 1 bodies: the fewest runs that put `grid`
    blocks in the grid, at most one a unit of the busiest row tile."""
    tiles = -(-n // rows)
    half = tiles // 2
    return SymmetricPlan(n, rows, tile, tiles, half, min(rows // tile * (1 + half), -(-grid // tiles)))


def _f32r_rows(pos, mass, eps2, tile, splits=1):
    """K1's sum: acc_i = sum_j m_j d (|d|^2 + eps^2)^-3/2, d = p_j - p_i, in
    torch's order. `splits` is not read: nothing cancels in K1 (the self
    pair adds w 0 = 0 exactly), so the kernel's order of its runs, tiles and
    FMAs moves the sum by float32 roundings of its terms only, well inside
    KERNEL_TOL."""
    def rows(t):
        d = pos[None, :, :] - t[:, None, :]  # [B, Ns, 3]
        r2 = (d * d).sum(-1) + eps2
        inv = torch.rsqrt(r2)
        w = inv * inv * inv * mass[None, :]
        return (w[:, :, None] * d).sum(1)
    return rows


def _inv3(pos, t, eps2):
    """(|d|^2 + eps^2)^-3/2 for d = p_j - p_i, [B, Ns], r^2 summed as `nbx`
    sums it."""
    dx, dy, dz = (pos[None, :, :] - t[:, None, :]).unbind(-1)
    inv = torch.rsqrt(dx * dx + dy * dy + dz * dz + eps2)
    return inv * inv * inv


def _mass_folded(pos, mass):
    """S = [m x, m y, m z, m], [Ns, 4], as the wrapper hands it to K1a/K1b."""
    return torch.cat([pos * mass[:, None], mass[:, None]], dim=1)


def _tiles(x: torch.Tensor, tile: int) -> torch.Tensor:
    """x [Ns, ...] zero-padded to a whole number of source tiles, [T, tile,
    ...]: padding lanes sit at position 0 with mass 0, as `nbx` pads them."""
    pad = x.new_zeros((-x.shape[0] % tile, *x.shape[1:]))
    return torch.cat([x, pad]).view(-1, tile, *x.shape[1:])


def _centroids(pos: torch.Tensor, tile: int) -> torch.Tensor:
    """[T, 3]: each source tile's mean position over all its lanes, padding
    included (`jnp.mean` over `nbx`'s padded tile), on which "fast" and
    "hyb" centre. Summed as the kernels sum it, by a halving tree (lane l
    plus lane l + h, h = tile / 2, ..., 1): elementwise additions, whose
    order does not depend on the number of tiles, as a reduction's may."""
    if tile & (tile - 1):
        raise ValueError(f"the centring tile must be a power of two, got {tile}")
    x = _tiles(pos, tile)
    while x.shape[1] > 1:
        h = x.shape[1] // 2
        x = x[:, :h] + x[:, h:]
    return x[:, 0] / tile


def _block_centroids(pos: torch.Tensor, tile: int) -> torch.Tensor:
    """[T, 3]: each source tile's mean position over all its lanes, padding
    included, on which "mxu" centres. Summed in blocks of 32 lanes, each in
    lane order, then the blocks' sums in order: the order in which XLA's CPU
    backend runs `nbx`'s `jnp.mean` over a tile (a reduction split into
    windows of 32), so that the centred coordinates, and with them the bf16
    splits of a self pair's cancelling term, round as `nbx`'s do."""
    if tile % 32:
        raise ValueError(f"the centring tile must be a multiple of 32, got {tile}")
    x = _tiles(pos, tile).unflatten(1, (tile // 32, 32))  # [T, blocks, 32, 3]
    blocks = _running_sum(x[:, :, 0], x[:, :, 1:].unbind(2))  # [T, blocks, 3]
    return _running_sum(blocks[:, 0], blocks[:, 1:].unbind(1)) / tile


def _fma_odd(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a b + c rounded once to float32, as a fused multiply-add rounds it:
    the exact product in float64, the sum rounded to odd (the float64 sum
    moved one ulp towards its rounding error where that error is not 0 and
    the sum's last bit is even), then rounded to float32, which is then the
    correctly rounded result (53 >= 2 x 24 + 2 bits)."""
    p, c = a.double() * b.double(), c.double()
    s = p + c
    back = s - p
    err = (p - (s - back)) + (c - back)  # s + err = p + c exactly
    odd = (err != 0) & ((s.view(torch.int64) & 1) == 0)
    return torch.where(odd, torch.nextafter(s, torch.copysign(torch.full_like(s, torch.inf), err)), s).float()


_LOW29, _MID = (1 << 29) - 1, 1 << 28  # the float64 bits below a float32's last; a float32 midpoint's
_ABS, _MIN_NORMAL = (1 << 63) - 1, 0x3810000000000000  # |x|'s bits; FLT_MIN's as a float64


def _ties(s: torch.Tensor) -> torch.Tensor:
    """Where rounding the float64 s to float32 may round twice: s a float32
    midpoint, or a nonzero below FLT_MIN (where the midpoints lie
    elsewhere)."""
    bits = s.view(torch.int64)
    mag = bits & _ABS
    return ((bits & _LOW29) == _MID) | ((mag > 0) & (mag < _MIN_NORMAL))


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a b + c rounded once to float32, as a fused multiply-add rounds it.
    The product of two float32 values is exact in float64, so s = a b + c
    rounded to float64 and then to float32 is the fused result wherever that
    second rounding is no tie (`_ties`); those few elements are rounded to
    odd (`_fma_odd`)."""
    s = a.double() * b.double() + c.double()
    out = s.float()
    at = _ties(s).nonzero(as_tuple=True)
    if at[0].numel():
        a, b, c = torch.broadcast_tensors(a, b, c)
        out[at] = _fma_odd(a[at], b[at], c[at])
    return out


_SMALL, _RUN = 4096, 16  # elements of a small chain's acc; lanes a tie check covers there


def _fma_lanes(a: torch.Tensor, b: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """acc = fma(a[..., k, None], b[:, k], acc) for each lane k in turn (a
    [B, T, tile], b [T, tile, C], acc [B, T, C]), as a kernel's chain of
    FMAs over a tile's lanes: `_fma` step by step. On a small acc, whose
    steps cost PyTorch's dispatch more than their arithmetic (at N = 128,
    3x), the check for ties is made once for each run of _RUN lanes: a tie
    rounds wrongly only where the float64 sum s = p + c was inexact, which
    shows as s - p != c or s - c != p (the larger of p and c lies within a
    factor 2 of s, or the two sum exactly), and a run that met one is summed
    again by `_fma`. On a larger acc the stacked runs cost more memory
    traffic than they save."""
    if acc.numel() > _SMALL:
        for k in range(a.shape[-1]):
            acc = _fma(a[..., k, None], b[:, k], acc)
        return acc
    a64, b64 = a.double().movedim(-1, 0)[..., None], b.double().movedim(1, 0)  # lane-major
    for k0 in range(0, a.shape[-1], _RUN):
        lanes = range(k0, min(k0 + _RUN, a.shape[-1]))
        start, c64, steps = acc, acc.double(), []
        for k in lanes:
            p = a64[k] * b64[k]
            s = p + c64
            acc = s.float()
            steps.append((p, c64, s))
            c64 = acc.double()
        p, c, s = (torch.stack(x) for x in zip(*steps))
        if (_ties(s) & ((s - p != c) | (s - c != p) | (s.abs() < 2.0**-126))).any():
            acc = start
            for k in lanes:
                acc = _fma(a[..., k, None], b[:, k], acc)
    return acc


def _running_sum(zero: torch.Tensor, terms) -> torch.Tensor:
    """zero + terms[0] + terms[1] + ..., one addition after another in
    float32: the order of the kernels' loops over a tile's lanes and over
    the tiles. A variant with a cancellation amplifies any other order's
    roundings by |p| / |d|."""
    total = zero
    for x in terms:
        total = total + x
    return total


def _split_sum(parts: torch.Tensor, splits: int) -> torch.Tensor:
    """[B, C]: the tiles' terms parts [B, T, C] summed as the split kernels
    sum them: each split's run of split_tiles(...) tiles in turn, from zero,
    then the splits' sums in turn (`combine_splits` in
    csrc/split_sum.cuh). One split sums the tiles in turn."""
    per = max(1, -(-parts.shape[1] // splits))
    zero = parts.new_zeros((parts.shape[0], parts.shape[2]))
    sums = [_running_sum(zero, parts[:, s0 : s0 + per].unbind(1)) for s0 in range(0, parts.shape[1], per)] or [zero]
    return _running_sum(sums[0], sums[1:])


def _f32_rows(pos, mass, eps2, tile, splits=1):
    """"f32" (K1a): o = sum_j f_ij S_j with f = (|d|^2 + eps^2)^-3/2 and S
    mass-folded, then the cancellation o_xyz - p_i o_m over the whole source
    range (`nbx/ops/pairwise.py:84-90`). Rounded and summed as the kernel
    rounds and sums: r^2 = fma(dz, dz, fma(dy, dy, fma(dx, dx, eps^2))), each
    tile's lanes in turn into o = fma(f, S_j, o), then the tiles as `splits`
    runs (`_split_sum`)."""
    p, s = _tiles(pos, tile), _tiles(_mass_folded(pos, mass), tile)  # [T, tile, 3], [T, tile, 4]
    e2 = pos.new_tensor(eps2)

    def rows(t):
        dx, dy, dz = (p.flatten(0, 1)[None] - t[:, None]).unbind(-1)  # [B, T tile]
        inv = torch.rsqrt(_fma(dz, dz, _fma(dy, dy, _fma(dx, dx, e2))))
        f = (inv * inv * inv).unflatten(1, p.shape[:2])  # [B, T, tile]
        part = _fma_lanes(f, s, f.new_zeros((t.shape[0], p.shape[0], 4)))  # [B, T, 4]
        o = _split_sum(part, splits)
        return o[:, :3] - t * o[:, 3:]
    return rows


def _bf16_split(v):
    """(hi, lo) of v as float32 values: hi = bf16(v), lo = bf16(v - hi)."""
    hi = v.bfloat16().float()
    return hi, (v - hi).bfloat16().float()


def _fast_rows(pos, mass, eps2, tile, splits=1):
    """"fast" (K1b): K1a's sum per source tile, the tile centred on its
    centroid c (s_c = S - [c m, 0]), the product in three bf16 passes with
    float32 sums (f_hi s_hi + f_hi s_lo + f_lo s_hi, each product exact in
    float32, each pass summed over the tile's lanes in turn), c sum_j f m
    added back per tile, then K1a's cancellation
    (`nbx/ops/pairwise.py:130-165`). The tiles add as `splits` runs
    (`_split_sum`). The kernel sums each 16-source chunk of a pass on the
    tensor cores, in an order of their own."""
    p, m, c = _tiles(pos, tile), _tiles(mass, tile), _centroids(pos, tile)
    s = _tiles(_mass_folded(pos, mass), tile)
    s_hi, s_lo = _bf16_split(torch.cat([s[..., :3] - c[:, None, :] * m[..., None], s[..., 3:]], dim=2))  # [T, tile, 4]

    def rows(t):
        f_hi, f_lo = _bf16_split(_inv3(p.flatten(0, 1), t, eps2).unflatten(1, p.shape[:2]))  # [B, T, tile]
        zero = f_hi.new_zeros((t.shape[0], p.shape[0], 4))

        def one_pass(f, s):
            return _running_sum(zero, (f[..., k, None] * s[:, k] for k in range(tile)))
        tmp = one_pass(f_hi, s_hi) + one_pass(f_hi, s_lo) + one_pass(f_lo, s_hi)  # [B, T, 4]
        w = tmp[..., 3:]
        o = _split_sum(torch.cat([tmp[..., :3] + c * w, w], dim=2), splits)
        return o[:, :3] - t * o[:, 3:]
    return rows


def _hyb_rows(pos, mass, eps2, tile, splits=1):
    """"hyb" (K1d): per source tile, r^2 by the centred identity
    (|p_i - c|^2 + |p_j - c|^2) - 2 (p_i - c).(p_j - c) in float32, floored
    at eps^2; w = m / r^3; the centred sums s = sum_j w (p_j - c) and
    sum_j w, un-centred per tile as s - (p_i - c) sum_j w
    (`nbx/ops/pairwise.py:347-393`). Rounded as the kernel rounds: the
    squares fma(z, z, fma(x, x, y y)) and the cross term
    fma(z, z', fma(y, y', x x')), as in "mxu" (and as XLA's CPU backend
    contracts `nbx`'s), the centred sums s = fma(w, p_j - c, s) lane after
    lane; the tiles add as `splits` runs (`_split_sum`)."""
    m, c = _tiles(mass, tile), _centroids(pos, tile)
    pc = _tiles(pos, tile) - c[:, None, :]  # [T, tile, 3]
    xjc, yjc, zjc = pc.unbind(-1)
    tj2e = _fma(zjc, zjc, _fma(xjc, xjc, yjc * yjc)) + eps2

    def rows(t):
        pic = t[:, None, :] - c[None]  # [B, T, 3]
        xic, yic, zic = (v[..., None] for v in pic.unbind(-1))  # [B, T, 1]
        cross = _fma(zic, zjc, _fma(yic, yjc, xic * xjc))  # [B, T, tile]
        ti2 = _fma(zic, zic, _fma(xic, xic, yic * yic))
        inv = torch.rsqrt(torch.clamp_min((ti2 + tj2e) - 2.0 * cross, eps2))
        w = inv * inv * inv * m
        s = _fma_lanes(w, pc, pic.new_zeros(pic.shape))
        sw = _running_sum(w.new_zeros(w.shape[:2]), w.unbind(2))[..., None]
        return _split_sum(s - pic * sw, splits)
    return rows


def _bf16_rows(pos, mass, eps2, tile, splits=1):
    """"bf16" (K1e): d rounded to bf16; each d d, f^3 m and w d a bf16
    product; r^2 and the row sums in float32 (`nbx/ops/pairwise.py:422-437`).
    `splits` is not read: nothing here cancels, so the sums run in torch's
    order, and the kernel's order of its lanes, tiles and runs moves them by
    float32 roundings of their terms only, well inside its 1e-5 bar."""
    m = mass.bfloat16()

    def rows(t):
        d = (pos[None, :, :] - t[:, None, :]).bfloat16()  # [B, Ns, 3]
        dx, dy, dz = d.unbind(-1)
        r2 = (dx * dx).float() + (dy * dy).float() + (dz * dz).float() + eps2
        inv = torch.rsqrt(r2)
        w = (inv * inv * inv).bfloat16() * m[None, :]
        return (w[:, :, None] * d).float().sum(1)
    return rows


def _mxu_rows(pos, mass, eps2, tile, splits=1):
    """"mxu" (K1c): per source tile, r^2 = ((|p_i - c|^2 + |p_j - c|^2) -
    2 (p_i - c).(p_j - c)) + eps^2 in float32, floored at eps^2 (not "hyb"'s
    grouping); w = m / r^3; then the accumulation over P_c = (p_j - c, 1) as
    three bf16 products with float32 sums, (w_hi P_hi + w_hi P_lo) + w_lo
    P_hi, each summed over the tile's lanes in turn, un-centred per tile as
    tmp_xyz - (p_i - c) tmp_w (`nbx/ops/pairwise.py:231-296`), the tiles
    added as `splits` runs (`_split_sum`). c is the block-summed centroid;
    the squares are fma(z, z, fma(x, x, y y)) and the cross term fma(z, z',
    fma(y, y', x x')), as XLA's CPU backend contracts `nbx`'s sums and its
    float32 dot. A self pair's term cancels in the
    un-centring, and its bf16 splits follow the last bits of w_ii and of the
    centroid, so those roundings decide how close the two come. The kernel
    rounds them alike and sums its products on the tensor cores, in an
    order of their own."""
    m, c = _tiles(mass, tile), _block_centroids(pos, tile)
    pc = _tiles(pos, tile) - c[:, None, :]  # [T, tile, 3]
    xjc, yjc, zjc = pc.unbind(-1)
    tj2 = _fma(zjc, zjc, _fma(xjc, xjc, yjc * yjc))
    p_hi, p_lo = _bf16_split(torch.cat([pc, torch.ones_like(m)[..., None]], dim=2))  # [T, tile, 4]

    def rows(t):
        pic = t[:, None, :] - c[None]  # [B, T, 3]
        xic, yic, zic = (v[..., None] for v in pic.unbind(-1))  # [B, T, 1]
        cross = _fma(zic, zjc, _fma(yic, yjc, xic * xjc))  # [B, T, tile]
        ti2 = _fma(zic, zic, _fma(xic, xic, yic * yic))
        inv = torch.rsqrt(torch.clamp_min(((ti2 + tj2) - 2.0 * cross) + eps2, eps2))
        w_hi, w_lo = _bf16_split(inv * inv * inv * m)
        zero = w_hi.new_zeros((t.shape[0], c.shape[0], 4))

        def one_pass(w, p):
            return _running_sum(zero, (w[..., k, None] * p[:, k] for k in range(tile)))
        tmp = (one_pass(w_hi, p_hi) + one_pass(w_hi, p_lo)) + one_pass(w_lo, p_hi)  # [B, T, 4]
        return _split_sum(tmp[..., :3] - pic * tmp[..., 3:], splits)
    return rows


_ROWS = {"f32r": _f32r_rows, "f32": _f32_rows, "fast": _fast_rows, "hyb": _hyb_rows, "bf16": _bf16_rows,
         "mxu": _mxu_rows}


def pairwise_acc_reference(
    pos: torch.Tensor,
    mass: torch.Tensor,
    G: float,
    softening: float,
    target_pos: torch.Tensor | None = None,
    block: int = 1024,
    precision: str = "f32r",
    tile: int = TILE,
    splits: int | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel of `precision`, in blocks of
    `block` targets: acc_i = G sum_j m_j d (|d|^2 + eps^2)^-3/2, d = p_j - p_i,
    no diagonal mask (the self pair contributes 0 for eps > 0), each
    precision with its own formulation and rounding points (the `*_rows`
    functions above). `tile` is the width of the source tile of "f32",
    "fast", "hyb" and "mxu": their sums run tile by tile, and "fast", "hyb"
    and "mxu" centre on each tile's centroid. Its default is the card kernels' 256;
    `nbx`'s tile_j compares with `nbx`. "f32r" and "bf16" do not read it.
    `splits` is the number of runs of tiles in which "f32", "fast", "hyb"
    and "mxu" add their tiles (each cancels, so the order of its sums shows);
    by default their kernels' (`source_splits` of the shapes). "f32r" and
    "bf16" sum in torch's order whatever it is."""
    check_precision(precision)
    if target_pos is None:
        target_pos = pos
    if splits is None:
        splits = source_splits(target_pos.shape[0], pos.shape[0], SPLIT_KERNELS[precision][0], tile)
    rows = _ROWS[precision](pos, mass, eps2_of(softening), tile, splits)
    out = [rows(target_pos[i0 : i0 + block]) for i0 in range(0, target_pos.shape[0], block)]
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


def _entry(kernel: str, name: str, argtypes: list):
    fn = getattr(_build.load(kernel), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _launch(kernel: str, argtypes: list, device: torch.device, *args, entry: str | None = None) -> None:
    """Launch csrc/<kernel>.cu's entry (nbx_<kernel> unless named) on the
    device's current stream; raise on a refused launch."""
    entry = entry or f"nbx_{kernel}"
    with torch.cuda.device(device):
        err = _entry(kernel, entry, argtypes)(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: cudaError_t {err}")


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _direct_sum(wrapper, entry: str, pos, mass, G: float, softening: float, target_pos, kernel: str,
                extras, split: tuple[int, int]) -> torch.Tensor:
    """A direct-sum wrapper's launch on CUDA tensors: check the inputs, pack
    the sources as float4 (x, y, z, m), launch csrc/<kernel>.cu's `entry` on
    (targets, sources, *extras(), partials, acc, Nt, Ns, G, eps^2, tiles a
    split) and count it on `wrapper.launches`. `extras` builds the further
    inputs (contiguous float32 tensors) once the inputs passed; `split` =
    (targets a block, floats a target of the partials [S, Nt, width])."""
    ns, nt = pos.shape[0], target_pos.shape[0]
    _check("pos", pos, (ns, 3), pos.device)
    _check("mass", mass, (ns,), pos.device)
    _check("target_pos", target_pos, (nt, 3), pos.device)
    src = torch.cat([pos, mass[:, None]], dim=1)  # [Ns, 4] float4 (x, y, z, m)
    tgt = target_pos.contiguous()
    more = extras()
    acc = torch.empty((nt, 3), dtype=torch.float32, device=pos.device)
    if nt == 0:
        return acc
    rows, width = split
    splits = source_splits(nt, ns, rows)
    more += (torch.empty((splits, nt, width), dtype=torch.float32, device=pos.device),)
    _launch(kernel, [_P] * (3 + len(more)) + [_I, _I, _F, _F, _I, _P], pos.device,
            tgt.data_ptr(), src.data_ptr(), *(x.data_ptr() for x in more), acc.data_ptr(),
            nt, ns, float(G), eps2_of(softening), split_tiles(ns, splits), entry=entry)
    wrapper.launches += 1
    return acc


def pairwise_acc(
    pos: torch.Tensor,
    mass: torch.Tensor,
    G: float,
    softening: float,
    target_pos: torch.Tensor | None = None,
    precision: str = "f32r",
) -> torch.Tensor:
    """Softened gravitational acceleration of all sources on the targets.

    pos [Ns, 3], mass [Ns] -> acc at target_pos [Nt, 3] (targets default to
    the sources), float32. G and softening are Python floats; softening must
    be > 0, since the self pair is defined only then. `precision` picks the
    formulation, as in `nbx`: "f32r" (K1, direct float32 row sums, the most
    accurate), or the study variants "f32", "fast", "hyb", "bf16" and "mxu",
    each its own kernel (`pairwise_acc_f32` ...). Any other value raises
    ValueError.

    On the card "f32r" evaluates each unordered pair once for both bodies
    where the targets are the sources and SYM_MIN_N <= N <= SYM_MAX_N
    (`symmetric_k1`), and every ordered pair otherwise. `.launches` counts every K1
    evaluation, `.symmetric_launches` those of the symmetric sum."""
    if check_precision(precision) != "f32r":
        return _VARIANTS[precision](pos, mass, G, softening, target_pos)
    symmetric = symmetric_k1(target_pos is not None, target_pos is pos, pos.shape[0])
    if target_pos is None:
        target_pos = pos
    if not _on_card("pairwise_acc", pos, softening):
        return pairwise_acc_reference(pos, mass, G, softening, target_pos)
    if symmetric:
        acc = pairwise_acc_symmetric(pos, mass, G, softening)
        pairwise_acc.launches += 1
        return acc
    return _direct_sum(pairwise_acc, "nbx_pairwise_f32r", pos, mass, G, softening, target_pos, "pairwise_f32r",
                       tuple, SPLIT_KERNELS["f32r"])


pairwise_acc.launches = 0
pairwise_acc.symmetric_launches = 0


def pairwise_acc_symmetric(pos: torch.Tensor, mass: torch.Tensor, G: float, softening: float) -> torch.Tensor:
    """K1's symmetric sum on CUDA tensors, the targets being the sources,
    whatever N: each unordered pair evaluated once and added to both bodies
    (`nbx_pairwise_f32r_sym`), a block's own rows one-sided; row partials
    and column slots from `symmetric_plan`, added by `combine_splits_sym`.
    Counted on `pairwise_acc.symmetric_launches`; `pairwise_acc` counts the
    evaluation."""
    n = pos.shape[0]
    _check("pos", pos, (n, 3), pos.device)
    _check("mass", mass, (n,), pos.device)
    if pos.device.type != "cuda" or not softening > 0:
        raise ValueError("pairwise_acc_symmetric runs on CUDA tensors with softening > 0")
    acc = torch.empty((n, 3), dtype=torch.float32, device=pos.device)
    if n == 0:
        return acc
    plan = symmetric_plan(n)
    src = torch.cat([pos, mass[:, None]], dim=1)  # [N, 4] float4 (x, y, z, m)
    rows = torch.empty(plan.row_floats, dtype=torch.float32, device=pos.device)
    cols = torch.empty(plan.col_floats, dtype=torch.float32, device=pos.device)
    _launch("pairwise_f32r", [_P] * 4 + [_I, _F, _F, _I, _P], pos.device, src.data_ptr(), rows.data_ptr(),
            cols.data_ptr(), acc.data_ptr(), n, float(G), eps2_of(softening), plan.runs,
            entry="nbx_pairwise_f32r_sym")
    pairwise_acc.symmetric_launches += 1
    return acc


# Each study precision's kernel: its source csrc/<source>.cu, and whether
# its entry nbx_pairwise_<precision> takes the mass-folded S after the
# sources. "mxu"'s S is the raw coordinates, which the sources hold, "hyb"
# centres them itself and "bf16" folds nothing, so their entries take none.
# Each then takes its partials (SPLIT_KERNELS).
VARIANT_KERNEL = {"f32": ("pairwise_precision", True), "fast": ("pairwise_fast", True),
                  "hyb": ("pairwise_precision", False), "bf16": ("pairwise_precision", False),
                  "mxu": ("pairwise_mxu", False)}


def _precision_wrapper(precision: str):
    """The wrapper of one study precision's kernel (VARIANT_KERNEL), with its
    own `.launches`."""
    kernel, folded = VARIANT_KERNEL[precision]

    def wrapper(pos: torch.Tensor, mass: torch.Tensor, G: float, softening: float,
                target_pos: torch.Tensor | None = None) -> torch.Tensor:
        if target_pos is None:
            target_pos = pos
        if not _on_card(wrapper.__name__, pos, softening):
            return pairwise_acc_reference(pos, mass, G, softening, target_pos, precision=precision)
        return _direct_sum(wrapper, f"nbx_pairwise_{precision}", pos, mass, G, softening, target_pos, kernel,
                           lambda: (_mass_folded(pos, mass),) if folded else (),
                           SPLIT_KERNELS[precision])

    wrapper.__name__ = wrapper.__qualname__ = f"pairwise_acc_{precision}"
    wrapper.__doc__ = (f"`pairwise_acc(..., precision={precision!r})`: the kernel nbx_pairwise_{precision} "
                       "on a CUDA tensor, the plain version on a CPU one.")
    wrapper.launches = 0
    return wrapper


pairwise_acc_f32 = _precision_wrapper("f32")  # K1a
pairwise_acc_fast = _precision_wrapper("fast")  # K1b
pairwise_acc_hyb = _precision_wrapper("hyb")  # K1d
pairwise_acc_bf16 = _precision_wrapper("bf16")  # K1e
pairwise_acc_mxu = _precision_wrapper("mxu")  # K1c
_VARIANTS = {"f32": pairwise_acc_f32, "fast": pairwise_acc_fast, "hyb": pairwise_acc_hyb,
             "bf16": pairwise_acc_bf16, "mxu": pairwise_acc_mxu}


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
    eps > 0). In torch's order, whatever the kernel's source split: nothing
    cancels in K6, so the kernel's order of its runs, tiles and FMAs moves
    the sums by float32 roundings of their terms only (as `_f32r_rows`)."""
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
    float32. softening must be > 0. On the card K6 splits the sources into
    source_splits(Nt, Ns, ACCJERK_ROWS) runs and adds their partials in
    order, in a second launch."""
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
    splits = source_splits(nt, ns, ACCJERK_ROWS)
    part = torch.empty((splits, nt, ACCJERK_WIDTH), dtype=torch.float32, device=dev)
    _launch("pairwise_accjerk", [_P] * 6 + [_I, _I, _F, _F, _I, _P], dev,
            tp.data_ptr(), tv.data_ptr(), src.data_ptr(), part.data_ptr(), acc.data_ptr(), jerk.data_ptr(), nt, ns,
            float(G), eps2_of(softening), split_tiles(ns, splits))
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
    included, then the self term removed as the wrapper removes it. In
    torch's order, whatever the kernel's source split: nothing cancels in
    K3's sum (as `_f32r_rows`)."""
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
    > 0. On the card K3 splits the sources into source_splits(Nt, Ns,
    POTENTIAL_ROWS) runs and adds their partials in order, times -G, in a
    second launch."""
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
    splits = source_splits(nt, ns, POTENTIAL_ROWS)
    part = torch.empty((splits, nt), dtype=torch.float32, device=dev)
    _launch("potential", [_P] * 4 + [_I, _I, _F, _F, _I, _I, _P], dev,
            tgt.data_ptr(), src.data_ptr(), part.data_ptr(), phi.data_ptr(), nt, ns, float(G), eps2_of(softening),
            POTENTIAL_ROWS, split_tiles(ns, splits))
    potential_per_body.launches += 1
    return _remove_self_term(phi, G, softening, target_mass)


potential_per_body.launches = 0


def potential_energy(pos: torch.Tensor, mass: torch.Tensor, G: float, softening: float) -> torch.Tensor:
    """Total softened potential energy 0.5 sum_i m_i phi_i through
    `potential_per_body` (K3 on the card)."""
    return 0.5 * (mass * potential_per_body(pos, mass, G, softening)).sum()
