"""K1's symmetric sum (`pairwise_f32r_kernel_sym` in
nbx_torch/csrc/pairwise_f32r.cu) on the CPU: the dispatch rule
`symmetric_k1`, and the planner `symmetric_plan` that mirrors the kernel's
schedule and sizes its scratch. Every unordered pair of row tiles meets
once, the blocks' work differs by at most one row tile's units, the
combine's slots are the scratch's and each has one writer; and the sum
taken unit by unit as the plan lays it out (row partials in run order, the
column slots subtracted in the combine's order) equals the plain direct sum
in float64. The kernel itself runs only on the card
(`tests/test_torch_cuda.py`).
"""

import collections

import pytest
import torch

from nbx_torch.ops import pairwise

torch.set_num_threads(1)


@pytest.mark.parametrize("given,same,n,want", [
    (False, False, pairwise.SYM_MIN_N, True),
    (False, False, pairwise.SYM_MAX_N, True),
    (True, True, 262_144, True),
    (True, False, 262_144, False),  # the shard step's local targets, P3M's subsets
    (False, False, pairwise.SYM_MIN_N - 1, False),
    (True, True, pairwise.SYM_MIN_N - 1, False),
    (False, False, pairwise.SYM_MAX_N + 1, False),
])
def test_symmetric_k1_dispatch(given, same, n, want):
    assert pairwise.symmetric_k1(given, same, n) is want


# (n, rows, tile, grid): the kernel's shapes (2,304 and 3,001: three tiles, the
# last ragged; 4,096 and 16,384 even; SHORT_LAST_SPLIT_N; 262,144), and small
# row tiles whose plans hold many tiles: odd, even, one, two, ragged
G = pairwise.SYM_GRID
PLANS = [(2304, 1024, 256, G), (3001, 1024, 256, G), (4096, 1024, 256, G), (16384, 1024, 256, G),
         (20000, 1024, 256, G), (262144, 1024, 256, G), (300, 64, 16, 16), (290, 64, 16, 16),
         (256, 64, 16, 40), (100, 64, 16, 4), (50, 64, 16, 4), (1000, 32, 8, 7)]


def _plan(n, rows, tile, grid):
    return pairwise.symmetric_plan(n, rows, tile, grid)


def _blocks(plan):
    return {(a, r): plan.block_units(a, r) for a in range(plan.tiles) for r in range(plan.runs)}


@pytest.mark.parametrize("n,rows,tile,grid", [p for p in PLANS if p[0] <= 20000])
def test_plan_meets_every_unordered_tile_pair_once(n, rows, tile, grid):
    """Every ordered pair of source units (u's bodies pulled by v's) is met
    once: by the row side of a unit (u in row tile a, v the unit), or by its
    reactions (u the unit, v in row tile a). Each unordered pair of row
    tiles is taken by one of its two row tiles alone."""
    plan = _plan(n, rows, tile, grid)
    met, sides = collections.Counter(), collections.defaultdict(set)
    for (a, _), units in _blocks(plan).items():
        for d, c, j0 in units:
            assert c == (a + d) % plan.tiles and j0 < n
            for u in range(a * rows, min(n, (a + 1) * rows), tile):
                met[(u, j0)] += 1
                if d:
                    met[(j0, u)] += 1
            if d:
                sides[frozenset((a, c))].add(a)
    every = range(0, n, tile)
    assert sorted(met) == sorted((u, v) for u in every for v in every) and set(met.values()) == {1}
    assert set(sides) == {frozenset((a, c)) for a in range(plan.tiles) for c in range(a)}
    assert all(len(side) == 1 for side in sides.values())


@pytest.mark.parametrize("n,rows,tile,grid", PLANS)
def test_plan_blocks_are_equal_within_one_tile(n, rows, tile, grid):
    """Row tiles differ by at most one column tile's units, and a row tile's
    runs by at most one unit, so every block's work lies within one unit of
    its run's share; the grid reaches `grid` blocks where the units allow."""
    plan = _plan(n, rows, tile, grid)
    units = [plan.units * (1 + plan.ring(a)) for a in range(plan.tiles)]
    assert max(units) - min(units) <= plan.units
    for a in range(plan.tiles):
        runs = [len(range(r * units[a] // plan.runs, (r + 1) * units[a] // plan.runs)) for r in range(plan.runs)]
        assert sum(runs) == units[a] and max(runs) - min(runs) <= 1
    assert plan.tiles * plan.runs >= grid or plan.runs == max(units)


@pytest.mark.parametrize("n,rows,tile,grid", PLANS)
def test_plan_combine_slots_are_the_scratch(n, rows, tile, grid):
    plan = _plan(n, rows, tile, grid)
    written = collections.Counter()
    for (a, _), units in _blocks(plan).items():
        for d, c, j0 in units:
            if d:
                written[(plan.slot(a, d), j0 % rows)] += 1
    read = [(plan.slot(a, d), u * tile) for c in range(plan.tiles) for a, d in plan.writers(c)
            for u in range(rows // tile) if c * rows + u * tile < n]
    assert all(k == 1 for k in written.values()) and sorted(read) == sorted(written)
    for c in range(plan.tiles):
        ds = [d for _, d in plan.writers(c)]
        assert ds == sorted(ds) and all((a + d) % plan.tiles == c for a, d in plan.writers(c))
    slots = {s for s, _ in read}
    assert all(0 <= s < plan.tiles * plan.half for s in slots)
    unused = plan.tiles * plan.half - len(slots)
    assert unused == (plan.tiles - plan.half if plan.tiles % 2 == 0 and plan.tiles > 1 else 0)
    assert plan.col_floats == plan.tiles * plan.half * rows * 3 and plan.row_floats == plan.runs * n * 3


@pytest.mark.parametrize("n,rows,tile,grid", [p for p in PLANS if p[1] < 1024])
def test_plan_sum_equals_the_direct_sum(n, rows, tile, grid):
    """The kernel's arithmetic laid out by the plan, in float64: each block's
    rows against its units (the diagonal one-sided, the rest giving the rows
    m_j w d and the sources' reactions m_i w d), the row partials added in
    run order, then each body's column slots subtracted in the combine's
    order, times G."""
    plan = _plan(n, rows, tile, grid)
    gen = torch.Generator().manual_seed(n)
    pos = torch.randn((n, 3), generator=gen, dtype=torch.float64) * 20
    mass = torch.rand(n, generator=gen, dtype=torch.float64) * 4.5 + 0.5
    mass[n // 3] = 0.0  # a massless body: pulled, pulls nothing
    G, eps2 = 0.5, 0.25
    part = torch.zeros((plan.runs, n, 3), dtype=torch.float64)
    cols = torch.full((plan.tiles * plan.half, rows, 3), float("nan"), dtype=torch.float64)
    for (a, r), units in _blocks(plan).items():
        i = torch.arange(a * rows, min(n, (a + 1) * rows))
        for d, c, j0 in units:
            j = torch.arange(j0, min(n, j0 + tile))
            dp = pos[j][None] - pos[i][:, None]  # [rows, tile, 3]
            w = ((dp * dp).sum(-1) + eps2) ** -1.5
            part[r, i] += ((w * mass[j][None])[..., None] * dp).sum(1)
            if d:
                cols[plan.slot(a, d), j - c * rows] = ((w * mass[i][:, None])[..., None] * dp).sum(0)
    acc = part[0]
    for r in range(1, plan.runs):
        acc = acc + part[r]
    for c in range(plan.tiles):
        tile_c = slice(c * rows, min(n, (c + 1) * rows))
        for a, d in plan.writers(c):
            acc[tile_c] -= cols[plan.slot(a, d), : tile_c.stop - tile_c.start]
    want = pairwise.pairwise_acc_reference(pos, mass, 1.0, eps2**0.5)
    assert torch.allclose(acc * G, want * G, rtol=0, atol=1e-12 * float(want.abs().max()))
