"""The source split of the direct sums K1 "f32r", K1a "f32", K1b "fast",
K1c "mxu", K1d "hyb" and K1e "bf16": the split helper `source_splits`, and
the plain versions that add their tiles as the split kernels do, against
`nbx` on the CPU.

A split kernel sums its targets against runs of whole source tiles, one run
a block, and a second pass adds the runs' partials in order. The plain
versions of the cancelling variants (`_f32_rows`, `_fast_rows`,
`_hyb_rows`, `_mxu_rows`) take `splits=` and add each run's tiles in turn,
then the runs in turn; with one run that is the sum of the tiles in turn.
Against `nbx` (its Pallas kernels in interpret mode at tile_i=8,
tile_j=128, compiled with `xla_allow_excess_precision` off, as
`tests/test_torch_pairwise_precision.py` runs them) the bars are that
file's: 2e-3 of max|nbx| for the four ("f32", "fast", "hyb" and "mxu"
cancel a self pair's term, and the two sides sum in other orders; measured
there at most 1.21e-3, 1.30e-3, 1.71e-3 and 6.90e-4), and 1e-4 for "mxu"
where no target is a source. Splitting moves only the order of the tiles'
float32 additions. The plain versions of "f32r" and "bf16" sum in torch's
order whatever the split (nothing cancels in K1 or K1e, so the kernel's
order moves them by roundings of their terms only): against `nbx` they keep
the 1e-5 bars of `tests/test_torch_pairwise.py` and
`tests/test_torch_pairwise_precision.py`.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbx.ops import pairwise as jpairwise
from nbx_torch.ops import pairwise

torch.set_num_threads(1)

NBX_BAR = {"f32r": 1e-5, "f32": 2e-3, "fast": 2e-3, "hyb": 2e-3, "bf16": 1e-5, "mxu": 2e-3}  # as in
# test_torch_pairwise{,_precision}.py
MXU_SEPARATE_BAR = 1e-4  # "mxu" against nbx where no target is a source (test_torch_pairwise_precision.py)
CANCELLING = ("f32", "fast", "hyb", "mxu")  # the split kernels whose plain versions follow the runs
NO_EXCESS = {"xla_allow_excess_precision": False}
TILE = 128  # nbx's tile_j, over which both centre
CASES = ["300", "777", "rect"]  # 3, 7 and 3 source tiles; "apart": 7, no target a source


def _rand(n, seed=0):
    rng = np.random.default_rng(seed)
    pos = (rng.normal(size=(n, 3)) * 20).astype(np.float32)
    mass = rng.uniform(0.5, 5, n).astype(np.float32)
    return pos, mass


def _case(case):
    """(pos, mass, targets or None): n bodies, 100 targets among 300, or
    100 targets apart from 777 sources."""
    if case == "rect":
        pos, mass = _rand(300, 1)
        return pos, mass, np.ascontiguousarray(pos[37:137])
    if case == "apart":
        return (*_rand(777, 21), _rand(100, 22)[0])
    return (*_rand(int(case), int(case)), None)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


@functools.cache
def _nbx(precision, case):
    pos, mass, tgt = _case(case)
    args = (jnp.asarray(pos), jnp.asarray(mass), 0.5, 0.5, None if tgt is None else jnp.asarray(tgt))
    run = jpairwise.pairwise_acc.lower(*args, tile_i=8, tile_j=TILE, precision=precision, interpret=True)
    return np.asarray(run.compile(NO_EXCESS)(*args))


def _plain(precision, case, splits, tile=TILE):
    pos, mass, tgt = (None if x is None else torch.from_numpy(x) for x in _case(case))
    return pairwise.pairwise_acc_reference(pos, mass, 0.5, 0.5, tgt, precision=precision, tile=tile, splits=splits)


def _splits(rows_128, rows_256, rows_1024):
    """S of each split kernel: "fast" (128 targets a block), "mxu" (256),
    and "f32r", "f32", "hyb" and "bf16" (1,024)."""
    return {"f32r": rows_1024, "f32": rows_1024, "fast": rows_128, "hyb": rows_1024, "bf16": rows_1024,
            "mxu": rows_256}


# (nt, ns) -> S of each split kernel; (262,144, 1,048,576) is the 1M
# all-gather step's shard at D = 4
SPLIT_SHAPES = {(16_384, 16_384): _splits(4, 8, 32), (262_144, 262_144): _splits(1, 1, 2),
                (1_048_576, 1_048_576): _splits(1, 1, 1), (4_096, 4_096): _splits(16, 16, 16),
                (1_000, 4_096): _splits(16, 16, 16), (777, 3_001): _splits(12, 12, 12),
                (100, 255): _splits(1, 1, 1), (5, 0): _splits(1, 1, 1), (25_600, 1_792): _splits(4, 7, 7),
                (204_800, 1_792): _splits(1, 1, 4), (262_144, 1_048_576): _splits(1, 1, 2)}


@pytest.mark.parametrize("nt,ns", list(SPLIT_SHAPES))
def test_source_splits_cover_whole_tiles(nt, ns):
    """S from the shapes alone: at least one split, at most one a tile,
    every split a run of whole tiles that holds at least one (the last run
    of (25,600, 1,792) and (204,800, 1,792) one tile to the others' two),
    and the grid at SPLIT_GRID blocks or more where the tiles allow it."""
    tiles = max(1, -(-ns // pairwise.TILE))
    assert set(SPLIT_SHAPES[nt, ns]) == set(pairwise.SPLIT_KERNELS)
    for precision, want in SPLIT_SHAPES[nt, ns].items():
        rows = pairwise.SPLIT_KERNELS[precision][0]
        s = pairwise.source_splits(nt, ns, rows)
        per = pairwise.split_tiles(ns, s)
        assert s == want and 1 <= s <= tiles, (precision, s)
        assert (s - 1) * per < tiles <= s * per  # whole tiles, the last run not empty
        blocks = -(-nt // rows)
        assert s == 1 if blocks >= pairwise.SPLIT_GRID else blocks * s >= pairwise.SPLIT_GRID or s == tiles


def test_drift_gate_grid_is_four_times_wider():
    """At the drift gate's 16,384 bodies every split kernel splits, and its
    grid holds at least 4x the 64 blocks of one thread a target."""
    for precision in pairwise.SPLIT_KERNELS:
        rows = pairwise.SPLIT_KERNELS[precision][0]
        s = pairwise.source_splits(16_384, 16_384, rows)
        assert s > 1 and -(-16_384 // rows) * s >= 4 * 64


def _tiles_in_turn(parts, splits):
    """The unsplit sum: every tile's terms added in turn from zero."""
    return pairwise._running_sum(parts.new_zeros((parts.shape[0], parts.shape[2])), parts.unbind(1))


@pytest.mark.parametrize("precision", CANCELLING)
@pytest.mark.parametrize("case", CASES)
def test_one_split_is_the_sum_of_the_tiles_in_turn(precision, case, monkeypatch):
    """splits=1 is bitwise the plain version that adds its tiles in turn,
    at the card's tile."""
    got = _plain(precision, case, 1, pairwise.TILE)
    monkeypatch.setattr(pairwise, "_split_sum", _tiles_in_turn)
    assert torch.equal(got, _plain(precision, case, 1, pairwise.TILE))


@pytest.mark.parametrize("precision", CANCELLING)
@pytest.mark.parametrize("splits", [2, 3, None])
@pytest.mark.parametrize("case", CASES)
def test_split_plain_version_matches_nbx(precision, splits, case):
    """Two runs, three (7 tiles: 3, 3, 1) and the kernels' own S."""
    assert _rel(_plain(precision, case, splits).numpy(), _nbx(precision, case)) < NBX_BAR[precision]


def _in_torch_order(precision, case):
    """`precision` at the kernels' S (and at 1 and 3, bitwise the same: its
    plain version sums in torch's order) against `nbx`."""
    got = _plain(precision, case, None)
    assert all(torch.equal(got, _plain(precision, case, s)) for s in (1, 3))
    return _rel(got.numpy(), _nbx(precision, case))


@pytest.mark.parametrize("case", CASES)
def test_f32r_plain_version_at_the_kernels_splits_matches_nbx(case):
    """"f32r" at every S within 1e-5 of `nbx`."""
    assert _in_torch_order("f32r", case) < NBX_BAR["f32r"]


@pytest.mark.parametrize("case", CASES)
def test_bf16_plain_version_at_the_kernels_splits_matches_nbx(case):
    """"bf16" at every S within 1e-5 of `nbx` (its bf16 roundings are the
    kernel's; its float32 sums run in torch's order)."""
    assert _in_torch_order("bf16", case) < NBX_BAR["bf16"]


@pytest.mark.parametrize("splits", [2, 3, None])
def test_mxu_without_self_pairs_at_the_splits_matches_nbx(splits):
    """"mxu" where no self pair cancels (100 targets apart from 777 sources,
    7 tiles: runs of 4 and 3, of 3, 3 and 1, and the kernels' S) within
    1e-4 of `nbx`."""
    assert _rel(_plain("mxu", "apart", splits).numpy(), _nbx("mxu", "apart")) < MXU_SEPARATE_BAR


def test_split_sum_adds_each_run_then_the_runs():
    """Two runs of 7 tiles, 4 and 3: each run's tiles in turn, then the
    runs; one run: the tiles in turn."""
    parts = torch.from_numpy(np.random.default_rng(3).normal(size=(5, 7, 4)).astype(np.float32))
    zero = torch.zeros((5, 4))
    want = pairwise._running_sum(zero, parts[:, :4].unbind(1)) + pairwise._running_sum(zero, parts[:, 4:].unbind(1))
    assert torch.equal(pairwise._split_sum(parts, 2), want)
    assert torch.equal(pairwise._split_sum(parts, 1), _tiles_in_turn(parts, 1))
