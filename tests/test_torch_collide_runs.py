"""What the collision kernel's design decides outside the kernel, on the
CPU: the launch shape a bucket gets (`collide.launch_shape`), and the
wrappers' refusal of tensors that are neither on the CPU nor on a card. The
kernel itself, and the runs it folds each target's sums over, run only on
the card (tests/test_torch_cuda.py: every launch shape gives the same
bits); its plain version is unchanged and held against the JAX package in
tests/test_torch_collide.py."""

import pytest
import torch

from nbx_torch.ops import collide

torch.set_num_threads(1)


# bucket shapes (t_cap, s_cap, windows) as bucketed_layout_for sizes them for
# the live server's 131,072-body cloud at g = 40, B = 12, and the layouts'
# t_rows: full columns at g = 32, K = 16 (512 targets a column), small caps
@pytest.mark.parametrize("n_win, t_rows, grav, want", [
    (3968, 72, False, dict(targets_a_thread=2, groups=2, team_warps=1, teams=4, windows_per_block=4)),
    (40, 104, False, dict(targets_a_thread=2, groups=2, team_warps=4, teams=1, windows_per_block=1)),
    (1024, 512, False, dict(targets_a_thread=1, groups=16, team_warps=1, teams=4, windows_per_block=4)),
    (128, 24, False, dict(targets_a_thread=1, groups=1, team_warps=4, teams=1, windows_per_block=1)),
    (6400, 8, False, dict(targets_a_thread=1, groups=1, team_warps=1, teams=4, windows_per_block=4)),
    (4096, 96, True, dict(targets_a_thread=1, groups=3, team_warps=1, teams=4, windows_per_block=4)),
])
def test_launch_shape_of_a_bucket(n_win, t_rows, grav, want):
    """R targets a thread (1 where one warp holds every target, for full
    columns and for K7), groups of 32 R targets covering t_rows, one-warp
    teams where a launch has many units and a team of TAIL_WARPS warps a
    unit where it has few, a block to one group; the blocks cover every
    unit once, in the kernel's order: the last group of every window
    first, then the one before."""
    sh = collide.launch_shape(n_win, t_rows, grav=grav)
    assert {k: getattr(sh, k) for k in want} == want
    assert sh.groups * 32 * sh.targets_a_thread >= t_rows > (sh.groups - 1) * 32 * sh.targets_a_thread
    assert sh.teams * sh.team_warps <= collide.WARPS and sh.team_warps in (1, 2, 4, 8)
    assert sh.teams == sh.windows_per_block
    n_wb = -(-n_win // sh.windows_per_block)
    units = [(g, w) for b in range(sh.blocks) for g in [sh.groups - 1 - b // n_wb]
             for w in range((b % n_wb) * sh.windows_per_block, min(n_win, (b % n_wb + 1) * sh.windows_per_block))]
    assert units == [(g, w) for g in reversed(range(sh.groups)) for w in range(n_win)]


@pytest.mark.parametrize("windows", [2, 4, 8, 1000])
def test_multi_window_launch_shape(windows):
    """K2m: windows_per_block windows a block, a team each (at most WARPS
    teams), one warp a team where the launch has many units, and in the
    tail as many as the block leaves room for; a block to one group, as
    K2's."""
    for n_win, t_rows, tail in ((3968, 72, False), (40, 104, True)):
        sh = collide.launch_shape(n_win, t_rows, windows)
        teams = min(windows, collide.WARPS)
        assert sh.teams == teams and sh.windows_per_block == windows
        want = min(collide.TAIL_WARPS, collide.WARPS // teams) if tail else 1
        assert sh.team_warps == want and sh.teams * sh.team_warps <= collide.WARPS
        assert sh.blocks == -(-n_win // windows) * sh.groups
        assert sh.targets_a_thread == collide.launch_shape(n_win, t_rows).targets_a_thread


@pytest.mark.parametrize("n_win, t_rows, want", [
    (1024, 32, dict(targets_a_thread=1, groups=1, team_warps=1, teams=4)),
    (1023, 32, dict(targets_a_thread=1, groups=1, team_warps=collide.TAIL_WARPS, teams=1)),
    (512, 33, dict(targets_a_thread=2, groups=1, team_warps=collide.TAIL_WARPS, teams=1)),
    (4096, collide.FULL_ROWS - 1, dict(targets_a_thread=2, groups=4, team_warps=1, teams=4)),
    (4096, collide.FULL_ROWS, dict(targets_a_thread=1, groups=8, team_warps=1, teams=4)),
])
def test_launch_shape_at_its_edges(n_win, t_rows, want):
    """R = 2 from 33 target rows to FULL_ROWS - 1, R = 1 at 32 and from
    FULL_ROWS; a team of TAIL_WARPS warps a unit below TAIL_UNITS units,
    one-warp teams from it."""
    sh = collide.launch_shape(n_win, t_rows)
    assert {k: getattr(sh, k) for k in want} == want
    assert sh.blocks == -(-n_win // sh.windows_per_block) * sh.groups


_META_ARGS = [torch.empty((4, 8), device="meta"), torch.empty(4, dtype=torch.int32, device="meta"),
              torch.empty(4, dtype=torch.bool, device="meta"),
              torch.empty((1, collide.WIN_INTS), dtype=torch.int32, device="meta"),
              torch.empty((4, 8), device="meta"), torch.empty(4, dtype=torch.int32, device="meta"), 0.2, 0.5, 8, 8]


@pytest.mark.parametrize("wrapper, extra", [
    (collide.collide_fused, ()),
    (collide.collide_full_column, ()),
    (collide.collide_fused_multi, (4,)),
    (collide.collide_fused_grav, ((0.5, 1.0, 0.5), torch.empty((4, 3), device="meta"))),
    (collide.collide_fused_slab, ()),
])
def test_wrapper_refuses_other_devices(wrapper, extra):
    """A wrapper runs the plain version on CPU tensors and the kernel on
    CUDA tensors, and nothing on any other device: it raises and counts
    no launch."""
    before = wrapper.launches
    with pytest.raises(ValueError, match="CPU or CUDA"):
        wrapper(*_META_ARGS, *extra)
    assert wrapper.launches == before
