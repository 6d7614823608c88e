"""The port's CUDA kernels on the card: each held against its plain PyTorch
version (the collision kernel in every layout, at several windows a block
bitwise against one, and with the fused gravity K7 bitwise K2's collision
outputs), the frame step, the at-scale granular step (bucketed, and with the
default full columns) and the spatial step at world size 1 on the card
against the same steps on the CPU, the steps free of host syncs (P3M's,
the drift gate's and the spatial step's too), the spatial step with one
rank a card (NCCL) against the same ranks on gloo, the precision
variants of the direct sum (K1a, K1b, K1d, K1e, and K1c on the tensor cores)
against their plain versions and their error ladder, K2 as the layout
probes launch it, the strict-sequential sweep kernel against its plain
version, and the two-level P3M residual on the card against the CPU.

Marked `cuda`: every test skips where torch sees no CUDA device, and the
NCCL ranks' cases where it sees fewer cards than their mesh holds (2 or
4). On a machine with cards (nvcc on PATH or under CUDA_HOME; no JAX
needed):

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from chip_smoke import (BITWISE, LADDER, SHORT_LAST_SPLIT_N, TENSOR_CORE_VARIANTS, TWOLEVEL_SMALL, VARIANT_TOL,
                        VARIANTS, lattice_pile, ladder_ratios, rand_vel, sequential_scenes, sweep_diff, sweep_inputs,
                        variant_tol, within_ladder)
from nbx_torch import collisions_scaled, integrators, scene, sim
from nbx_torch.bench import drift, layoutsplit, layoutvar
from nbx_torch.bench.granular import granular_cloud
from nbx_torch.bench.pp_scenes import MAIN_CASES, RESIDUAL_CASES, main_case, residual_case
from nbx_torch.collisions import draw_fracture_uniforms
from nbx_torch.config import SimConfig, body_radius
from nbx_torch.ops import _build, collide, p3m, pairwise, ppkernel, sequential
from nbx_torch.bench import p3m_cluster
from nbx_torch.ops.pm import isolated_green_hat
from torch_shard_ranks import NCCL_KINDS as SHARD_NCCL_KINDS
from torch_spatial_ranks import NCCL_KINDS

pytestmark = pytest.mark.cuda

TOL = 1e-5  # max|kernel - plain| / max|plain|


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _rand(n, seed, dev):
    rng = np.random.default_rng(seed)
    pos = torch.tensor(rng.normal(size=(n, 3)) * 20, dtype=torch.float32, device=dev)
    mass = torch.tensor(rng.uniform(0.5, 5, n), dtype=torch.float32, device=dev)
    return pos, mass


def _rel_err(got, want):
    """max|got - want| / max|want|; 0 when both are all zero (a field or a
    slab with nothing in it), not 0/0."""
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


# the last two split K1's sources: 512 blocks at the drift gate's 16,384 (16 x S = 32),
# 27 runs of 3 tiles and 1 at SHORT_LAST_SPLIT_N
@pytest.mark.parametrize("nt,ns", [(4096, 4096), (1000, 4096), (777, 3001), (1, 300), (257, 255), (16384, 16384),
                                   (SHORT_LAST_SPLIT_N, SHORT_LAST_SPLIT_N)])
def test_kernel_matches_plain(dev, nt, ns):
    pos, mass = _rand(ns, ns, dev)
    tgt, _ = _rand(nt, nt + 1, dev)
    before = pairwise.pairwise_acc.launches
    got = pairwise.pairwise_acc(pos, mass, 0.5, 0.5, tgt)
    assert pairwise.pairwise_acc.launches == before + 1
    want = pairwise.pairwise_acc_reference(pos, mass, 0.5, 0.5, tgt)
    assert _rel_err(got, want) < TOL


def test_kernel_mass_zero_padding_is_inert(dev):
    pos, mass = _rand(3000, 7, dev)
    padded = mass.clone()
    padded[1500:] = 0.0
    got = pairwise.pairwise_acc(pos, padded, 0.5, 0.5)[:1500]
    want = pairwise.pairwise_acc_reference(pos[:1500], mass[:1500], 0.5, 0.5)
    assert _rel_err(got, want) < TOL


def test_kernel_wrapper_rejects_bad_inputs(dev):
    pos, mass = _rand(64, 8, dev)
    with pytest.raises(TypeError):
        pairwise.pairwise_acc(pos.double(), mass.double(), 0.5, 0.5)
    with pytest.raises(ValueError):
        pairwise.pairwise_acc(pos, mass.cpu(), 0.5, 0.5)
    with pytest.raises(ValueError):
        pairwise.pairwise_acc(pos, mass[:10], 0.5, 0.5)
    with pytest.raises(ValueError):
        pairwise.pairwise_acc(pos, mass, 0.5, 0.0)


def test_gravity_above_dense_max_uses_the_kernel(dev):
    pos, mass = _rand(2304, 9, dev)
    before = pairwise.pairwise_acc.launches
    got = sim.gravity(pos, mass, 0.5, 0.5)
    assert pairwise.pairwise_acc.launches == before + 1
    want = sim.gravity(pos.cpu(), mass.cpu(), 0.5, 0.5)  # row-blocked on the CPU
    assert _rel_err(got.cpu(), want) < TOL


def test_frames_on_card_match_cpu(dev):
    """Full physics above the dense limit: the card (kernel) and the CPU
    (blocked) take the same events and slots, with the same draws."""
    cfg_cpu = SimConfig(capacity=2304)
    cfg = cfg_cpu.to(dev)
    sc = scene.reference_galaxy(n_disk=2100, seed=1)
    a, b = scene.make_state(cfg, sc, dev), scene.make_state(cfg_cpu, sc, "cpu")
    h = sim.substep_size(cfg)
    gen = torch.Generator().manual_seed(0)
    for _ in range(4 * cfg.sub_steps):
        d = draw_fracture_uniforms(cfg_cpu, gen, "cpu")
        a, ea = sim.substep(a, cfg, h, draws=d.to(dev))
        b, eb = sim.substep(b, cfg_cpu, h, draws=d)
        for f in ("n_merges", "n_fractures", "n_bounces", "n_evicted", "n_dropped"):
            assert int(getattr(ea, f)) == int(getattr(eb, f)), f
    assert torch.equal(a.alive.cpu(), b.alive) and torch.equal(a.seq.cpu(), b.seq)
    for f in ("pos", "vel", "temp"):
        x, y = getattr(a, f).cpu(), getattr(b, f)
        assert float((x - y).abs().max()) <= 1e-5 * float(y.abs().max()), f


def test_step_makes_no_host_sync(dev):
    cfg = SimConfig(capacity=2304).to(dev)
    st = scene.make_state(cfg, scene.reference_galaxy(n_disk=2100, seed=2), dev)
    st, _ = sim.step(st, cfg)  # warm-up: kernel load, allocator
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        st, _ = sim.step(st, cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(st.pos).all()


BOX = 100.0


def _clustered(seed, dead=False):
    """The clustered scene of tests/test_collisions_scaled.py."""
    rng = np.random.default_rng(seed)
    n, n_bg = 192, 128
    p = np.concatenate([rng.uniform(10, 90, (n_bg, 3)), rng.normal(35.0, 2.5, (n - n_bg, 3))])
    pos = np.clip(p, 1.0, 99.0).astype(np.float32)
    vel = rng.normal(0, 1.0, (n, 3)).astype(np.float32)
    mass = rng.uniform(2.0, 8.0, n).astype(np.float32)
    if dead:
        mass[::5] = 0.0
    return pos, vel, mass


def _collide_inputs(pos, vel, mass, scale, dev):
    t = [torch.tensor(x, device=dev) for x in (pos, vel, mass)]
    mat = torch.zeros(len(mass), dtype=torch.int32, device=dev)
    radius = body_radius(torch.tensor(np.where(mass > 0, mass, 5.0), device=dev), mat,
                         SimConfig().to(dev).materials) * scale
    return (*t, radius)


@pytest.mark.parametrize("case", ["two_buckets", "tiny_budgets", "dead_bodies", "cloud_16k",
                                  "dense_clump"])
def test_collide_kernel_matches_plain(dev, case):
    box, g, b = BOX, 8, 4
    if case == "cloud_16k":
        box, g, b = 50.0, 40, 12
        pos, vel, mass = granular_cloud(16384, seed=1, box=box)
        scale = 1.0
    elif case == "dense_clump":  # a window of 391 targets: more than one block's 256 threads
        rng = np.random.default_rng(4)
        pos = np.clip(rng.normal(35.0, 3.0, (640, 3)), 1, 99).astype(np.float32)
        vel = rng.normal(0, 1.0, (640, 3)).astype(np.float32)
        mass = rng.uniform(2.0, 8.0, 640).astype(np.float32)
        scale = 1.0
    else:
        pos, vel, mass = _clustered(8 if case == "tiny_budgets" else 7, dead=case == "dead_bodies")
        scale = 4.0 if case == "tiny_budgets" else 2.0
    if case == "tiny_budgets":
        buckets = ((24, 64, 8), (128, 256, 8))
    elif case == "dense_clump":
        buckets = ((64, 128, 16), (400, 480, 8))
    else:
        buckets = collide.bucketed_layout_for(pos, box, g, b, split_quantile=0.6)
    inputs = _collide_inputs(pos, vel, mass, scale, dev)
    before = collide.collide_fused.launches
    got = collide._bucketed_pass(*inputs, box, g, b, buckets, 0.2, 0.5, collide.collide_fused)
    assert collide.collide_fused.launches == before + len(buckets)
    want = collide._bucketed_pass(*inputs, box, g, b, buckets, 0.2, 0.5,
                                  collide.collide_fused_reference)
    for i in range(3):
        assert _rel_err(got[i], want[i]) < TOL
    assert torch.equal(got[3]["j"], want[3]["j"])
    for i in (4, 5, 6):
        assert int(got[i]) == int(want[i])
    assert int(got[4]) > 0
    assert (int(got[5]) > 0) == (case == "tiny_budgets")


# (seed, dead bodies, g, layout keywords): full column, banded, band-packed
# and compacted, with caps that cover and caps that overflow
LAYOUT_CASES = {
    "full_column_cover": (7, False, 4, dict(max_per_cell=80)),
    "full_column_k16_dead": (9, True, 8, dict(max_per_cell=16)),
    "banded_k4": (7, False, 8, dict(band_cells=4, max_per_cell=4)),
    "banded_b3_dead": (9, True, 8, dict(band_cells=3, max_per_cell=16)),
    "band_packed_cover": (7, False, 8, dict(band_cells=4, packed_caps=(68, 70))),
    "band_packed_sources": (7, False, 8, dict(band_cells=4, packed_caps=(68, 24))),
    "compacted_budget": (7, False, 8, dict(band_cells=4, packed_caps=(68, 70), max_blocks=40)),
    "compacted_dead": (9, True, 8, dict(band_cells=4, packed_caps=(16, 24), max_blocks=64)),
}


@pytest.mark.parametrize("case", list(LAYOUT_CASES))
def test_layout_pass_kernel_matches_plain(dev, case):
    """Each of the other layouts' pass through the kernel (K8's function for
    full columns) against the same pass through the plain version."""
    seed, dead, g, kw = LAYOUT_CASES[case]
    inputs = _collide_inputs(*_clustered(seed, dead=dead), 2.0, dev)
    run, layout, fused = collide._layout_call(g, kw.get("max_per_cell", 16), kw.get("band_cells"),
                                              kw.get("packed_caps"), kw.get("max_blocks"), None)
    assert (fused is collide.collide_full_column) == case.startswith("full_column")
    before = fused.launches
    got = run(*inputs, BOX, g, *layout, 0.2, 0.5, fused)
    assert fused.launches == before + 1
    want = run(*inputs, BOX, g, *layout, 0.2, 0.5, collide.collide_fused_reference)
    for i in range(3):
        assert _rel_err(got[i], want[i]) < TOL
    assert torch.equal(got[3]["j"], want[3]["j"])
    for i in (4, 5, 6):
        assert int(got[i]) == int(want[i])
    assert int(got[4]) > 0
    assert (int(got[5]) > 0) == (case not in ("full_column_cover", "band_packed_cover"))


@pytest.mark.parametrize("windows", [2, 4, 8, 1000])
def test_multi_window_kernel_is_bitwise_one_window(dev, windows):
    """K2m: every output of the bucketed pass at W windows a block equals
    W = 1's bit for bit (W past the window count: one block)."""
    pos, vel, mass = granular_cloud(16384, seed=1, box=50.0)
    buckets = collide.bucketed_layout_for(pos, 50.0, 40, 12)
    inputs = _collide_inputs(pos, vel, mass, 1.0, dev)
    base = collide.binned_collision_pass(*inputs, 50.0, 40, band_cells=12, buckets=buckets)
    before = collide.collide_fused_multi.launches
    got = collide.binned_collision_pass(*inputs, 50.0, 40, band_cells=12, buckets=buckets,
                                        windows_per_block=windows)
    assert collide.collide_fused_multi.launches == before + len(buckets)
    for a, b in zip(got[:3], base[:3]):
        assert torch.equal(a, b)
    for k in base[3]:
        assert torch.equal(got[3][k], base[3][k])
    assert [int(x) for x in got[4:]] == [int(x) for x in base[4:]] and int(got[4]) > 0


def test_default_scan_runs_full_columns_on_the_card(dev):
    """granular_full_kdk_scan(st, cfg, box, n) with every default launches
    the full-column kernel once a step, and matches the CPU's steps."""
    box = BOX * (4096 / 131072.0) ** (1.0 / 3.0)
    pos, vel, mass = granular_cloud(4096, seed=0, box=box)
    cfg_cpu = SimConfig(G=0.5, dt=0.016, sub_steps=1, merge_time=0.25, fracture_threshold=8.0)
    gen = torch.Generator().manual_seed(0)
    draws = [draw_fracture_uniforms(cfg_cpu, gen, "cpu") for _ in range(2)]
    before = collide.collide_full_column.launches
    a, ta = collisions_scaled.granular_full_kdk_scan(
        collisions_scaled.make_granular_state(pos, vel, mass, device=dev), cfg_cpu.to(dev), box, 2,
        draws=[d.to(dev) for d in draws])
    assert collide.collide_full_column.launches == before + 2
    b, tb = collisions_scaled.granular_full_kdk_scan(
        collisions_scaled.make_granular_state(pos, vel, mass, device="cpu"), cfg_cpu, box, 2, draws=draws)
    for k in ta:
        assert torch.equal(ta[k].cpu(), tb[k]), k
    assert torch.equal(a.partner.cpu(), b.partner)
    for f in ("pos", "vel"):
        x, y = getattr(a, f).cpu(), getattr(b, f)
        assert float((x - y).abs().max()) <= 1e-4 * float(y.abs().max()), f


def test_collide_wrapper_rejects_bad_inputs(dev):
    n = 64
    feats = torch.zeros((n, 8), device=dev)
    order = torch.arange(n, dtype=torch.int32, device=dev)
    ok = torch.ones(n, dtype=torch.bool, device=dev)
    win = torch.zeros((4, collide.WIN_INTS), dtype=torch.int32, device=dev)
    out_d = torch.zeros((n, 8), device=dev)
    out_j = torch.full((n,), -1, dtype=torch.int32, device=dev)
    args = [feats, order, ok, win, out_d, out_j, 0.2, 0.5, 8, 8]
    for i, bad in ((0, feats.double()), (1, order.long()), (3, win[:, :10]), (4, out_d.cpu()),
                   (0, torch.zeros((n, 16), device=dev)[:, ::2])):
        for wrapper in (collide.collide_fused, collide.collide_full_column):
            with pytest.raises((TypeError, ValueError)):
                wrapper(*args[:i], bad, *args[i + 1:])
    with pytest.raises(ValueError):
        collide.collide_fused_multi(*args, windows_per_block=0)


def _kernel_calls(dev, case):
    """The collision kernel's arguments on one scene, called directly:
    [(feats, order, src_ok, win, t_rows, s_capw)] and the body count.
    big_windows: a dense clump in two buckets, windows of hundreds of
    targets (not a multiple of 32 R) and more lanes than one round of the
    widest team (8 runs); masked: the clustered scene with dead bodies and a random
    source mask; full_column: full columns of a dense clump at K = 400,
    columns of more than 256 targets."""
    rng = np.random.default_rng(11)
    if case == "masked":
        pos, vel, mass = _clustered(9, dead=True)
    else:
        n = 1500
        pos = np.clip(rng.normal(35.0, 4.0, (n, 3)), 1, 99).astype(np.float32)
        vel = rng.normal(0, 1.0, (n, 3)).astype(np.float32)
        mass = rng.uniform(2.0, 8.0, n).astype(np.float32)
    p, v, m, r = _collide_inputs(pos, vel, mass, 1.0 if case == "big_windows" else 2.0, dev)
    n = p.shape[0]
    if case == "full_column":
        order, win, t_rows, s_capw, _ = collide._kept_windows(p, BOX, 4, 4, 400)
        ok = torch.ones(n, dtype=torch.bool, device=dev)
        return [(collide._sorted_feats(p, v, m, r, order), order, ok, win, t_rows, s_capw)], n
    buckets = ((64, 128, 16), (500, 1200, 8)) if case == "big_windows" else ((8, 16, 64), (96, 128, 64))
    order, starts, cid = collide.cell_sort(p, BOX, 8)
    windows, t_ok, _ = collide._bucket_windows(starts, cid, n, 8, 4, buckets)
    if case == "masked":
        t_ok = t_ok & torch.tensor(rng.random(n) < 0.7, device=dev)
    feats = collide._sorted_feats(p, v, m, r, order)
    return [(feats, order, t_ok, w, t_rows, s_capw) for w, t_rows, s_capw in windows], n


def _run_calls(fused, calls, n, grav=None):
    """Every call through `fused` into fresh outputs: (out_d, out_j[, out_g])."""
    dev = calls[0][0].device
    out_d = torch.zeros((n, 8), device=dev)
    out_j = torch.full((n,), -1, dtype=torch.int32, device=dev)
    out_g = torch.zeros((n, 3), device=dev)
    for feats, order, ok, win, t_rows, s_capw in calls:
        extra = () if grav is None else (grav, out_g)
        fused(feats, order, ok, win, out_d, out_j, 0.2, 0.5, t_rows, s_capw, *extra)
    torch.cuda.synchronize()
    return (out_d, out_j) if grav is None else (out_d, out_j, out_g)


# Launch shapes (ops/collide.py's launch-shape constants): R targets a thread
# (1, or 2 also on full columns: FULL_ROWS past any window), one-warp teams
# everywhere (TAIL_UNITS 0) or a team of TAIL_WARPS warps a unit everywhere
# (TAIL_UNITS past any launch), TEAMS teams a block
LAUNCH_SHAPES = {
    "r1_warps": dict(TARGETS_A_THREAD=1, TAIL_UNITS=0),
    "r2_warps": dict(TAIL_UNITS=0),
    "r2_full_columns": dict(FULL_ROWS=1 << 30, TAIL_UNITS=0),
    "r2_one_team": dict(TAIL_UNITS=0, TEAMS=1),
    "r2_team2": dict(TAIL_UNITS=1 << 30, TAIL_WARPS=2),
    "r2_team4": dict(TAIL_UNITS=1 << 30, TAIL_WARPS=4),
    "r2_team8": dict(TAIL_UNITS=1 << 30, TAIL_WARPS=8, FULL_ROWS=1 << 30),
    "r1_team4": dict(TARGETS_A_THREAD=1, TAIL_UNITS=1 << 30, TAIL_WARPS=4),
}
KERNEL_CASES = ["big_windows", "masked", "full_column"]


@pytest.mark.parametrize("case", KERNEL_CASES)
def test_collide_kernel_direct_matches_plain(dev, case):
    """The kernel called directly against its plain version: deltas to TOL,
    bounce counts and partners exact; the scene really has what it is for."""
    calls, n = _kernel_calls(dev, case)
    got = _run_calls(collide.collide_fused, calls, n)
    want = _run_calls(collide.collide_fused_reference, calls, n)
    assert _rel_err(got[0][:, :7], want[0][:, :7]) < TOL
    assert torch.equal(got[0][:, 7], want[0][:, 7]) and torch.equal(got[1], want[1])
    assert int(got[0][:, 7].sum()) > 0
    tn = torch.cat([c[3][:, 1] for c in calls])
    lanes = torch.cat([c[3][:, 3::2].sum(1) for c in calls])
    if case == "big_windows":
        assert int(lanes.max()) > 8 * collide.RUN and bool(((tn % 64) != 0).any())
    if case == "full_column":
        assert int(tn.max()) > 256
    if case == "masked":
        assert not bool(calls[0][2].all())


@pytest.mark.parametrize("case", KERNEL_CASES)
def test_collide_kernel_gives_the_same_bits_twice(dev, case):
    calls, n = _kernel_calls(dev, case)
    a = _run_calls(collide.collide_fused, calls, n)
    b = _run_calls(collide.collide_fused, calls, n)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("shape", list(LAUNCH_SHAPES))
@pytest.mark.parametrize("case", KERNEL_CASES)
def test_collide_launch_shapes_give_the_same_bits(dev, case, shape, monkeypatch):
    """Every launch shape folds each target's sums over the same runs in the
    same order: K2's outputs bitwise those of the default shape, and K7's
    collision outputs bitwise K2's, at each shape."""
    calls, n = _kernel_calls(dev, case)
    base = _run_calls(collide.collide_fused, calls, n)
    for name, value in LAUNCH_SHAPES[shape].items():
        monkeypatch.setattr(collide, name, value)
    got = _run_calls(collide.collide_fused, calls, n)
    assert torch.equal(got[0], base[0]) and torch.equal(got[1], base[1])
    k7 = _run_calls(collide.collide_fused_grav, calls, n, grav=(0.5, BOX / 8 / 3.0, 0.5))
    assert torch.equal(k7[0], base[0]) and torch.equal(k7[1], base[1])
    assert bool(torch.isfinite(k7[2]).all()) and float(k7[2].abs().max()) > 0


def _server_setup(dev, n=4096, g=16, b=4, pm_grid=32):
    box = BOX * (n / 131072.0) ** (1.0 / 3.0)
    pos, vel, mass = granular_cloud(n, seed=0, box=box)
    st = collisions_scaled.make_granular_state(pos, vel, mass, seed=0, device=dev)
    cfg = SimConfig(G=0.5, dt=0.016, sub_steps=1, merge_time=0.25, fracture_threshold=8.0).to(dev)
    kw = dict(n_cells=g, band_cells=b, buckets=collide.bucketed_layout_for(pos, box, g, b),
              force_impl="pm", pm_grid=pm_grid, log_events=True,
              green_hat=isolated_green_hat(box, pm_grid, device=dev))
    return st, cfg, box, kw


def test_scaled_steps_on_card_match_cpu(dev):
    """The at-scale step (PM gravity, bucketed kernel) on the card and on the
    CPU with the same draws: counters and partners exactly; floats to 1e-4
    (PM's atomic deposit sums in another order; another FFT library)."""
    a, cfg, box, kw = _server_setup(dev)
    b, cfg_cpu, _, kw_cpu = _server_setup("cpu")
    gen = torch.Generator().manual_seed(0)
    draws = [draw_fracture_uniforms(cfg_cpu, gen, "cpu") for _ in range(3)]
    before = collide.collide_fused.launches
    a, ta, _ = collisions_scaled.granular_full_kdk_scan(a, cfg, box, 3, draws=[d.to(dev) for d in draws], **kw)
    assert collide.collide_fused.launches == before + 3 * len(kw["buckets"])
    b, tb, _ = collisions_scaled.granular_full_kdk_scan(b, cfg_cpu, box, 3, draws=draws, **kw_cpu)
    for k in ta:
        assert torch.equal(ta[k].cpu(), tb[k]), k
    assert int(tb["n_bounces"]) > 0
    assert torch.equal(a.partner.cpu(), b.partner)
    for f in ("pos", "vel", "mass", "temp", "contact_t"):
        x, y = getattr(a, f).cpu(), getattr(b, f)
        assert float((x - y).abs().max()) <= 1e-4 * float(y.abs().max()), f


def test_scaled_step_makes_no_host_sync(dev):
    st, cfg, box, kw = _server_setup(dev)
    st, _, _ = collisions_scaled.granular_full_kdk_scan(st, cfg, box, 1, **kw)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        st, _, _ = collisions_scaled.granular_full_kdk_scan(st, cfg, box, 1, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(st.pos).all()


@pytest.mark.parametrize("case", list(MAIN_CASES))
def test_pp_short_matches_plain(dev, case):
    """K4 on the main pass's work items against its plain version; the
    layout's n_overflow equal on the card and the CPU."""
    pos, mass, G, a, box, g, k, eps, buckets = main_case(case)
    if buckets == "census":
        buckets = ppkernel.pp_buckets_for(pos, box, g, k)
    args, ovf = ppkernel._main_pass(torch.from_numpy(pos).to(dev), torch.from_numpy(mass).to(dev), G, a,
                                    box, g, k, eps, buckets, None)
    _, ovf_cpu = ppkernel._main_pass(torch.from_numpy(pos), torch.from_numpy(mass), G, a, box, g, k, eps,
                                     buckets, None)
    before = ppkernel.pp_short.launches
    got = ppkernel.pp_short(*args)
    assert ppkernel.pp_short.launches == before + 1
    assert _rel_err(got, ppkernel.pp_short_reference(*args)) < TOL
    assert int(ovf) == int(ovf_cpu)


@pytest.mark.parametrize("case", list(RESIDUAL_CASES))
def test_pp_react_and_rr_match_plain(dev, case):
    """K5 (one evaluation a pair, block partials) against its plain version
    (column sums) and K4 on the residual-residual block; n_missed equal on
    the card and the CPU."""
    pos, mass, G, a, box, g, k, m, cap, eps = residual_case(case)
    missed = []
    for d in (dev, torch.device("cpu")):
        tp, tm = torch.from_numpy(pos).to(d), torch.from_numpy(mass).to(d)
        sort = p3m.cell_sort(tp, box, g)
        ri, rv = p3m.take_rows(p3m.overflowing(sort, k)[1], m)
        args, n_missed = ppkernel._table_pass(tp, tm, G, a, box, g, k, ri, rv, eps, cap, sort)
        missed.append(int(n_missed))
        if d == dev:
            assert _rel_err(ppkernel.pp_react(*args), ppkernel.pp_react_reference(*args)) < TOL
            rr = ppkernel._rr_pass(tp, tm, G, a, box, ri, rv, eps)
            assert _rel_err(ppkernel.pp_short(*rr), ppkernel.pp_short_reference(*rr)) < TOL
    assert missed[0] == missed[1] and (missed[0] > 0) == (case == "affected_cap")


def _table_args_on(dev, case, eps=None):
    pos, mass, G, a, box, g, k, m, cap, case_eps = residual_case(case)
    tp, tm = torch.from_numpy(pos).to(dev), torch.from_numpy(mass).to(dev)
    sort = p3m.cell_sort(tp, box, g)
    ri, rv = p3m.take_rows(p3m.overflowing(sort, k)[1], m)
    return ppkernel._table_pass(tp, tm, G, a, box, g, k, ri, rv, case_eps if eps is None else eps, cap, sort)[0]


@pytest.mark.parametrize("case", list(RESIDUAL_CASES))
def test_pp_react_gives_the_same_bits_twice(dev, case):
    """No atomics in K5's pair kernel or its combine: two calls on the same
    inputs agree bitwise, one law evaluation a pair and one launch counted."""
    args = _table_args_on(dev, case)
    before = ppkernel.pp_react.launches
    first = ppkernel.pp_react(*args)
    assert ppkernel.pp_react.launches == before + 1
    assert torch.equal(first, ppkernel.pp_react(*args))


@pytest.mark.parametrize("case", list(RESIDUAL_CASES))
def test_pp_react_at_eps_zero_takes_the_guarded_law(dev, case):
    """eps = 0, the default of residual_table_acc_kernel: eps^2 below FLT_MIN,
    so K5 takes rsqrtf guarded at s^2 = 0, not rsqrt.approx.ftz."""
    args = _table_args_on(dev, case, eps=0.0)
    assert args[-1][0] == 0.0
    got = ppkernel.pp_react(*args)
    assert torch.isfinite(got).all() and _rel_err(got, ppkernel.pp_react_reference(*args)) < TOL


def _main_args_on(dev, case, eps=None):
    pos, mass, G, a, box, g, k, case_eps, buckets = main_case(case)
    if buckets == "census":
        buckets = ppkernel.pp_buckets_for(pos, box, g, k)
    return ppkernel._main_pass(torch.from_numpy(pos).to(dev), torch.from_numpy(mass).to(dev), G, a, box, g, k,
                               case_eps if eps is None else eps, buckets, None)[0]


def _rr_args_on(dev, case, eps=None, n_live=None):
    """The residual-residual block's arguments on a residual scene; n_live
    cuts the live residuals to a prefix of that many."""
    pos, mass, G, a, box, g, k, m, _, case_eps = residual_case(case)
    tp, tm = torch.from_numpy(pos).to(dev), torch.from_numpy(mass).to(dev)
    ri, rv = p3m.take_rows(p3m.overflowing(p3m.cell_sort(tp, box, g), k)[1], m)
    if n_live is not None:
        assert int(rv.sum()) >= n_live
        rv = rv & (torch.arange(m, device=dev) < n_live)
    return ppkernel._rr_pass(tp, tm, G, a, box, ri, rv, case_eps if eps is None else eps)


K4_PASSES = [("main", c) for c in MAIN_CASES] + [("rr", c) for c in RESIDUAL_CASES]


def _k4_args_on(dev, kind, case, eps=None):
    return _main_args_on(dev, case, eps) if kind == "main" else _rr_args_on(dev, case, eps)


@pytest.mark.parametrize("kind,case", K4_PASSES)
def test_pp_short_gives_the_same_bits_twice(dev, kind, case):
    """No atomics in K4's main pass, nor in the residual-residual block's
    runs and their combine: two calls on the same inputs agree bitwise, one
    launch counted a call."""
    args = _k4_args_on(dev, kind, case)
    if kind == "rr":
        assert ppkernel.rr_runs(args[5])[0] > 1
    before = ppkernel.pp_short.launches
    first = ppkernel.pp_short(*args)
    assert ppkernel.pp_short.launches == before + 1
    assert torch.equal(first, ppkernel.pp_short(*args))


@pytest.mark.parametrize("kind,case", K4_PASSES)
def test_pp_short_at_eps_zero_takes_the_guarded_law(dev, kind, case):
    """eps = 0, the default of short_range_acc_kernel and residual_rr_dense_kernel:
    eps^2 below FLT_MIN, so K4 takes rsqrtf guarded at s^2 = 0, not
    rsqrt.approx.ftz."""
    args = _k4_args_on(dev, kind, case, eps=0.0)
    assert args[-1][0] == 0.0
    got = ppkernel.pp_short(*args)
    assert torch.isfinite(got).all() and _rel_err(got, ppkernel.pp_short_reference(*args)) < TOL


@pytest.mark.parametrize("n_live", [891, 600, 256])
def test_pp_short_rr_with_a_ragged_live_count_matches_plain(dev, n_live):
    """The residual-residual block at M = 1,024 (4 runs of one tile) with
    891 live residuals (the last item and run part full), 600 (the last item
    and run empty) and 256 (one item, one run): items and runs past the live
    residuals exit, the combine skips them."""
    args = _rr_args_on(dev, "affected_cap", n_live=n_live)
    assert args[5] == 1024 and ppkernel.rr_runs(1024) == (4, 256)
    assert int((args[1] >= 0).sum()) == n_live
    got = ppkernel.pp_short(*args)
    assert _rel_err(got, ppkernel.pp_short_reference(*args)) < TOL
    idle = torch.ones(got.shape[0], dtype=torch.bool, device=dev)
    idle[args[1][:n_live].long()] = False
    assert bool(idle.any()) and not bool(got[idle].any())


def test_p3m_scaled_step_makes_no_host_sync(dev):
    st, cfg, box, kw = _server_setup(dev)
    kw.update(force_impl="p3m", p3m=dict(n_cells=4, max_per_cell=64, max_residual=2048),
              green_hat=isolated_green_hat(box, 32, p3m.smoothing_length(box, 4), smoothed=True, device=dev))
    st, _, _ = collisions_scaled.granular_full_kdk_scan(st, cfg, box, 1, **kw)  # warm-up
    torch.cuda.synchronize()
    before = ppkernel.pp_react.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        st, tot, _ = collisions_scaled.granular_full_kdk_scan(st, cfg, box, 1, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert ppkernel.pp_react.launches == before + 2
    assert torch.isfinite(st.pos).all() and int(tot["n_uncorrected"]) == 0


# (nt, ns): square, rectangular, ragged, tiny; K6 splits the sources of each but the last
GRAVITY_SHAPES = [(4096, 4096), (1000, 4096), (777, 3001), (1, 300), (129, 127)]


@pytest.mark.parametrize("nt,ns", GRAVITY_SHAPES)
def test_accjerk_kernel_matches_plain(dev, nt, ns):
    pos, mass = _rand(ns, ns, dev)
    tgt, _ = _rand(nt, nt + 1, dev)
    vel, tvel = rand_vel(ns, ns + 2, dev), rand_vel(nt, nt + 3, dev)
    before = pairwise.pairwise_acc_jerk.launches
    got = pairwise.pairwise_acc_jerk(pos, mass, vel, 0.5, 0.5, tgt, tvel)
    assert pairwise.pairwise_acc_jerk.launches == before + 1
    want = pairwise.pairwise_acc_jerk_reference(pos, mass, vel, 0.5, 0.5, tgt, tvel)
    for g, w in zip(got, want):
        assert _rel_err(g, w) < TOL


def test_accjerk_with_a_shorter_last_split_matches_plain(dev):
    """SHORT_LAST_SPLIT_N bodies: K6's runs of whole tiles end in a shorter
    one."""
    n = SHORT_LAST_SPLIT_N
    s = pairwise.source_splits(n, n, pairwise.ACCJERK_ROWS)
    assert s > 1 and s * pairwise.split_tiles(n, s) > -(-n // pairwise.TILE)
    pos, mass = _rand(n, 13, dev)
    vel = rand_vel(n, 14, dev)
    got = pairwise.pairwise_acc_jerk(pos, mass, vel, 0.5, 0.5)
    for g, w in zip(got, pairwise.pairwise_acc_jerk_reference(pos, mass, vel, 0.5, 0.5)):
        assert _rel_err(g, w) < TOL


def test_accjerk_below_flt_min_takes_rsqrtf(dev):
    """softening 1e-20: eps^2 = 1e-40 is subnormal, so K6 takes rsqrtf, not
    rsqrt.approx.ftz; the targets 300 away from the sources in each
    coordinate, so that no near pair goes unsoftened."""
    pos, mass = _rand(4096, 15, dev)
    tgt, _ = _rand(1000, 16, dev)
    tgt += 300.0
    vel, tvel = rand_vel(4096, 17, dev), rand_vel(1000, 18, dev)
    got = pairwise.pairwise_acc_jerk(pos, mass, vel, 0.5, 1e-20, tgt, tvel)
    want = pairwise.pairwise_acc_jerk_reference(pos, mass, vel, 0.5, 1e-20, tgt, tvel)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all() and _rel_err(g, w) < TOL


@pytest.mark.parametrize("n", [4096, 16384])
def test_accjerk_gives_the_same_bits_twice(dev, n):
    """No atomics: two launches on the same inputs agree bitwise (16,384: the
    drift gate's sphere, 16 x 32 blocks)."""
    pos, vel, mass, G, eps, _ = drift.gate_scene(n, device=dev)
    assert pairwise.source_splits(n, n, pairwise.ACCJERK_ROWS) > 1
    first = pairwise.pairwise_acc_jerk(pos, mass, vel, G, eps)
    for a, b in zip(first, pairwise.pairwise_acc_jerk(pos, mass, vel, G, eps)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("nt,ns", GRAVITY_SHAPES)
def test_potential_kernel_matches_plain(dev, nt, ns):
    """Targets that are not sources: target_mass 0 leaves the kernel's raw sum."""
    pos, mass = _rand(ns, ns, dev)
    tgt, _ = _rand(nt, nt + 1, dev)
    zero = torch.zeros(nt, device=dev)
    before = pairwise.potential_per_body.launches
    got = pairwise.potential_per_body(pos, mass, 0.5, 0.5, tgt, zero)
    assert pairwise.potential_per_body.launches == before + 1
    assert _rel_err(got, pairwise.potential_per_body_reference(pos, mass, 0.5, 0.5, tgt, zero)) < TOL


def test_potential_kernel_removes_the_self_term_on_a_target_slice(dev):
    pos, mass = _rand(3000, 5, dev)
    whole = pairwise.potential_per_body(pos, mass, 0.5, 0.5)
    assert _rel_err(whole, pairwise.potential_per_body_reference(pos, mass, 0.5, 0.5)) < TOL
    part = pairwise.potential_per_body(pos, mass, 0.5, 0.5, pos[300:1400], mass[300:1400])
    assert _rel_err(part, whole[300:1400]) < TOL


def test_potential_with_a_shorter_last_split_matches_plain(dev):
    """SHORT_LAST_SPLIT_N bodies: K3's runs of whole tiles end in a shorter
    one."""
    n = SHORT_LAST_SPLIT_N
    s = pairwise.source_splits(n, n, pairwise.POTENTIAL_ROWS)
    assert s > 1 and s * pairwise.split_tiles(n, s) > -(-n // pairwise.TILE)
    pos, mass = _rand(n, 13, dev)
    got = pairwise.potential_per_body(pos, mass, 0.5, 0.5)
    assert _rel_err(got, pairwise.potential_per_body_reference(pos, mass, 0.5, 0.5)) < TOL


def test_potential_below_flt_min_takes_rsqrtf(dev):
    """softening 1e-20: eps^2 = 1e-40 is subnormal, so K3 takes rsqrtf, not
    rsqrt.approx.ftz; the targets 300 away from the sources (target mass 0:
    no self term), so that no near pair goes unsoftened."""
    pos, mass = _rand(4096, 15, dev)
    tgt, _ = _rand(1000, 16, dev)
    tgt += 300.0
    zero = torch.zeros(1000, device=dev)
    got = pairwise.potential_per_body(pos, mass, 0.5, 1e-20, tgt, zero)
    want = pairwise.potential_per_body_reference(pos, mass, 0.5, 1e-20, tgt, zero)
    assert torch.isfinite(got).all() and _rel_err(got, want) < TOL


@pytest.mark.parametrize("n", [4096, 16384])
def test_potential_gives_the_same_bits_twice(dev, n):
    """No atomics: two launches on the same inputs agree bitwise (16,384: the
    drift gate's sphere, 32 x 16 blocks)."""
    pos, _, mass, G, eps, _ = drift.gate_scene(n, device=dev)
    assert pairwise.source_splits(n, n, pairwise.POTENTIAL_ROWS) > 1
    assert torch.equal(pairwise.potential_per_body(pos, mass, G, eps), pairwise.potential_per_body(pos, mass, G, eps))


def test_accjerk_and_potential_mass_zero_padding_is_inert(dev):
    pos, mass = _rand(3000, 7, dev)
    vel = rand_vel(3000, 8, dev)
    padded = mass.clone()
    padded[1500:] = 0.0
    got = pairwise.pairwise_acc_jerk(pos, padded, vel, 0.5, 0.5)
    want = pairwise.pairwise_acc_jerk_reference(pos[:1500], mass[:1500], vel[:1500], 0.5, 0.5)
    for g, w in zip(got, want):
        assert _rel_err(g[:1500], w) < TOL
    phi = pairwise.potential_per_body(pos, padded, 0.5, 0.5)[:1500]
    assert _rel_err(phi, pairwise.potential_per_body_reference(pos[:1500], mass[:1500], 0.5, 0.5)) < TOL


def test_accjerk_and_potential_wrappers_reject_bad_inputs(dev):
    pos, mass = _rand(64, 8, dev)
    vel = rand_vel(64, 9, dev)
    with pytest.raises(TypeError):
        pairwise.pairwise_acc_jerk(pos.double(), mass.double(), vel.double(), 0.5, 0.5)
    with pytest.raises(TypeError):
        pairwise.potential_per_body(pos.double(), mass.double(), 0.5, 0.5)
    with pytest.raises(ValueError):
        pairwise.pairwise_acc_jerk(pos, mass, vel.cpu(), 0.5, 0.5)
    with pytest.raises(ValueError):
        pairwise.potential_per_body(pos, mass[:10], 0.5, 0.5)
    with pytest.raises(ValueError):
        pairwise.pairwise_acc_jerk(pos, mass, vel, 0.5, 0.0)
    with pytest.raises(ValueError):
        pairwise.potential_per_body(pos, mass, 0.5, -1.0)


def test_drift_and_hermite_chunks_make_no_host_sync(dev):
    pos, vel, mass, G, eps, h = drift.gate_scene(2048, device=dev)

    def fj(p, v):
        return pairwise.pairwise_acc_jerk(p, mass, v, G, eps)

    s = integrators.init_hermite(pos, vel, fj)
    drift.drift_run(pos, vel, mass, G, eps, h, 0)  # warm-up: kernel load
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, _, e = drift.drift_run(pos, vel, mass, G, eps, h, 20, diag_every=10)
        s, _ = integrators.run_hermite(s, h, 10, fj)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(e).all() and torch.isfinite(s.pos).all()


# ---- the spatial step: K7 and the step on the card ---------------------------------

SPATIAL_SLABS = {  # (d_x, d_y, me_x, me_y, layout, caps): 1-D and 2-D slabs, caps that cover and overflow
    "1d_inner_covers": (4, 1, 1, 0, "packed", (96, 128)),
    "1d_inner_overflows": (4, 1, 1, 0, "packed", (8, 10)),
    "2d_bucketed": (2, 4, 0, 1, "bucketed", ((8, 8, 64), (96, 128, 64))),
    "whole_grid_dead": (1, 1, 0, 0, "packed", (96, 128)),
}


@pytest.mark.parametrize("case", list(SPATIAL_SLABS))
def test_grav_kernel_matches_plain_and_k2(dev, case):
    """K7 (the local entries with short gravity) against its plain version:
    deltas and gravity to TOL, partners, bounces and n_overflow exactly; its
    collision outputs bitwise K2's on the same windows."""
    from chip_smoke import slab_rows

    d_x, d_y, me_x, me_y, layout, caps = SPATIAL_SLABS[case]
    pos, vel, mass = _clustered(7, dead=case.endswith("dead"))
    inputs = _collide_inputs(pos, vel, mass, 2.0, dev)
    rows, _, (x0, w_x, y0, w_y) = slab_rows(inputs[0], BOX, 8, d_x, d_y, me_x, me_y, junk=8)
    p, v, m, r = (x[rows] for x in inputs)
    if layout == "packed":
        buckets, src_over = ((*caps, w_x * (w_y or 8) * 4),), "own_all"
    else:
        buckets, src_over = caps, "own"
    sg = (0.5, BOX / 8 / 3.0, 0.5)
    args = (p, v, m, r, BOX, 8, 2, buckets, src_over, 0.2, 0.5, x0, w_x, y0, w_y)
    before = collide.collide_fused_grav.launches
    got = collide._local_pass(*args, sg)
    assert collide.collide_fused_grav.launches == before + len(buckets)
    want = collide._local_pass(*args, sg, fused=collide.collide_fused_reference)
    k2 = collide._local_pass(*args, None)
    assert _rel_err(got[0][:, :7], want[0][:, :7]) < TOL and _rel_err(got[2], want[2]) < TOL
    assert torch.equal(got[1], want[1]) and torch.equal(got[0][:, 7], want[0][:, 7])
    assert int(got[3]) == int(want[3]) and (int(got[3]) > 0) == case.endswith("overflows")
    assert torch.equal(got[0], k2[0]) and torch.equal(got[1], k2[1]) and int(got[3]) == int(k2[2])


def test_grav_kernel_at_zero_eps(dev):
    """K7 at eps = 0 (its law's rsqrtf instantiation) on the 131,072-body
    cloud's whole grid: gravity to TOL of its plain version, its deltas,
    partners and n_overflow bitwise K2's on the same windows."""
    from chip_smoke import SCALED_N, SPATIAL_CFG, collide_inputs, local_both

    g, b, tc, sc = (int(x) for x in SPATIAL_CFG.split(","))
    pos, vel, mass = granular_cloud(SCALED_N, seed=0, box=BOX)
    inputs = collide_inputs(pos, vel, mass, 1.0, dev)
    got, want, k2, _, _ = local_both(inputs, torch.arange(SCALED_N, device=dev), BOX, g, b, (tc, sc),
                                     (-1, g, 0, None), (0.5, BOX / g / 3.0, 0.0))
    assert _rel_err(got[2], want[2]) < TOL and float(want[2].abs().max()) > 0
    assert _rel_err(got[0][:, :7], want[0][:, :7]) < TOL and torch.equal(got[1], want[1])
    assert torch.equal(got[0], k2[0]) and torch.equal(got[1], k2[1]) and int(got[-1]) == int(k2[-1])


def _spatial_pair(dev, force, n=4096):
    """The same spatial step on a CUDA mesh and a CPU mesh of one process."""
    from chip_smoke import spatial_setup
    from nbx_torch.parallel import shard

    a = spatial_setup(dev, n=n, token="16,4,96,104", force=force, mesh=shard.make_mesh(device_type="cuda"))
    b = spatial_setup("cpu", n=n, token="16,4,96,104", force=force, mesh=shard.make_mesh(device_type="cpu"))
    return a, b


@pytest.mark.parametrize("force", ["pm", "p3m"])
def test_spatial_steps_on_card_match_cpu(dev, force):
    """The spatial step at world size 1 on the card and on the CPU with the
    same draws: counters, ids and partners exactly; floats to 1e-4 (PM's
    atomic deposit sums in another order; another FFT library)."""
    from nbx_torch.parallel import shard

    with shard.local_world("cpu:gloo,cuda:nccl"):
        (step_a, a, _, h, _), (step_b, b, cfg_b, _, _) = _spatial_pair(dev, force)
        gen = torch.Generator().manual_seed(0)
        kernel = collide.collide_fused_grav if force == "p3m" else collide.collide_fused
        before = kernel.launches
        for _ in range(3):
            draws = draw_fracture_uniforms(cfg_b, gen, "cpu")
            a, ca = step_a(a, h, draws.to(dev))
            b, cb = step_b(b, h, draws)
            for k in ca:
                assert torch.equal(ca[k].cpu(), cb[k]), k
        assert kernel.launches == before + 3
    for f in ("uid", "partner_uid", "mat", "uid_next"):
        assert torch.equal(getattr(a, f).cpu(), getattr(b, f)), f
    for f in ("pos", "vel", "acc", "mass", "temp", "contact_t"):
        x, y = getattr(a, f).cpu(), getattr(b, f)
        assert float((x - y).abs().max()) <= 1e-4 * float(y.abs().max()), f


def test_spatial_step_makes_no_host_sync(dev):
    from chip_smoke import spatial_setup
    from nbx_torch.parallel import shard

    with shard.local_world("nccl"):
        step, st, _, h, _ = spatial_setup(dev, n=4096, token="16,4,96,104", force="p3m")
        st, _ = step(st, h)  # warm-up: kernel load, NCCL's communicator
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            st, c = step(st, h)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(st.pos).all() and torch.isfinite(st.acc).all()


# ---- the spatial step across cards: NCCL ranks against the same ranks on gloo -------

TESTS = os.path.dirname(os.path.abspath(__file__))
NCCL_EXACT = ("mat", "uid", "partner_uid", "uid_next", "buckets")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def compare_nccl_run(out: str, kind: str, world: int, exact=NCCL_EXACT) -> int:
    """Every rank's scenes on the CUDA mesh against the CPU mesh: counters
    ("/c/" keys), the `exact` fields, and integer, bool and string arrays
    exactly; floats to 1e-4 of each field's largest magnitude. Returns the
    number of files compared."""
    n = 0
    for name in sorted(os.listdir(os.path.join(out, kind))):
        if not name.endswith("_cuda.npz"):
            continue
        a = np.load(os.path.join(out, kind, name))
        b = np.load(os.path.join(out, kind, name.replace("_cuda.npz", "_cpu.npz")))
        assert set(a.files) == set(b.files), name
        for key in a.files:
            x, y = a[key], b[key]
            if "/c/" in key or key.split("/")[-1] in exact or y.dtype.kind not in "fc":
                np.testing.assert_array_equal(x, y, err_msg=f"{name} {key}")
            else:
                scale = max(float(np.abs(y).max(initial=0.0)), 1e-30)
                np.testing.assert_allclose(x, y, rtol=0, atol=1e-4 * scale, err_msg=f"{name} {key}")
        n += 1
    assert n > 0 and n % world == 0, (kind, n)
    return n


def _run_ranks(script: str, kind: str, world: int, out: str) -> None:
    """Start `world` ranks of tests/<script> (one a card) and wait for them."""
    _build.build_all()  # once here, not in every rank
    env = dict(os.environ, PYTHONPATH=os.path.dirname(TESTS), PYTHONUNBUFFERED="1", OMP_NUM_THREADS="1")
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, os.path.join(TESTS, script), kind, str(r), str(world), str(port),
                               out], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    failed, deadline = [], time.time() + 300
    try:
        for r, p in enumerate(procs):
            log, _ = p.communicate(timeout=max(5.0, deadline - time.time()))
            if p.returncode != 0:
                failed.append(f"rank {r} exited {p.returncode}:\n{log[-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert not failed, "\n".join(failed)


@pytest.mark.parametrize("kind", list(NCCL_KINDS))
def test_spatial_ranks_on_cards_match_gloo(dev, kind, tmp_path):
    """The spatial step with one rank a card (NCCL) against the same ranks on
    the CPU (gloo) in one process group, on the scenes of tests/test_spatial.py
    (tests/torch_spatial_ranks.py), with the same fracture uniforms. On
    nccl_1d2 both neighbours are one peer, so each exchange's two messages
    go to one rank and are told apart by the order they are posted in, NCCL
    ignoring tags. The gloo ranks are held against the JAX package in
    tests/test_torch_spatial.py."""
    world = NCCL_KINDS[kind][0]
    if torch.cuda.device_count() < world:
        pytest.skip(f"needs {world} CUDA devices")
    _run_ranks("torch_spatial_ranks.py", kind, world, str(tmp_path))
    compare_nccl_run(str(tmp_path), kind, world)


SHARD_EXACT = ("mat", "partner", "j", "approaching", "steps")


@pytest.mark.parametrize("kind", list(SHARD_NCCL_KINDS))
def test_shard_ranks_on_cards_match_gloo(dev, kind, tmp_path):
    """The all-gather paths with one rank a card (NCCL) against the same
    ranks on the CPU (gloo) in one process group, on the scenes of
    tests/test_shard.py (tests/torch_shard_ranks.py) with the same fracture
    uniforms: nccl_d2 is a 1-D mesh of 2, where the ring's two neighbours
    are one peer (one send and one receive a hop), and a 1x2 mesh; nccl_d4
    a 1-D mesh of 4 and the 2x2 mesh. The gloo ranks are held against the
    JAX package in tests/test_torch_shard.py."""
    world = SHARD_NCCL_KINDS[kind]
    if torch.cuda.device_count() < world:
        pytest.skip(f"needs {world} CUDA devices")
    _run_ranks("torch_shard_ranks.py", kind, world, str(tmp_path))
    compare_nccl_run(str(tmp_path), kind, world, SHARD_EXACT)


# ---- the all-gather paths at world size 1: the slab entry (K2) and the granular step ---

@pytest.mark.parametrize("n_slabs", [1, 2, 4, 8])
def test_slab_entry_kernel_matches_plain(dev, n_slabs):
    """K2 through packed_collision_blocks_slab against its plain version on
    each slab of a split of the clustered scene; the reduced rows bitwise the
    whole-grid band-packed pass."""
    from chip_smoke import clustered_scene, collide_inputs

    pos, vel, mass = clustered_scene(seed=9)
    mass[::5] = 0.0
    inputs = collide_inputs(pos, vel, mass, 2.0, dev)
    caps = collide.packed_caps_for(pos, 100.0, 8, 4)
    k = 64 // n_slabs
    u_d = torch.zeros((192, 8), device=dev)
    u_j = torch.full((192,), -1, dtype=torch.int32, device=dev)
    for s_ in range(n_slabs):
        args = (*inputs, 100.0, 8, 4, caps, 0.2, 0.5, s_ * k, k)
        before = collide.collide_fused_slab.launches
        got = collide.packed_collision_blocks_slab(*args)
        assert collide.collide_fused_slab.launches == before + 1
        want = collide.packed_collision_blocks_slab(*args, fused=collide.collide_fused_reference)
        assert _rel_err(got[0][:, :7], want[0][:, :7]) < TOL
        assert torch.equal(got[0][:, 7], want[0][:, 7]) and torch.equal(got[1], want[1])
        assert int(got[2]) == int(want[2])
        u_d, u_j = u_d + got[0], torch.maximum(u_j, got[1])
    whole = collide.binned_collision_pass(*inputs, 100.0, 8, band_cells=4, packed_caps=caps)
    assert torch.equal(u_d[:, :3], whole[0]) and torch.equal(u_d[:, 3:6], whole[1])
    assert torch.equal(u_d[:, 6], whole[2]) and torch.equal(u_j, whole[3]["j"])


@pytest.mark.parametrize("force", ["pm", "auto"])
def test_sharded_granular_steps_on_card_match_cpu(dev, force):
    """The sharded granular step at world size 1 on a CUDA mesh and a CPU
    mesh of one process, with the same fracture uniforms: counters,
    partners and materials exactly, floats to 1e-4; one step free of host
    syncs."""
    from nbx_torch.bench.granular import bench_config
    from nbx_torch.parallel import shard

    n, box = 4096, 100.0 * (4096 / 131072) ** (1.0 / 3.0)
    pos, vel, mass = granular_cloud(n, seed=0, box=box)
    cfg = bench_config()
    with shard.local_world("cpu:gloo,cuda:nccl"):
        meshes = [shard.make_mesh(device_type=t) for t in ("cuda", "cpu")]
        steps = [shard.make_sharded_granular_step(m, cfg, box, 16, 4, (96, 104), force_impl=force, pm_grid=64)
                 for m in meshes]
        a, b = (shard.shard_body_state(m, pos, vel, mass) for m in meshes)
        gen = torch.Generator().manual_seed(3)
        for _ in range(3):
            d = draw_fracture_uniforms(cfg, gen, "cpu")
            a, ca = steps[0](a, cfg.dt, d.to(dev))
            b, cb = steps[1](b, cfg.dt, d)
            assert {k: int(v) for k, v in ca.items()} == {k: int(v) for k, v in cb.items()}
        assert torch.equal(a.partner.cpu(), b.partner) and torch.equal(a.mat.cpu(), b.mat)
        for f in ("pos", "vel", "acc", "mass", "temp", "contact_t"):
            assert _rel_err(getattr(a, f).cpu(), getattr(b, f)) < 1e-4, f
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            a, _ = steps[0](a, cfg.dt)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(a.pos).all()


# ---- the precision variants of K1: K1a "f32", K1b "fast", K1d "hyb", K1e "bf16", K1c "mxu"
# Bars, max|kernel - plain| / max|plain| (VARIANT_TOL, shared with chip_smoke.py): 1e-6
# for "f32" and "hyb", measured bitwise (0), and both are held bitwise (BITWISE): their
# plain versions round every product and sum where the kernels round them and sum in the
# kernels' order (a tile's lanes in turn, then the tiles of a run, then the runs), and
# torch.rsqrt on the card is rsqrtf; their cancellations (o - p_i sum f m,
# s - (p_i - c) sum w) would turn any other order into a few ulps of the self pair's term,
# up to 1e-3 of max|acc|. 1e-5 for "bf16", measured at most 1.06e-6 before its packed,
# split kernel: its plain version sums its rows in torch's order, and nothing there cancels. "fast" and "mxu" sum their bf16 products on
# the tensor cores, in their own order: 2e-3 where targets are sources (the self pair's
# term cancels in o_xyz - p_i o_w, in tmp_xyz - (p_i - c) tmp_w), 1e-4 where they are not
# (variant_tol; PRECISION_SHAPES draw their targets apart from the sources). The ladder
# (LADDER): against a float64 sum on tests/test_tpu_only.py's _rand(2048, seed=1), bf16's
# error also > 0; fast's and mxu's bodies' errors at the median and the 99th percentile
# within 1.1x of their plain version's, either way (chip_smoke.ladder_ratios). K1 "f32r"
# and every variant split their sources (pairwise.source_splits; K1 at its own bar,
# VARIANT_TOL["f32r"] = 1e-5); the same inputs give the same bits.

PRECISION_SHAPES = [(4096, 4096), (1000, 4096), (777, 3001), (1, 300), (257, 255)]


def _precision_wrapper(precision):
    return getattr(pairwise, f"pairwise_acc_{precision}")


@pytest.mark.parametrize("precision", VARIANTS)
@pytest.mark.parametrize("nt,ns", PRECISION_SHAPES)
def test_precision_kernel_matches_plain(dev, precision, nt, ns):
    pos, mass = _rand(ns, ns, dev)
    tgt, _ = _rand(nt, nt + 1, dev)
    wrapper = _precision_wrapper(precision)
    before, k1 = wrapper.launches, pairwise.pairwise_acc.launches
    got = pairwise.pairwise_acc(pos, mass, 0.5, 0.5, tgt, precision)
    assert (wrapper.launches, pairwise.pairwise_acc.launches) == (before + 1, k1)
    want = pairwise.pairwise_acc_reference(pos, mass, 0.5, 0.5, tgt, precision=precision)
    assert _rel_err(got, want) < variant_tol(precision, self_pairs=False)


@pytest.mark.parametrize("precision", VARIANTS)
def test_precision_kernel_on_the_cold_collapse_disk(dev, precision):
    """The 262,144-body disk of `bench throughput`, its first 4,096 targets."""
    sc = scene.cold_collapse_disk(n=262144, seed=0)
    pos, mass = torch.tensor(sc["pos"], device=dev), torch.tensor(sc["mass"], device=dev)
    got = pairwise.pairwise_acc(pos, mass, 0.5, 0.5, pos[:4096], precision)
    want = pairwise.pairwise_acc_reference(pos, mass, 0.5, 0.5, pos[:4096], precision=precision)
    assert _rel_err(got, want) < VARIANT_TOL[precision]


@pytest.mark.parametrize("precision", VARIANTS)
def test_precision_kernel_mass_zero_padding_is_inert(dev, precision):
    """Mass-0 sources match the plain version; at the origin, where `nbx`
    and the plain version pad, they add nothing. (Elsewhere they move the
    tile centroids of "fast" and "hyb", and so their roundings: 1.6e-3 of
    max|acc| for "fast" on this scene, a few ulps of its cancelling sum.)"""
    pos, mass = _rand(3000, 7, dev)
    padded = mass.clone()
    padded[1500:] = 0.0
    got = pairwise.pairwise_acc(pos, padded, 0.5, 0.5, precision=precision)
    assert _rel_err(got, pairwise.pairwise_acc_reference(pos, padded, 0.5, 0.5, precision=precision)) < \
        VARIANT_TOL[precision]
    at_origin = pos.clone()
    at_origin[1500:] = 0.0
    got = pairwise.pairwise_acc(at_origin, padded, 0.5, 0.5, pos[:1500], precision)
    want = pairwise.pairwise_acc_reference(pos[:1500], mass[:1500], 0.5, 0.5, precision=precision)
    assert _rel_err(got, want) < VARIANT_TOL[precision]


@pytest.mark.parametrize("precision", VARIANTS)
def test_precision_kernel_error_ladder(dev, precision):
    pos, mass = _rand(2048, 1, dev)
    p, m = pos.double(), mass.double()
    d = p[None] - p[:, None]
    want = 0.5 * ((m[None] * ((d * d).sum(-1) + 0.25) ** -1.5)[..., None] * d).sum(1)
    got = pairwise.pairwise_acc(pos, mass, 0.5, 0.5, precision=precision)
    err = _rel_err(got.double(), want)
    assert 0 < err < LADDER[precision] if precision == "bf16" else err < LADDER[precision]
    if precision in TENSOR_CORE_VARIANTS:
        plain = pairwise.pairwise_acc_reference(pos, mass, 0.5, 0.5, precision=precision)
        assert within_ladder(ladder_ratios(got, plain, want))


# (nt, ns): one tile (S = 1), S = 16 of one tile each, 27 runs of 3 tiles and 1
BITWISE_SPLIT_SHAPES = [(777, 255), (4096, 4096), (SHORT_LAST_SPLIT_N, SHORT_LAST_SPLIT_N)]


def _bitwise_at_split(dev, precision, nt, ns):
    pos, mass = _rand(ns, 11, dev)
    tgt, _ = _rand(nt, 12, dev)
    s = pairwise.source_splits(nt, ns, pairwise.SPLIT_KERNELS[precision][0])
    assert (s == 1) == (ns <= pairwise.TILE)
    got = pairwise.pairwise_acc(pos, mass, 0.5, 0.5, tgt, precision)
    assert torch.equal(got, pairwise.pairwise_acc_reference(pos, mass, 0.5, 0.5, tgt, precision=precision))


@pytest.mark.parametrize("nt,ns", BITWISE_SPLIT_SHAPES)
def test_hyb_kernel_is_bitwise_its_plain_version_at_every_split(dev, nt, ns):
    _bitwise_at_split(dev, "hyb", nt, ns)


@pytest.mark.parametrize("nt,ns", BITWISE_SPLIT_SHAPES)
def test_f32_kernel_is_bitwise_its_plain_version_at_every_split(dev, nt, ns):
    _bitwise_at_split(dev, "f32", nt, ns)


@pytest.mark.parametrize("precision", list(pairwise.SPLIT_KERNELS))
def test_split_kernel_with_a_shorter_last_split_matches_plain(dev, precision):
    n = SHORT_LAST_SPLIT_N
    s = pairwise.source_splits(n, n, pairwise.SPLIT_KERNELS[precision][0])
    assert s > 1 and s * pairwise.split_tiles(n, s) > -(-n // pairwise.TILE)
    pos, mass = _rand(n, 13, dev)
    got = pairwise.pairwise_acc(pos, mass, 0.5, 0.5, precision=precision)
    assert _rel_err(got, pairwise.pairwise_acc_reference(pos, mass, 0.5, 0.5, precision=precision)) < \
        VARIANT_TOL[precision]


@pytest.mark.parametrize("precision", list(pairwise.SPLIT_KERNELS))
def test_split_kernel_below_flt_min_takes_rsqrtf(dev, precision):
    """softening 1e-20: eps^2 = 1e-40 is subnormal, so the kernels take
    rsqrtf, not rsqrt.approx.ftz; the targets 300 away from the sources in
    each coordinate, so that no near pair goes unsoftened."""
    pos, mass = _rand(4096, 15, dev)
    tgt, _ = _rand(1000, 16, dev)
    tgt += 300.0
    got = pairwise.pairwise_acc(pos, mass, 0.5, 1e-20, tgt, precision)
    want = pairwise.pairwise_acc_reference(pos, mass, 0.5, 1e-20, tgt, precision=precision)
    assert torch.isfinite(got).all() and _rel_err(got, want) < variant_tol(precision, self_pairs=False)
    assert precision not in BITWISE or torch.equal(got, want)


@pytest.mark.parametrize("precision", list(pairwise.SPLIT_KERNELS))
@pytest.mark.parametrize("n", [4096, 16384])
def test_split_kernel_gives_the_same_bits_twice(dev, precision, n):
    """No atomics: two launches on the same inputs agree bitwise (16,384:
    the drift gate's sphere, S > 1)."""
    pos, _, mass, G, eps, _ = drift.gate_scene(n, device=dev)
    assert pairwise.source_splits(n, n, pairwise.SPLIT_KERNELS[precision][0]) > 1
    first = pairwise.pairwise_acc(pos, mass, G, eps, precision=precision)
    assert torch.equal(first, pairwise.pairwise_acc(pos, mass, G, eps, precision=precision))


@pytest.mark.parametrize("precision", VARIANTS)
def test_precision_wrappers_reject_bad_inputs(dev, precision):
    pos, mass = _rand(64, 8, dev)
    with pytest.raises(TypeError):
        pairwise.pairwise_acc(pos.double(), mass.double(), 0.5, 0.5, precision=precision)
    with pytest.raises(ValueError):
        pairwise.pairwise_acc(pos, mass.cpu(), 0.5, 0.5, precision=precision)
    with pytest.raises(ValueError):
        pairwise.pairwise_acc(pos, mass[:10], 0.5, 0.5, precision=precision)
    with pytest.raises(ValueError):
        pairwise.pairwise_acc(pos, mass, 0.5, 0.5, pos[:, :2], precision)
    with pytest.raises(ValueError):
        pairwise.pairwise_acc(pos, mass, 0.5, 0.0, precision=precision)
    with pytest.raises(ValueError, match="precision"):
        pairwise.pairwise_acc(pos, mass, 0.5, 0.5, precision="tf32")


@pytest.mark.parametrize("precision", VARIANTS)
def test_precision_drift_chunk_makes_no_host_sync(dev, precision):
    pos, vel, mass, G, eps, h = drift.gate_scene(2048, device=dev)
    drift.drift_run(pos, vel, mass, G, eps, h, 0, precision=precision)  # warm-up: kernel load
    torch.cuda.synchronize()
    before = _precision_wrapper(precision).launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, _, e = drift.drift_run(pos, vel, mass, G, eps, h, 20, 10, precision)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(e).all() and _precision_wrapper(precision).launches == before + 21


# ---- K2 as the layout probes launch it (bench/layoutsplit.py, bench/layoutvar.py) ---------

@pytest.mark.parametrize("n,cfg", [(131072, (32, 8)), (262144, (40, 8))])
def test_probe_kernel_matches_plain_and_blocks_are_bitwise_desc(dev, n, cfg):
    """Bucket 0 of the probes' cloud: the kernel against its plain version
    (deltas to 1e-5, bounce counts and partners exact), one launch; the
    "blocks" layout bitwise the "desc" layout."""
    g, band = cfg
    pos, vel, mass, radius, box, buckets = layoutsplit.scene(n, g, band, dev)
    b = layoutsplit.build(pos, vel, mass, radius, box, g, band, buckets[0])
    before = collide.collide_fused.launches
    got_d, got_j = layoutsplit.launch(b, n)
    assert collide.collide_fused.launches == before + 1
    want_d, want_j = layoutsplit.launch(b, n, collide.collide_fused_reference)
    assert _rel_err(got_d[:, :7], want_d[:, :7]) < TOL
    assert torch.equal(got_d[:, 7], want_d[:, 7]) and torch.equal(got_j, want_j)
    assert int(got_d[:, 7].sum()) > 0
    desc = layoutvar.once(pos, vel, mass, radius, box, g, band, buckets[0], "desc")
    blocks = layoutvar.once(pos, vel, mass, radius, box, g, band, buckets[0], "blocks")
    assert all(torch.equal(x, y) for x, y in zip(desc, blocks))


# --- the strict-sequential sweep and the two-level P3M residual ---------------

@pytest.mark.parametrize("name", list(sequential_scenes()))
def test_sequential_sweep_matches_plain(dev, name):
    """The sweep kernel against its plain version on each scene of
    chip_smoke's phase 27 (the escape scenes too): bitwise, and so every
    float within 1e-5 of its field's largest magnitude, counters, flags and
    materials exact."""
    cfg, sc, timers = sequential_scenes()[name]
    cfg = cfg.to(dev)
    inputs = sweep_inputs(cfg, sc, timers, dev)
    h = sim.substep_size(cfg)
    before = sequential.sweep.launches
    got = sequential.sweep(*inputs, h, cfg)
    assert sequential.sweep.launches == before + 1
    err, bitwise, bad = sweep_diff(got, sequential.sweep_reference(*inputs, h, cfg))
    assert not bad, (bad, err)
    assert bitwise, err


def test_sequential_sweep_launches_no_fill(dev):
    """A call launches the pre-pass and the walk, and no fill kernel: the
    pre-pass zeroes the timers and the record buffers."""
    from chip_smoke import sweep_call_kernels

    names = sweep_call_kernels()
    assert len(names) == 2 and "near_kernel" in names[0] and "walk_kernel" in names[1], names


def test_sequential_sweep_gives_the_same_bits_twice(dev):
    cfg, sc, timers = sequential_scenes()["4,096-body pile"]
    cfg = cfg.to(dev)
    inputs = sweep_inputs(cfg, sc, timers, dev)
    a = sequential.sweep(*inputs, 0.008, cfg)
    assert sweep_diff(a, sequential.sweep(*inputs, 0.008, cfg))[1]


def test_sequential_sweep_capacity_limit_raises(dev):
    cfg = SimConfig(capacity=sequential.MAX_CAPACITY + 1).to(dev)
    with pytest.raises(ValueError, match="at most"):
        sequential.sweep(*sweep_inputs(cfg, lattice_pile(2)[0], None, dev), 0.008, cfg)
    with pytest.raises(ValueError, match="collision_impl"):
        sim.step(scene.make_state(cfg, lattice_pile(2)[0], dev), cfg, collision_impl="jacobi2")


def test_sequential_frames_on_card_match_cpu(dev):
    """The reference scene, 10 frames of the sequential step on the card
    and on the CPU with the same fracture draws: slots and event counts
    exactly, floats to 1e-4 (gravity sums in another order)."""
    cfg = SimConfig()
    sc = scene.reference_galaxy(seed=0)
    a, b = scene.make_state(cfg.to(dev), sc, dev), scene.make_state(cfg, sc, "cpu")
    h = sim.substep_size(cfg)
    gen = torch.Generator().manual_seed(3)
    for _ in range(10 * cfg.sub_steps):
        d = draw_fracture_uniforms(cfg, gen, "cpu")
        a, ea = sim.substep(a, cfg.to(dev), h, draws=d.to(dev), collision_impl="sequential")
        b, eb = sim.substep(b, cfg, h, draws=d, collision_impl="sequential")
        for f in ("n_merges", "n_fractures", "n_bounces", "n_evicted", "n_dropped"):
            assert int(getattr(ea, f)) == int(getattr(eb, f)), f
    assert torch.equal(a.alive.cpu(), b.alive) and torch.equal(a.seq.cpu(), b.seq)
    for f in ("pos", "vel", "temp", "contact"):
        assert _rel_err(getattr(a, f).cpu(), getattr(b, f)) < 1e-4, f


def test_twolevel_p3m_on_card_matches_cpu(dev):
    """p3m_acceleration(residual_mode="twolevel") with K4 and K5 on a
    4,096-body cluster (phase 28's), card against CPU."""
    pos, mass, _ = p3m_cluster.cluster_scene(4096, 1024)
    before = ppkernel.pp_short.launches, ppkernel.pp_react.launches
    got, unc = p3m.p3m_acceleration(torch.from_numpy(pos).to(dev), torch.from_numpy(mass).to(dev), 1.0,
                                    p3m_cluster.BOX, **TWOLEVEL_SMALL)
    assert (ppkernel.pp_short.launches, ppkernel.pp_react.launches) == (before[0] + 1, before[1] + 1)
    want, w_unc = p3m.p3m_acceleration(torch.from_numpy(pos), torch.from_numpy(mass), 1.0, p3m_cluster.BOX,
                                       **TWOLEVEL_SMALL)
    assert int(unc) == int(w_unc) == 0
    assert _rel_err(got.cpu(), want) < 1e-4
