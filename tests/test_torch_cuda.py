"""The port's CUDA kernels on the card: each held against its plain PyTorch
version, the frame step and the at-scale granular step on the card against
the same steps on the CPU, and the steps free of host syncs (P3M's too).

Marked `cuda`: every test skips where torch sees no CUDA device. On a
machine with a card (nvcc on PATH or under CUDA_HOME; no JAX needed):

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from nbx_torch import collisions_scaled, scene, sim
from nbx_torch.bench.granular import granular_cloud
from nbx_torch.bench.pp_scenes import MAIN_CASES, RESIDUAL_CASES, main_case, residual_case
from nbx_torch.collisions import draw_fracture_uniforms
from nbx_torch.config import SimConfig, body_radius
from nbx_torch.ops import collide, p3m, pairwise, ppkernel
from nbx_torch.ops.pm import isolated_green_hat

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
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("nt,ns", [(4096, 4096), (1000, 4096), (777, 3001), (1, 300), (257, 255)])
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
        with pytest.raises((TypeError, ValueError)):
            collide.collide_fused(*args[:i], bad, *args[i + 1:])


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
    """K5 (row sums) against its plain version (column sums) and K4 on the
    residual-residual block; n_missed equal on the card and the CPU."""
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
