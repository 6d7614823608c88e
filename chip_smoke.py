#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (`nbx_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `nbx_torch/csrc/` and drives the port's
three paths through their public entry points: the frame step
(`scene.make_state`, `sim.run`, `diagnostics.measure`), the at-scale
granular step (`collisions_scaled.granular_full_kdk_scan`) and P3M gravity
(`ops.p3m.p3m_acceleration`, and the granular step with force_impl="p3m"):

  0. device: name and power limit; TF32 off
  1. build: nvcc every kernel (sm_90a) at once, print ptxas' resource reports
  2. the gravity kernel against its plain PyTorch version on the card, at
     N = 4,096, rectangular and ragged shapes, mass-0 padding, and the
     N = 262,144 cold-collapse disk; times both at N = 262,144
  3. the reference scene at the reference size (capacity 300, full physics,
     300 frames), plus 20 frames held against the same frames on the CPU
  4. full physics with the kernel: capacity 4,096, 50 frames; one more frame
     under torch.cuda.set_sync_debug_mode("error")
  5. gravity only at N = 262,144: 5 frames, momentum conservation
  6. the collision kernel against its plain PyTorch version on the card: the
     clustered 192-body scene, the same under budgets that overflow, and the
     131,072-body cloud of the live server; times both at 131,072
  7. the at-scale granular step at the live server's configuration (131,072
     bodies, g = 40, B = 12, PM gravity on a 64^3 mesh): 50 frames of
     granular_full_kdk_scan(n_steps=1, log_events=True), buckets re-sized
     every 5 frames as the cloud collapses, one more under
     set_sync_debug_mode("error"), then 3 steps at N = 4,096 held against the
     same steps on the CPU
  8. the P3M pair kernels K4 and K5 against their plain PyTorch versions on
     the card, on the arguments each pass gives them: the small scenes of
     tests/test_ppkernel.py, then the 1M + 30k-core scene at the production
     tune at full width (main pass, residual table, residual-residual
     block), each timed
  9. p3m_acceleration at the production tune on that scene: ms per
     evaluation, launches per evaluation, n_uncorrected == 0, the median
     error against the direct sum (K1) below plain PM's in the core and the
     field, one evaluation under set_sync_debug_mode("error")
 10. the 1,048,576-body galaxy merger step of examples/merger_full.py with
     P3M gravity at its scene-census tune: K4 and K5 against their plain
     versions on the arguments the scene's first force evaluation gives
     them (the two-bucket main pass, the residual-residual block, the
     residual table at its affected_cap), each timed; 1 warm-up frame and 2
     timed frames of 2 steps, n_overflow == n_uncorrected == 0, one frame
     under set_sync_debug_mode("error"); then 2 steps at N = 4,096 with P3M
     parameters that overflow, held against the same steps on the CPU

Every phase raises on failure, so the script exits non-zero; it needs a CUDA
device and has no CPU fallback. The line before the last is the kernels'
JSON record: each kernel's launches on its path, its error against its plain
version (the largest over every check), its time and its plain version's
time at that path's shapes, and its bound (the largest of the bytes over
3.35 TB/s, the FP32 operations over 67 TFLOP/s, the H100 SXM data sheet's
rates, and the special functions over the SFU's 16 per clock per SM,
counted from this run's inputs). K4 and K5 are recorded on the merger
step's path (phase 10). The last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import time

import numpy as np
import torch

from nbx_torch import collisions_scaled, diagnostics, scene, sim
from nbx_torch.bench import p3m_cluster, pp_scenes
from nbx_torch.bench.granular import BOX, granular_cloud
from nbx_torch.collisions import draw_fracture_uniforms
from nbx_torch.config import SimConfig, body_radius
from nbx_torch.ops import _build, collide, p3m, ppkernel
from nbx_torch.ops.pairwise import pairwise_acc, pairwise_acc_reference
from nbx_torch.ops.pm import isolated_green_hat, out_of_box_count, pm_acceleration

KERNEL_TOL = 1e-5  # max|kernel - plain| / max|plain|, the bar of tests/test_tpu_only.py
HEADLINE_N = 262_144
SCALED_N = 131_072  # the at-scale live server's default body count
MERGER_N = 1_048_576  # examples/merger_full.py's galaxy merger

# The card's peak rates for the bounds (H100 SXM data sheet, dense, 700 W).
FP32_PEAK = 67e12  # FP32 operations per second outside the tensor cores
HBM_PEAK = 3.35e12  # bytes per second
# Special-function (MUFU) results per second: 16 per clock per SM, 132 SMs at
# the 1.98 GHz boost clock behind the FP32 peak (132 x 128 lanes x 2 x 1.98e9).
SFU_PEAK = 132 * 16 * 1.98e9
# Per pair, counted from each kernel's source: FP32 operations (_OPS) and
# special functions on the SFU (_SFU). K1: 3 differences, r^2 (5), + eps^2,
# m/r^3 (3), the sum (6); one rsqrt. K2's overlap test on every source lane:
# 3 differences, r^2 (5), r_i + r_j, its square, the compare; none. The P3M
# law of csrc/pp_law.cuh: 3 differences, r^2 (5), s^2, s, x, x^2, 1 + p x (2),
# the polynomial (8), erfc (2), the weight (6), the sum (6); rsqrt, exp and
# the reciprocal. K5's function also takes the reaction (the weight times m_t
# and a second sum, 7) from the same pair, with no further special function.
K1_PAIR_OPS, K1_PAIR_SFU = 18, 1
K2_LANE_OPS = 11
PP_PAIR_OPS, PP_PAIR_SFU = 36, 3
PP_REACT_PAIR_OPS = PP_PAIR_OPS + 7


def bound(ops: float, sfu: float, nbytes: float) -> dict:
    """The least time the card could take: the largest of the FP32
    operations over the FP32 peak, the special functions over the SFU rate
    and the bytes over the memory rate. bound_by is "operations" for either
    of the first two; `pipe` names the term (FP32, SFU or HBM)."""
    times = {"FP32": ops / FP32_PEAK * 1e3, "SFU": sfu / SFU_PEAK * 1e3, "HBM": nbytes / HBM_PEAK * 1e3}
    pipe = max(times, key=times.get)
    return dict(bound_ms=times[pipe], bound_by="bytes" if pipe == "HBM" else "operations", pipe=pipe)


def bound_text(b: dict) -> str:
    return f"bound {b['bound_ms']:.4f} ms ({b['bound_by']}: {b['pipe']})"


def record(b: dict) -> dict:
    """A bound's keys of the kernels line."""
    return dict(bound_ms=b["bound_ms"], bound_by=b["bound_by"])


def log(phase: int, msg: str) -> None:
    print(f"[phase {phase}] {msg}", flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def all_finite(*tensors) -> bool:
    return all(bool(torch.isfinite(t).all()) for t in tensors if t is not None)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of fn on the card, by CUDA events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def rand_bodies(n: int, seed: int, dev):
    """The `_rand` of tests/test_tpu_only.py."""
    rng = np.random.default_rng(seed)
    pos = torch.tensor(rng.normal(size=(n, 3)) * 20, dtype=torch.float32, device=dev)
    mass = torch.tensor(rng.uniform(0.5, 5, n), dtype=torch.float32, device=dev)
    return pos, mass


def compare(name: str, got: torch.Tensor, want: torch.Tensor, phase: int = 2) -> float:
    abs_err = float((got - want).abs().max())
    rel = abs_err / max(float(want.abs().max()), 1e-30)
    log(phase, f"{name}: max|kernel-plain|={abs_err:.3e} rel={rel:.3e} (tol {KERNEL_TOL:g})")
    check(rel < KERNEL_TOL, f"{name}: relative error {rel} >= {KERNEL_TOL}")
    return abs_err


def phase_device() -> str:
    check(torch.cuda.is_available(), "torch.cuda.is_available() (this script needs a CUDA device)")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmul off")
    check(not torch.backends.cudnn.allow_tf32, "TF32 cuDNN off")
    log(0, f"device {name}; torch {torch.__version__} cuda {torch.version.cuda}; TF32 off")
    print(smi, flush=True)
    return name


def phase_build() -> None:
    t0 = time.perf_counter()
    libs = _build.build_all()
    for name in _build.KERNELS:
        _build.load(name)
    log(1, f"built {len(libs)} kernels in parallel in {time.perf_counter() - t0:.2f} s")
    for lib in libs:
        log(1, f"{lib.relative_to(_build.BUILD_DIR.parent.parent)}")
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(1, f"ptxas: {line.strip()}")


def phase_kernel(dev, n_big: int = HEADLINE_N) -> dict:
    G, eps = 0.5, 0.5
    pos, mass = rand_bodies(4096, 0, dev)
    compare("N=4096 random", pairwise_acc(pos, mass, G, eps), pairwise_acc_reference(pos, mass, G, eps))
    tgt = pos[37:1037]
    compare("1000 targets x 4096 sources",
            pairwise_acc(pos, mass, G, eps, tgt), pairwise_acc_reference(pos, mass, G, eps, tgt))
    src, m_src = rand_bodies(3001, 1, dev)
    tgt, _ = rand_bodies(777, 2, dev)
    compare("777 targets x 3001 sources (ragged)",
            pairwise_acc(src, m_src, G, eps, tgt), pairwise_acc_reference(src, m_src, G, eps, tgt))
    m_pad = mass.clone()
    m_pad[2048:] = 0.0
    compare("mass-0 padding inert",
            pairwise_acc(pos, m_pad, G, eps)[:2048],
            pairwise_acc_reference(pos[:2048], mass[:2048], G, eps))

    cfg = SimConfig()
    sc = scene.cold_collapse_disk(n=n_big, seed=0)
    pos = torch.tensor(sc["pos"], device=dev)
    mass = torch.tensor(sc["mass"], device=dev)
    got = pairwise_acc(pos, mass, cfg.G, cfg.softening)
    want = pairwise_acc_reference(pos, mass, cfg.G, cfg.softening, pos[:4096])
    err = compare(f"N={n_big} cold_collapse_disk, first 4096 targets", got[:4096], want)
    check(all_finite(got), f"kernel output finite at N={n_big}")

    ms = cuda_ms(lambda: pairwise_acc(pos, mass, cfg.G, cfg.softening), 5)
    plain_ms = cuda_ms(lambda: pairwise_acc_reference(pos, mass, cfg.G, cfg.softening), 1)
    rate = n_big**2 / (ms * 1e-3)
    b = bound(n_big * n_big * K1_PAIR_OPS, n_big * n_big * K1_PAIR_SFU, n_big * (12 + 4 + 12))
    log(2, f"N={n_big}: kernel {ms:.3f} ms ({rate:.4e} pairs/s), plain {plain_ms:.3f} ms, "
           f"plain/kernel {plain_ms / ms:.2f}x; {bound_text(b)}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, **record(b), library_ms=None)


def phase_reference(dev, frames: int = 300) -> None:
    cfg = SimConfig().to(dev)
    sc = scene.reference_galaxy(seed=0)
    st = scene.make_state(cfg, sc, dev, seed=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, evs = sim.run(st, cfg, frames)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    check(all_finite(st.pos, st.vel, st.acc, st.mass, st.temp, st.contact), f"state finite after {frames} frames")
    n_alive = int(st.n_alive)
    check(1 <= n_alive <= cfg.capacity, f"1 <= n_alive={n_alive} <= {cfg.capacity}")
    log(3, f"capacity 300, {frames} frames in {dt:.3f} s ({dt / frames * 1e3:.3f} ms/frame); n_alive {n_alive}; "
           f"merges {int(evs.n_merges.sum())} fractures {int(evs.n_fractures.sum())} "
           f"bounces {int(evs.n_bounces.sum())} evicted {int(evs.n_evicted.sum())} "
           f"dropped {int(evs.n_dropped.sum())}")

    # The same 20 frames on the card and on the CPU, with the same fracture
    # draws: float32 summation order differs, slots and events must not.
    cpu_cfg = SimConfig()
    a, b = scene.make_state(cfg, sc, dev), scene.make_state(cpu_cfg, sc, "cpu")
    h = sim.substep_size(cfg)
    gen = torch.Generator().manual_seed(1)
    for _ in range(20 * cfg.sub_steps):
        d = draw_fracture_uniforms(cpu_cfg, gen, "cpu")
        a, ea = sim.substep(a, cfg, h, draws=d.to(dev))
        b, eb = sim.substep(b, cpu_cfg, h, draws=d)
        for f in ("n_merges", "n_fractures", "n_bounces", "n_evicted", "n_dropped"):
            check(int(getattr(ea, f)) == int(getattr(eb, f)), f"{f} equal on card and CPU")
    check(torch.equal(a.alive.cpu(), b.alive) and torch.equal(a.seq.cpu(), b.seq), "slots equal on card and CPU")
    for f in ("pos", "vel", "temp"):
        x, y = getattr(a, f).cpu(), getattr(b, f)
        err = float((x - y).abs().max()) / max(float(y.abs().max()), 1e-30)
        log(3, f"20 frames card vs CPU: {f} max rel err {err:.3e} (tol 1e-3)")
        check(err < 1e-3, f"{f} card vs CPU after 20 frames")


def phase_full_physics(dev, capacity: int = 4096, n_disk: int = 3000, frames: int = 50) -> float:
    cfg = SimConfig(capacity=capacity).to(dev)
    st = scene.make_state(cfg, scene.reference_galaxy(n_disk=n_disk, seed=0), dev, seed=0)
    for _ in range(2):  # warm-up: allocator, kernel load
        st, _ = sim.step(st, cfg)
    torch.cuda.synchronize()

    pairwise_acc.launches = 0  # count the main path's launches from here
    collide.collide_fused.launches = 0
    t0 = time.perf_counter()
    st, evs = sim.run(st, cfg, frames)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    check(pairwise_acc.launches == frames * cfg.sub_steps,
          f"kernel launched {pairwise_acc.launches} times in {frames} frames, want {frames * cfg.sub_steps}")
    check(all_finite(st.pos, st.vel, st.acc, st.mass, st.temp, st.contact), "state finite")
    diag = diagnostics.measure(st, cfg)
    check(all_finite(*(getattr(diag, f.name) for f in dataclasses.fields(diag))), "diagnostics finite")
    log(4, f"capacity {capacity}, {frames} frames: {dt / frames * 1e3:.3f} ms/frame; n_alive {int(st.n_alive)}; "
           f"merges {int(evs.n_merges.sum())} fractures {int(evs.n_fractures.sum())} "
           f"bounces {int(evs.n_bounces.sum())} evicted {int(evs.n_evicted.sum())} "
           f"dropped {int(evs.n_dropped.sum())}; E={float(diag.energy):.6e}")

    before = pairwise_acc.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        st, _ = sim.step(st, cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    check(pairwise_acc.launches - before == cfg.sub_steps, "kernel ran in the sync-checked frame")
    log(4, "one frame ran under set_sync_debug_mode('error'): no host sync in sim.step")
    return dt / frames * 1e3


def phase_headline(dev, n: int = HEADLINE_N, frames: int = 5) -> float:
    cfg = SimConfig(capacity=n, collisions=False).to(dev)
    st = scene.make_state(cfg, scene.cold_collapse_disk(n=n, seed=0), dev, seed=0)

    def momentum(s):
        return (s.mass.double()[:, None] * s.vel.double()).sum(0)

    p0 = momentum(st)
    before = pairwise_acc.launches
    t0 = time.perf_counter()
    st, _ = sim.run(st, cfg, frames)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n_eval = frames * cfg.sub_steps
    check(pairwise_acc.launches - before == n_eval, f"kernel launched {n_eval} times in {frames} frames")
    check(all_finite(st.pos, st.vel), "positions and velocities finite")
    drift = float((momentum(st) - p0).norm()) / float((st.mass.double() * st.vel.double().norm(dim=1)).sum())
    log(5, f"N={n} gravity only, {frames} frames: {dt / n_eval * 1e3:.3f} ms per force evaluation "
           f"(frame wall time / substeps); |dP| / sum m|v| = {drift:.3e} (tol 1e-5)")
    check(drift < 1e-5, "momentum conserved")
    return dt / n_eval * 1e3


def clustered_scene(n: int = 192, seed: int = 7):
    """The clustered scene of tests/test_collisions_scaled.py: a uniform
    background and a dense clump, so windows land in both buckets."""
    rng = np.random.default_rng(seed)
    n_bg = n * 2 // 3
    bg = rng.uniform(10, 90, (n_bg, 3))
    clump = rng.normal(35.0, 2.5, (n - n_bg, 3))
    pos = np.clip(np.concatenate([bg, clump]), 1.0, 99.0).astype(np.float32)
    vel = rng.normal(0, 1.0, (n, 3)).astype(np.float32)
    mass = rng.uniform(2.0, 8.0, n).astype(np.float32)
    return pos, vel, mass


def collide_inputs(pos, vel, mass, radius_scale, dev):
    t = [torch.tensor(x, device=dev) for x in (pos, vel, mass)]
    radius = body_radius(t[2], torch.zeros_like(t[2], dtype=torch.int32),
                         SimConfig().to(dev).materials) * radius_scale
    return (*t, radius)


def collide_both(inputs, box, g, b, buckets):
    """The bucketed pass through the kernel and through its plain version."""
    args = (*inputs, box, g, b, buckets, 0.2, 0.5)
    return (collide._bucketed_pass(*args, collide.collide_fused),
            collide._bucketed_pass(*args, collide.collide_fused_reference))


def check_collide(name, got, want) -> float:
    """Deltas to KERNEL_TOL of each field's largest magnitude; partners,
    bounces, overflow and the cell-size flag exactly."""
    err = 0.0
    for i, field in enumerate(("dvel", "dpos", "dtemp")):
        abs_err = compare(f"{name} {field}", got[i], want[i], phase=6)
        err = max(err, abs_err)
    check(torch.equal(got[3]["j"], want[3]["j"]), f"{name}: partners equal")
    for i, field in ((4, "n_bounces"), (5, "n_overflow"), (6, "cell_too_small")):
        check(int(got[i]) == int(want[i]), f"{name}: {field} equal ({int(got[i])} vs {int(want[i])})")
    log(6, f"{name}: partners equal ({int((got[3]['j'] >= 0).sum())} bodies with one), "
           f"n_bounces {int(got[4])}, n_overflow {int(got[5])}, cell_too_small {bool(got[6])}")
    return err


def phase_collide_kernel(dev, n_big: int = SCALED_N) -> dict:
    pos, vel, mass = clustered_scene()
    inputs = collide_inputs(pos, vel, mass, 2.0, dev)
    buckets = collide.bucketed_layout_for(pos, BOX, 8, 4, split_quantile=0.6)
    err = check_collide(f"clustered n=192 g=8 B=4 buckets={buckets}", *collide_both(inputs, BOX, 8, 4, buckets))
    tiny = ((24, 64, 8), (128, 256, 8))
    inputs = collide_inputs(pos, vel, mass, 4.0, dev)
    got, want = collide_both(inputs, BOX, 8, 4, tiny)
    err = max(err, check_collide(f"clustered n=192, radius x4, tiny budgets {tiny}", got, want))
    check(int(got[5]) > 0, "the tiny budgets overflow")

    box = BOX * (n_big / SCALED_N) ** (1.0 / 3.0)
    pos, vel, mass = granular_cloud(n_big, seed=0, box=box)
    buckets = collide.bucketed_layout_for(pos, box, 40, 12)
    inputs = collide_inputs(pos, vel, mass, 1.0, dev)
    got, want = collide_both(inputs, box, 40, 12, buckets)
    err = max(err, check_collide(f"granular_cloud n={n_big} g=40 B=12 buckets={buckets}", got, want))
    check(int(got[4]) > 0 and int(got[5]) == 0, "contacts found, nothing overflows")

    # time the kernel launches of one pass (every bucket) against the plain
    # version on the same layout
    p, v, m, r = inputs
    order, starts, cid = collide.cell_sort(p, box, 40)
    feats = torch.cat([p, v, m[:, None], r[:, None]], dim=1)[order.long()]
    windows, t_ok, _ = collide._bucket_windows(starts, cid, n_big, 40, 12, buckets)
    out_d = torch.zeros((n_big, 8), device=dev)
    out_j = torch.full((n_big,), -1, dtype=torch.int32, device=dev)

    def run(fused):
        for win, t_rows, s_capw in windows:
            fused(feats, order, t_ok, win, out_d, out_j, 0.2, 0.5, t_rows, s_capw)

    run(collide.collide_fused)  # warm-up
    ms = cuda_ms(lambda: run(collide.collide_fused), 5)
    plain_ms = cuda_ms(lambda: run(collide.collide_fused_reference), 1)
    pass_ms = cuda_ms(lambda: collide.binned_collision_pass(
        p, v, m, r, box, 40, band_cells=12, buckets=buckets), 5)
    lanes = sum(int((w[:, 1].long() * w[:, 3::2].long().sum(1)).sum()) for w, _, _ in windows)
    nbytes = n_big * (32 + 4 + 1 + 32 + 4) + sum(w.numel() * 4 for w, _, _ in windows)
    b = bound(lanes * K2_LANE_OPS, 0, nbytes)
    log(6, f"n={n_big}: kernel {ms:.3f} ms per pass ({len(windows)} launches), plain {plain_ms:.3f} ms, "
           f"plain/kernel {plain_ms / ms:.2f}x; whole binned_collision_pass with the kernel {pass_ms:.3f} ms; "
           f"{lanes} source lanes, {bound_text(b)}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, **record(b), library_ms=None)


def server_setup(dev, n: int = SCALED_N, g: int = 40, b: int = 12, pm_grid: int = 64):
    """BigLiveSim's configuration: the cloud scene, its box, the buckets and
    the Green's-function transform, computed once per scene."""
    box = BOX * (n / SCALED_N) ** (1.0 / 3.0)
    pos, vel, mass = granular_cloud(n, seed=0, box=box)
    st = collisions_scaled.make_granular_state(pos, vel, mass, seed=0, device=dev)
    cfg = SimConfig(G=0.5, dt=0.016, sub_steps=1, merge_time=0.25, fracture_threshold=8.0).to(dev)
    buckets = collide.bucketed_layout_for(pos, box, g, b)
    kw = dict(n_cells=g, band_cells=b, buckets=buckets, force_impl="pm", pm_grid=pm_grid,
              log_events=True, green_hat=isolated_green_hat(box, pm_grid, device=dev))
    return st, cfg, box, kw


# The cloud collapses under its own gravity, and buckets sized once per scene
# (as BigLiveSim sizes them) overflow from about frame 22 on. Phase 7 re-sizes
# them from the current positions every RESIZE_EVERY frames, host-side and
# untimed, with BLOCK_SLACK headroom for the tail bucket's growth in between.
RESIZE_EVERY = 5
BLOCK_SLACK = 2.0


def phase_scaled(dev, frames: int = 50) -> float:
    st, cfg, box, kw = server_setup(dev)
    n = st.pos.shape[0]
    log(7, f"N={n} box={box:g} g={kw['n_cells']} B={kw['band_cells']} buckets={kw['buckets']} "
           f"pm_grid={kw['pm_grid']}")
    for _ in range(2):  # warm-up: allocator, cuFFT plans, kernel load
        st, _, _ = collisions_scaled.granular_full_kdk_scan(st, cfg, box, 1, **kw)
    torch.cuda.synchronize()

    collide.collide_fused.launches = 0  # the at-scale path's launches from here
    pairwise_acc.launches = 0
    totals = []
    want_launches = 0
    dt = 0.0
    for f0 in range(0, frames, RESIZE_EVERY):
        kw["buckets"] = collide.bucketed_layout_for(st.pos.cpu().numpy(), box, kw["n_cells"],
                                                    kw["band_cells"], block_slack=BLOCK_SLACK)
        t0 = time.perf_counter()
        for _ in range(min(RESIZE_EVERY, frames - f0)):  # one scan call per frame, as the server runs it
            st, tot, ev = collisions_scaled.granular_full_kdk_scan(st, cfg, box, 1, **kw)
            totals.append(tot)
            want_launches += len(kw["buckets"])
        torch.cuda.synchronize()
        dt += time.perf_counter() - t0
    check(collide.collide_fused.launches == want_launches,
          f"kernel launched {collide.collide_fused.launches} times in {frames} steps, want {want_launches}")
    check(all_finite(st.pos, st.vel, st.mass, st.temp, st.contact_t), "state finite")
    agg = {k: torch.stack([t[k] for t in totals]) for k in totals[0]}
    n_ovf = int(agg["n_overflow"].max())
    small = bool(agg["cell_too_small"].any())
    n_b = int(agg["n_bounces"].sum())
    check(n_ovf == 0, f"n_overflow {n_ovf} == 0 in every step")
    check(not small, "cell_too_small is False")
    check(n_b > 0, "bounces fired")
    log(7, f"N={n}, {frames} steps: {dt / frames * 1e3:.3f} ms/step; bounces {n_b} "
           f"merges {int(agg['n_merges'].sum())} fractures {int(agg['n_fractures'].sum())} "
           f"dropped {int(agg['n_dropped'].sum())} overflow {n_ovf}; "
           f"alive {int((st.mass > 0).sum())}; out_of_box_count {int(out_of_box_count(st.pos, box))}; "
           f"{collide.collide_fused.launches} kernel launches; last buckets {kw['buckets']}")

    before = collide.collide_fused.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        st, _, _ = collisions_scaled.granular_full_kdk_scan(st, cfg, box, 1, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    check(collide.collide_fused.launches - before == len(kw["buckets"]),
          "kernel ran in the sync-checked step")
    check(pairwise_acc.launches == 0, "PM gravity: the direct-sum kernel did not run")
    log(7, "one step ran under set_sync_debug_mode('error'): no host sync in granular_full_kdk_scan")
    return dt / frames * 1e3


SCALED_CPU_TOL = 1e-4  # card vs CPU: PM's atomic deposit and another FFT library


def phase_scaled_vs_cpu(dev, n: int = 4096, steps: int = 3) -> None:
    a, cfg, box, kw = server_setup(dev, n=n, g=16, b=4, pm_grid=32)
    b, cpu_cfg, _, kw_cpu = server_setup("cpu", n=n, g=16, b=4, pm_grid=32)
    check(kw["buckets"] == kw_cpu["buckets"], "same buckets")
    gen = torch.Generator().manual_seed(3)
    draws = [draw_fracture_uniforms(cpu_cfg, gen, "cpu") for _ in range(steps)]
    a, ta, ea = collisions_scaled.granular_full_kdk_scan(a, cfg, box, steps, draws=[d.to(dev) for d in draws], **kw)
    b, tb, eb = collisions_scaled.granular_full_kdk_scan(b, cpu_cfg, box, steps, draws=draws, **kw_cpu)
    for k in ta:
        check(torch.equal(ta[k].cpu(), tb[k]), f"total {k} equal on card and CPU ({ta[k].tolist()} vs {tb[k].tolist()})")
    for f in ("n_merges", "n_fractures", "n_bounces", "n_overflow", "n_dropped", "merge_mask",
              "fracture_mask", "spawn_mask"):
        check(torch.equal(getattr(ea, f).cpu(), getattr(eb, f)), f"events {f} equal on card and CPU")
    check(torch.equal(a.partner.cpu(), b.partner) and torch.equal(a.mat.cpu(), b.mat),
          "partners and materials equal on card and CPU")
    for f in ("pos", "vel", "mass", "temp", "contact_t"):
        x, y = getattr(a, f).cpu(), getattr(b, f)
        err = float((x - y).abs().max()) / max(float(y.abs().max()), 1e-30)
        log(7, f"N={n}, {steps} steps card vs CPU: {f} max rel err {err:.3e} (tol {SCALED_CPU_TOL:g})")
        check(err < SCALED_CPU_TOL, f"{f} card vs CPU after {steps} steps")
    log(7, f"N={n}: totals {{{', '.join(f'{k}: {int(v)}' for k, v in tb.items())}}} equal on card and CPU")


# ---- P3M: K4 and K5 ------------------------------------------------------------

def residual_inputs(pos, mass, box, g, k, m, sort=None):
    """(res_idx, res_valid, sort) of the bodies past K in their cells."""
    sort = sort if sort is not None else p3m.cell_sort(pos, box, g)
    res_idx, res_valid = p3m.take_rows(p3m.overflowing(sort, k)[1], m)
    return res_idx, res_valid, sort


def check_pass(phase: int, name, wrapper, plain, args, reps: int = 0) -> dict:
    """The kernel against its plain version on the same arguments; with reps,
    the kernel's time by CUDA events (reps launches after a warm-up) and the
    plain version's (one call)."""
    got = wrapper(*args)
    err = compare(name, got, plain(*args), phase=phase)
    out = dict(max_abs_err=err)
    if reps:
        out["ms"] = cuda_ms(lambda: wrapper(*args), reps)
        out["plain_ms"] = cuda_ms(lambda: plain(*args), 1)
    return out


def pp_bounds(phase: int, main_args, table_args) -> tuple[dict, dict]:
    """(K4, K5) bounds of one evaluation's passes, counted from their
    arguments: the kept pairs of the main pass and the live ones of the
    residual passes; each input byte read once, each output written once.
    K4's is that of its two launches' work together."""
    win = main_args[3].long()
    main_pairs = int((win[:, 1] * win[:, 3::2].sum(1)).sum())
    n = main_args[6]
    row_out, aff_len = table_args[1], table_args[5]
    n_live = int((row_out >= 0).sum())
    n_aff = int(aff_len.sum())
    rr_pairs, table_pairs = n_live * n_live, n_live * n_aff
    k4 = bound((main_pairs + rr_pairs) * PP_PAIR_OPS, (main_pairs + rr_pairs) * PP_PAIR_SFU,
               n * (16 + 4 + 12) + win.numel() * 4 + n_live * (16 + 4 + 12))
    k5 = bound(table_pairs * PP_REACT_PAIR_OPS, table_pairs * PP_PAIR_SFU, (n_live + n_aff) * (16 + 4 + 12))
    log(phase, f"pairs: main pass {main_pairs}, residual-residual {rr_pairs}, residual table {table_pairs} "
               f"({n_live} live residuals, {n_aff} kept bodies in the affected cells)")
    return k4, k5


def pp_full_width(phase: int, label: str, pos, mass, G: float, eps: float, box: float, tune: dict,
                  reps: int = 5) -> tuple[dict, dict]:
    """K4 (the main pass and the residual-residual block) and K5 (the
    residual table) on the arguments one P3M evaluation at `tune` (the keys
    of p3m_tune_for) gives them on this scene, each against its plain
    version and timed; every body past K gets its correction (no cell
    dropped, n_missed 0). Returns the kernels-line entries of K4 (per
    evaluation: both launches) and K5, bounds included."""
    g, k = tune["n_cells"], tune["max_per_cell"]
    a = p3m.smoothing_length(box, g)
    ri, rv, sort = residual_inputs(pos, mass, box, g, k, tune["max_residual"])
    main_args, n_ovf = ppkernel._main_pass(pos, mass, G, a, box, g, k, eps, tune.get("pp_buckets"), sort)
    rr_args = ppkernel._rr_pass(pos, mass, G, a, box, ri, rv, eps)
    table_args, n_missed = ppkernel._table_pass(pos, mass, G, a, box, g, k, ri, rv, eps,
                                                tune.get("affected_cap", 256), sort)
    n_past, n_res = int(p3m.overflowing(sort, k)[0]), int(rv.sum())
    n_aff = int((table_args[5] > 0).sum())
    log(phase, f"{label}: g={g} K={k} pp_buckets={tune.get('pp_buckets')}: {n_past} bodies past K, "
               f"{n_res} residuals, {n_aff} affected cells, {main_args[3].shape[0]} main-pass work items, "
               f"n_overflow {int(n_ovf)}, n_missed {int(n_missed)}")
    check(int(n_ovf) == n_past, f"{label}: the main pass drops no cell (n_overflow {int(n_ovf)} == {n_past})")
    check(n_res == n_past and int(n_missed) == 0, f"{label}: every body past K corrected")
    main = check_pass(phase, f"K4 main pass {label}", ppkernel.pp_short, ppkernel.pp_short_reference,
                      main_args, reps)
    rr = check_pass(phase, f"K4 residual-residual {label}", ppkernel.pp_short, ppkernel.pp_short_reference,
                    rr_args, reps)
    table = check_pass(phase, f"K5 residual table {label}", ppkernel.pp_react, ppkernel.pp_react_reference,
                       table_args, reps)
    b4, b5 = pp_bounds(phase, main_args, table_args)
    for name, r in (("K4 main pass", main), ("K4 residual-residual", rr), ("K5 residual table", table)):
        log(phase, f"{label} {name}: kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms")
    log(phase, f"{label}: K4 per evaluation {main['ms'] + rr['ms']:.3f} ms, {bound_text(b4)}; "
               f"K5 {table['ms']:.3f} ms, {bound_text(b5)}")
    k4 = dict(max_abs_err=max(main["max_abs_err"], rr["max_abs_err"]), ms=main["ms"] + rr["ms"],
              plain_ms=main["plain_ms"] + rr["plain_ms"], **record(b4), library_ms=None)
    k5 = dict(max_abs_err=table["max_abs_err"], ms=table["ms"], plain_ms=table["plain_ms"], **record(b5),
              library_ms=None)
    return k4, k5


def phase_pp_kernels(dev, n_big: int = 1_000_000, n_core: int = 30_000) -> tuple[float, float]:
    """K4 and K5 against their plain versions on the small scenes of
    tests/test_ppkernel.py and at the production tune on the 1M + 30k-core
    scene. Returns the largest error of each."""
    cpu = torch.device("cpu")
    err4 = err5 = 0.0
    for case, name in pp_scenes.MAIN_CASES.items():
        pos, mass, G, a, box, g, k, eps, buckets = pp_scenes.main_case(case)
        if buckets == "census":
            buckets = ppkernel.pp_buckets_for(pos, box, g, k)
            check(buckets is not None, f"{name}: the census buckets the scene")
        (args, ovf), (_, ovf_cpu) = (
            ppkernel._main_pass(torch.from_numpy(pos).to(d), torch.from_numpy(mass).to(d), G, a, box, g,
                                k, eps, buckets, None) for d in (dev, cpu))
        check(int(ovf) == int(ovf_cpu), f"{name}: n_overflow {int(ovf)} on the card, {int(ovf_cpu)} on the CPU")
        r = check_pass(8, f"K4 {name} (n_overflow {int(ovf)})", ppkernel.pp_short, ppkernel.pp_short_reference,
                       args)
        err4 = max(err4, r["max_abs_err"])

    for case, name in pp_scenes.RESIDUAL_CASES.items():
        pos, mass, G, a, box, g, k, m, cap, eps = pp_scenes.residual_case(case)
        missed = []
        for d in (dev, cpu):
            tp, tm = torch.from_numpy(pos).to(d), torch.from_numpy(mass).to(d)
            ri, rv, sort = residual_inputs(tp, tm, box, g, k, m)
            t_args, n_missed = ppkernel._table_pass(tp, tm, G, a, box, g, k, ri, rv, eps, cap, sort)
            missed.append(int(n_missed))
            if d == dev:
                r = check_pass(8, f"K5 {name}", ppkernel.pp_react, ppkernel.pp_react_reference, t_args)
                err5 = max(err5, r["max_abs_err"])
                r = check_pass(8, f"K4 residual-residual {name}", ppkernel.pp_short,
                               ppkernel.pp_short_reference, ppkernel._rr_pass(tp, tm, G, a, box, ri, rv, eps))
                err4 = max(err4, r["max_abs_err"])
        check(missed[0] == missed[1] and (missed[0] > 0) == (case == "affected_cap"),
              f"{name}: n_missed {missed[0]} on the card, {missed[1]} on the CPU")

    # full width: the 1M + 30k-core scene at the production tune
    pos_np, mass_np, _ = p3m_cluster.cluster_scene(n_big, n_core)
    tp, tm = torch.from_numpy(pos_np).to(dev), torch.from_numpy(mass_np).to(dev)
    tune = p3m_cluster.PRODUCTION_TUNE
    k4, k5 = pp_full_width(8, f"N={n_big} core {n_core}", tp, tm, 1.0, tune["eps"], p3m_cluster.BOX, tune)
    return max(err4, k4["max_abs_err"]), max(err5, k5["max_abs_err"])


def reset_pp_counts() -> None:
    ppkernel.pp_short.launches = 0
    ppkernel.pp_react.launches = 0


def phase_p3m(dev, n: int = 1_000_000, n_core: int = 30_000, evals: int = 5) -> float:
    pos_np, mass_np, n_field = p3m_cluster.cluster_scene(n, n_core)
    pos, mass = torch.from_numpy(pos_np).to(dev), torch.from_numpy(mass_np).to(dev)
    tune, box = p3m_cluster.PRODUCTION_TUNE, p3m_cluster.BOX
    acc, unc = p3m.p3m_acceleration(pos, mass, 1.0, box, **tune)  # warm-up: cuFFT plans, allocator
    torch.cuda.synchronize()

    reset_pp_counts()  # P3M's path starts here
    uncs = []
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(evals):
        acc, unc = p3m.p3m_acceleration(pos, mass, 1.0, box, **tune)
        uncs.append(unc)
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / evals
    k4, k5 = ppkernel.pp_short.launches, ppkernel.pp_react.launches
    check(k4 == 2 * evals and k5 == evals,
          f"{k4} K4 and {k5} K5 launches in {evals} evaluations, want {2 * evals} and {evals}")
    n_unc = int(torch.stack(uncs).max())
    check(n_unc == 0, f"n_uncorrected {n_unc} == 0")
    check(all_finite(acc), "accelerations finite")
    errs = p3m_cluster.sample_errors(pos, mass, acc, n_field)
    pm_errs = p3m_cluster.sample_errors(pos, mass, pm_acceleration(pos, mass, 1.0, box, g=tune["g"]), n_field)
    log(9, f"N={n} core {n_core} at {tune}: {ms:.3f} ms per evaluation over {evals}; "
           f"K4 {k4 // evals} and K5 {k5 // evals} launches per evaluation; n_uncorrected {n_unc}")
    log(9, f"median relative error vs direct sum (K1), 4096-body sample: P3M {errs}; PM g={tune['g']} {pm_errs}")
    for part in ("core_median", "field_median"):
        check(errs[part] < pm_errs[part], f"P3M {part} {errs[part]:.3e} < PM's {pm_errs[part]:.3e}")

    torch.cuda.set_sync_debug_mode("error")
    try:
        acc, unc = p3m.p3m_acceleration(pos, mass, 1.0, box, **tune)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    check(int(unc) == 0 and ppkernel.pp_short.launches == 2 * evals + 2, "kernels ran in the sync-checked evaluation")
    log(9, "one evaluation ran under set_sync_debug_mode('error'): no host sync in p3m_acceleration")
    return ms


MERGER_CFG = dict(G=0.5, dt=0.35, sub_steps=1, softening=0.5, merge_time=0.5,
                  fracture_threshold=25.0, max_fractures=32)


def merger_setup(dev, n: int, tune: dict | None = None):
    """examples/merger_full.py's scene and configuration: the scene-census
    P3M tune (or an explicit one with p3m_tune_for's keys), the collision
    grid from the largest radius, buckets from bucketed_layout_for, the
    smoothed Green's function once per scene.

    One change: merger_full clamps the collision grid at 64 cells, and at
    n = 1,048,576 bucketed_layout_for (the JAX package's as the port's)
    rejects every band at 64 (the tail windows of the cores need 20,763 to
    45,828 fused source lanes, over its 8,192). Here the grid is the finest
    whose cells still hold 2.2 r_max, as merger_full's rule without the
    clamp: 204 cells at n = 1,048,576, where band 8 fits."""
    sc, box = scene.galaxy_merger_3d(n=n, seed=0)
    cfg = SimConfig(**MERGER_CFG).to(dev)
    r_max = float(body_radius(torch.from_numpy(sc["mass"]), torch.from_numpy(sc["mat"]),
                              SimConfig().materials).max())
    g_c = int(box / (2.2 * r_max))
    g_c = max(8, g_c - g_c % 2)
    band = 8 if g_c >= 16 else 2
    if tune is None:
        tune = p3m.p3m_tune_for(sc["pos"], box, residual_budget=131072, affected_budget=2048, k_max=1536)
    kw = dict(n_cells=g_c, band_cells=band, buckets=collide.bucketed_layout_for(sc["pos"], box, g_c, band),
              force_impl="p3m", log_events=True, pm_grid=tune["g"], p3m=tune,
              green_hat=isolated_green_hat(box, tune["g"], p3m.smoothing_length(box, tune["n_cells"]),
                                           smoothed=True, device=dev))
    st = collisions_scaled.make_granular_state(sc["pos"], sc["vel"], sc["mass"], mat=sc["mat"],
                                               temp=sc["temp"], seed=0, device=dev)
    return st, cfg, box, kw


def phase_merger(dev, n: int = MERGER_N, frames: int = 2, steps: int = 2) -> tuple[float, tuple, dict, dict]:
    st, cfg, box, kw = merger_setup(dev, n)
    tune = kw["p3m"]
    log(10, f"N={n} box={box:g}: collisions g={kw['n_cells']} B={kw['band_cells']} buckets={kw['buckets']}; "
            f"P3M tune {tune}")
    # K4 and K5 on the arguments the scene's first force evaluation gives them
    k4, k5 = pp_full_width(10, f"merger N={n}", st.pos, st.mass, cfg.G, cfg.softening, box, tune)
    st, tot, _ = collisions_scaled.granular_full_kdk_scan(st, cfg, box, steps, **kw)  # warm-up frame
    torch.cuda.synchronize()
    log(10, f"warm-up frame: n_overflow {int(tot['n_overflow'])} n_uncorrected {int(tot['n_uncorrected'])}")

    reset_pp_counts()  # the merger step's path starts here
    collide.collide_fused.launches = 0
    totals = []
    t0 = time.perf_counter()
    for _ in range(frames):
        st, tot, _ = collisions_scaled.granular_full_kdk_scan(st, cfg, box, steps, **kw)
        totals.append(tot)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / (frames * steps) * 1e3
    agg = {k: torch.stack([t[k] for t in totals]) for k in totals[0]}
    evals = frames * (steps + 1)
    launches = (collide.collide_fused.launches, ppkernel.pp_short.launches, ppkernel.pp_react.launches)
    check(launches == (frames * steps * len(kw["buckets"]), 2 * evals, evals),
          f"K2, K4, K5 launches {launches} in {frames} frames of {steps} steps")
    n_ovf, n_unc = int(agg["n_overflow"].max()), int(agg["n_uncorrected"].max())
    check(n_ovf == 0, f"n_overflow {n_ovf} == 0")
    check(n_unc == 0, f"n_uncorrected {n_unc} == 0")
    check(all_finite(st.pos, st.vel, st.mass, st.temp), "state finite")
    log(10, f"N={n}, {frames} frames of {steps} steps: {ms:.3f} ms/step; bounces {int(agg['n_bounces'].sum())} "
            f"merges {int(agg['n_merges'].sum())} fractures {int(agg['n_fractures'].sum())} "
            f"dropped {int(agg['n_dropped'].sum())}; n_overflow {n_ovf} n_uncorrected {n_unc}; "
            f"launches K2 {launches[0]} K4 {launches[1]} K5 {launches[2]}; alive {int((st.mass > 0).sum())}")

    torch.cuda.set_sync_debug_mode("error")
    try:
        st, tot, _ = collisions_scaled.granular_full_kdk_scan(st, cfg, box, steps, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    check(int(tot["n_uncorrected"]) == 0 and ppkernel.pp_react.launches == evals + steps + 1,
          "kernels ran in the sync-checked frame")
    log(10, "one frame ran under set_sync_debug_mode('error'): no host sync in the P3M granular step")
    return ms, launches, k4, k5


MERGER_SMALL_TUNE = dict(g=32, n_cells=8, max_per_cell=32, max_residual=4096, affected_cap=512)


def phase_merger_vs_cpu(dev, n: int = 4096, steps: int = 2) -> None:
    a, cfg, box, kw = merger_setup(dev, n, MERGER_SMALL_TUNE)
    b, cpu_cfg, _, kw_cpu = merger_setup("cpu", n, MERGER_SMALL_TUNE)
    tune = MERGER_SMALL_TUNE
    n_res = int(p3m.overflowing(p3m.cell_sort(b.pos, box, tune["n_cells"]), tune["max_per_cell"])[0])
    check(n_res > 0, f"the small P3M parameters overflow ({n_res} residuals)")
    gen = torch.Generator().manual_seed(4)
    draws = [draw_fracture_uniforms(cpu_cfg, gen, "cpu") for _ in range(steps)]
    reset_pp_counts()
    a, ta, ea = collisions_scaled.granular_full_kdk_scan(a, cfg, box, steps, draws=[d.to(dev) for d in draws],
                                                         **kw)
    check(ppkernel.pp_react.launches == steps + 1, "K5 ran on the card")
    b, tb, eb = collisions_scaled.granular_full_kdk_scan(b, cpu_cfg, box, steps, draws=draws, **kw_cpu)
    for k in ta:
        check(torch.equal(ta[k].cpu(), tb[k]), f"total {k} equal on card and CPU ({ta[k].tolist()} vs {tb[k].tolist()})")
    for f in ("n_merges", "n_fractures", "n_bounces", "n_overflow", "n_dropped", "merge_mask",
              "fracture_mask", "spawn_mask"):
        check(torch.equal(getattr(ea, f).cpu(), getattr(eb, f)), f"events {f} equal on card and CPU")
    check(torch.equal(a.partner.cpu(), b.partner) and torch.equal(a.mat.cpu(), b.mat),
          "partners and materials equal on card and CPU")
    for f in ("pos", "vel", "mass", "temp", "contact_t"):
        x, y = getattr(a, f).cpu(), getattr(b, f)
        err = float((x - y).abs().max()) / max(float(y.abs().max()), 1e-30)
        log(10, f"N={n}, {steps} steps card vs CPU: {f} max rel err {err:.3e} (tol {SCALED_CPU_TOL:g})")
        check(err < SCALED_CPU_TOL, f"{f} card vs CPU after {steps} steps")
    log(10, f"N={n} ({n_res} residuals at the start): totals "
            f"{{{', '.join(f'{k}: {int(v)}' for k, v in tb.items())}}} equal on card and CPU")


def main() -> None:
    name = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    k1 = phase_kernel(dev)
    phase_reference(dev)
    phase_full_physics(dev)  # resets the launch count: the frame step's path starts here
    phase_headline(dev)
    k1_launches = pairwise_acc.launches
    k2 = phase_collide_kernel(dev)
    phase_scaled(dev)  # resets the launch counts: the at-scale path starts here
    k2_launches = collide.collide_fused.launches
    phase_scaled_vs_cpu(dev)
    err4, err5 = phase_pp_kernels(dev)
    phase_p3m(dev)  # resets the K4/K5 counts: P3M's path
    # resets them again: the merger step's path, whose shapes the K4 and K5
    # entries' times, errors and bounds come from
    _, (_, k4_launches, k5_launches), k4, k5 = phase_merger(dev)
    phase_merger_vs_cpu(dev)
    k4["max_abs_err"] = max(k4["max_abs_err"], err4)
    k5["max_abs_err"] = max(k5["max_abs_err"], err5)
    records = [
        dict(name="pairwise_f32r", route="cuda", source="nbx_torch/csrc/pairwise_f32r.cu",
             replaces="nbx/ops/pairwise.py:168", launches=k1_launches, **k1),
        dict(name="collide_fused", route="cuda", source="nbx_torch/csrc/collide_fused.cu",
             replaces="nbx/ops/collide.py:236", launches=k2_launches, **k2),
        dict(name="pp_short", route="cuda", source="nbx_torch/csrc/pp_short.cu",
             replaces="nbx/ops/ppkernel.py:59", launches=k4_launches, **k4),
        dict(name="pp_react", route="cuda", source="nbx_torch/csrc/pp_react.cu",
             replaces="nbx/ops/ppkernel.py:143", launches=k5_launches, **k5),
    ]
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
