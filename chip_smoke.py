#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (`nbx_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernel from `nbx_torch/csrc/` and drives the port's
main path, the frame step, through its public entry points
(`scene.make_state`, `sim.run`, `diagnostics.measure`):

  0. device: name and power limit; TF32 off
  1. build: nvcc the kernel (sm_90a), print ptxas' resource report
  2. the gravity kernel against its plain PyTorch version on the card, at
     N = 4,096, rectangular and ragged shapes, mass-0 padding, and the
     N = 262,144 cold-collapse disk; times both at N = 262,144
  3. the reference scene at the reference size (capacity 300, full physics,
     300 frames), plus 20 frames held against the same frames on the CPU
  4. full physics with the kernel: capacity 4,096, 50 frames; one more frame
     under torch.cuda.set_sync_debug_mode("error")
  5. gravity only at N = 262,144: 5 frames, momentum conservation

Every phase raises on failure, so the script exits non-zero; it needs a CUDA
device and has no CPU fallback. The line before the last is the kernels'
JSON record; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import time

import numpy as np
import torch

from nbx_torch import diagnostics, scene, sim
from nbx_torch.collisions import draw_fracture_uniforms
from nbx_torch.config import SimConfig
from nbx_torch.ops import _build
from nbx_torch.ops.pairwise import pairwise_acc, pairwise_acc_reference

KERNEL_TOL = 1e-5  # max|kernel - plain| / max|plain|, the bar of tests/test_tpu_only.py
HEADLINE_N = 262_144


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


def compare(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    abs_err = float((got - want).abs().max())
    rel = abs_err / float(want.abs().max())
    log(2, f"{name}: max|kernel-plain|={abs_err:.3e} rel={rel:.3e} (tol {KERNEL_TOL:g})")
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
    lib = _build.build("pairwise_f32r")
    _build.load("pairwise_f32r")
    log(1, f"built {lib.relative_to(_build.BUILD_DIR.parent.parent)} in {time.perf_counter() - t0:.2f} s")
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
    log(2, f"N={n_big}: kernel {ms:.3f} ms ({rate:.4e} pairs/s), plain {plain_ms:.3f} ms, "
           f"plain/kernel {plain_ms / ms:.2f}x")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)


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


def main() -> None:
    name = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    k1 = phase_kernel(dev)
    phase_reference(dev)
    phase_full_physics(dev)  # resets the launch count: the main path starts here
    phase_headline(dev)
    record = dict(
        name="pairwise_f32r",
        route="cuda",
        source="nbx_torch/csrc/pairwise_f32r.cu",
        replaces="nbx/ops/pairwise.py:168",
        launches=pairwise_acc.launches,
        **k1,
    )
    print(json.dumps({"kernels": [record]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
