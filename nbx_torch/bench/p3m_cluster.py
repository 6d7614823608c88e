"""P3M on the clustered 1M-body scene, on the card (port of the scene and the
error sample of `nbx/bench/p3m_cluster.py`).

    python -m nbx_torch.bench.p3m_cluster [n_total] [n_core] [--profile]

Runs `p3m_acceleration` at the production tune (g = 64, n_cells = 12,
K = 768, eps = 0.1, max_residual = 32768, dense residuals, the kernels K4
and K5) on `cluster_scene(n_total, n_core)` (defaults 1,000,000 and 30,000)
and prints one JSON line: ms per evaluation (CUDA events, 5 evaluations
after a warm-up), n_uncorrected, and the median relative error against the
direct sum (K1) on a half-field, half-core sample. With --profile it adds the
device time of one evaluation by part, from torch.profiler: the PM deposit,
solve and gather, the cell sort and binning, the K4 main pass, the K4
residual-residual block, K5, and the rest of each pass (layouts and
epilogues). Needs a CUDA device; prints the card's name and power limit
first.
"""

from __future__ import annotations

import functools
import json
import subprocess
import sys

import numpy as np
import torch

BOX = 100.0
EPS = 0.1
PRODUCTION_TUNE = dict(g=64, n_cells=12, max_per_cell=768, eps=EPS, max_residual=32768,
                       residual_mode="dense", pp_impl="kernel")


def cluster_scene(n_total: int, n_core: int, sigma: float = 1.5, seed: int = 0):
    """A quasi-uniform field over the box plus a dense Gaussian core at the
    centre that overflows its cells. Returns (pos [N, 3], mass [N]) float32
    numpy and n_field; the core is the last n_core rows."""
    rng = np.random.default_rng(seed)
    n_field = n_total - n_core
    field = rng.uniform(2.0, 98.0, (n_field, 3))
    core = np.clip(rng.normal(50.0, sigma, (n_core, 3)), 2.0, 98.0)
    pos = np.concatenate([field, core]).astype(np.float32)
    mass = rng.uniform(0.5, 1.5, n_total).astype(np.float32)
    return pos, mass, n_field


def sample_errors(pos: torch.Tensor, mass: torch.Tensor, acc: torch.Tensor, n_field: int,
                  n_sample: int = 4096, seed: int = 1, G: float = 1.0) -> dict:
    """Median relative error of acc against the direct sum (K1 on the card,
    its plain version on the CPU: sample targets x all sources) on a sample
    of n_sample / 2 field and n_sample / 2 core bodies."""
    from nbx_torch.ops.pairwise import pairwise_acc

    rng = np.random.default_rng(seed)
    n = pos.shape[0]
    half = n_sample // 2
    idx = np.concatenate([rng.choice(n_field, half, replace=False),
                          n_field + rng.choice(n - n_field, half, replace=False)])
    idx_t = torch.from_numpy(idx).to(pos.device)
    ref = pairwise_acc(pos, mass, G, EPS, target_pos=pos[idx_t]).cpu().numpy()
    got = acc[idx_t].cpu().numpy()
    err = np.linalg.norm(got - ref, axis=1) / (np.linalg.norm(ref, axis=1) + 1e-9)
    return dict(median=float(np.median(err)), core_median=float(np.median(err[half:])),
                field_median=float(np.median(err[:half])))


def _ranged(module, name: str, label: str) -> None:
    fn = getattr(module, name)

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with torch.profiler.record_function(label):
            return fn(*args, **kwargs)

    setattr(module, name, wrapped)


def profile_parts(pos, mass) -> dict:
    """Device ms of one production-tune evaluation by part (torch.profiler,
    ranges opened around the port's functions for this run only)."""
    from nbx_torch.ops import p3m, ppkernel

    parts = (
        (p3m, "cic_deposit", "pm deposit"),
        (p3m, "_isolated_solve_r", "pm solve (FFTs)"),
        (p3m, "cic_gather", "pm gather"),
        (p3m, "cell_sort", "cell sort"),
        (p3m, "overflowing", "binning"),
        (ppkernel, "short_range_acc_kernel", "main pass, all"),
        (ppkernel, "residual_rr_dense_kernel", "residual-residual, all"),
        (ppkernel, "residual_table_acc_kernel", "residual table, all"),
    )
    for module, name, label in parts:
        _ranged(module, name, label)
    labels = {label for _, _, label in parts}
    cpu = torch.autograd.DeviceType.CPU
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        p3m.p3m_acceleration(pos, mass, 1.0, BOX, **PRODUCTION_TUNE)
        torch.cuda.synchronize()
    out = dict.fromkeys([label for _, _, label in parts], 0.0)
    total = 0.0
    for e in prof.events():  # each torch kernel once, through the CPU op that launched it
        if e.device_type != cpu or e.name in labels or not e.kernels:
            continue
        dur = sum(k.duration for k in e.kernels)
        total += dur
        a = e.cpu_parent
        while a is not None:
            if a.name in labels:
                out[a.name] += dur
            a = a.cpu_parent
    # K4 and K5 are launched through ctypes, linked to no CPU op: charged by
    # name, K4's first launch to the main pass and the rest (the split pair
    # kernel and its combine) to the residual-residual block (their order in
    # p3m_acceleration), K5's two (the pair kernel and its combine) to the
    # residual table
    def launches(name):
        return sorted((e for e in prof.events() if e.device_type != cpu and name in e.name),
                      key=lambda e: e.time_range.start)

    k4, k5 = launches("pp_short"), launches("pp_react")
    for label, part, es in (("K4 main pass", "main pass", k4[:1]),
                            ("K4 residual-residual", "residual-residual", k4[1:]),
                            ("K5 residual table", "residual table", k5)):
        us = sum(e.time_range.elapsed_us() for e in es)
        out[label] = us
        out[f"{part}, layout and epilogue"] = out[f"{part}, all"]
        out[f"{part}, all"] += us
        total += us
    out["other"] = total - sum(out[label] for label in (
        "pm deposit", "pm solve (FFTs)", "pm gather", "cell sort", "binning", "main pass, all",
        "residual-residual, all", "residual table, all"))
    out["device, all"] = total
    return {k: v / 1e3 for k, v in out.items()}


def main(argv) -> None:
    from nbx_torch.ops.p3m import p3m_acceleration

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    profile = "--profile" in argv
    args = [a for a in argv if a != "--profile"]
    n_total = int(args[0]) if args else 1_000_000
    n_core = int(args[1]) if len(args) > 1 else 30_000
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    pos_np, mass_np, n_field = cluster_scene(n_total, n_core)
    pos, mass = torch.from_numpy(pos_np).to(dev), torch.from_numpy(mass_np).to(dev)
    acc, unc = p3m_acceleration(pos, mass, 1.0, BOX, **PRODUCTION_TUNE)  # warm-up
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        acc, unc = p3m_acceleration(pos, mass, 1.0, BOX, **PRODUCTION_TUNE)
    end.record()
    end.synchronize()
    result = dict(device=torch.cuda.get_device_name(0), n=n_total, n_core=n_core,
                  tune=dict(PRODUCTION_TUNE),
                  ms_per_eval=start.elapsed_time(end) / 5, n_uncorrected=int(unc),
                  **sample_errors(pos, mass, acc, n_field))
    if profile:
        result["parts_device_ms"] = profile_parts(pos, mass)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
