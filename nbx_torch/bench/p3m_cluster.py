"""P3M on the clustered 1M-body scene, on the card (port of
`nbx/bench/p3m_cluster.py`: its scene, its error sample and its mode specs).

    python -m nbx_torch.bench.p3m_cluster [n_total] [n_core] [mode ...] [--profile]

With no mode, runs `p3m_acceleration` at the production tune (g = 64,
n_cells = 12, K = 768, eps = 0.1, max_residual = 32768, dense residuals, the
kernels K4 and K5) on `cluster_scene(n_total, n_core)` (defaults 1,000,000
and 30,000) and prints one JSON line: ms per evaluation (CUDA events, 5
evaluations after a warm-up), n_uncorrected, and the median relative error
against the direct sum (K1) on a half-field, half-core sample.

Each mode, `dense|twolevel[@n_cells,K[,pp[,b]]]`, prints one such line (3
evaluations after a warm-up) for its residual mode: "twolevel" with the
submesh sub_g = 96, sub_cells = 24, sub_k = 96. n_cells and K default to the
production tune's, and pp (the main short-range pass) to "kernel"; `nbx`'s
names "xla" and "pallas" are taken for the port's "ops" and "kernel"; a
trailing "b" adds the occupancy-bucketed PP layout (`pp_buckets_for`).
(`nbx`'s bench defaults a bare mode to its round-2 tune, 25 cells of 96 on
the tensor path; here a bare mode changes only the residual solver.) With
--profile (no modes) it adds the
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
# the two-level residual's submesh, as `nbx`'s bench sizes it
SUBMESH = dict(sub_g=96, sub_cells=24, sub_k=96)
PP_NAMES = {"xla": "ops", "pallas": "kernel", "ops": "ops", "kernel": "kernel"}


def mode_tune(spec: str, pos=None) -> dict:
    """The p3m_acceleration keywords of a mode spec
    `dense|twolevel[@n_cells,K[,pp[,b]]]` (module docstring). `pos` (numpy)
    sizes the buckets of a trailing "b"."""
    mode, _, rest = spec.partition("@")
    if mode not in ("dense", "twolevel"):
        raise ValueError(f"mode must be dense|twolevel, got {mode!r} in {spec!r}")
    tune = dict(PRODUCTION_TUNE, residual_mode=mode, **(SUBMESH if mode == "twolevel" else {}))
    parts = rest.split(",") if rest else []
    if parts:
        tune.update(n_cells=int(parts[0]), max_per_cell=int(parts[1]))
    if len(parts) > 2:
        if parts[2] not in PP_NAMES:
            raise ValueError(f"pp must be one of {sorted(PP_NAMES)}, got {parts[2]!r} in {spec!r}")
        tune["pp_impl"] = PP_NAMES[parts[2]]
    if len(parts) > 3 and parts[3] == "b":
        from nbx_torch.ops.ppkernel import pp_buckets_for

        tune["pp_buckets"] = pp_buckets_for(pos, BOX, tune["n_cells"], tune["max_per_cell"])
    return tune


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
        if e.device_type != cpu or e.name in labels or e.name.startswith("nbx.") or not e.kernels:
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


def measure(pos, mass, n_field: int, tune: dict, reps: int) -> dict:
    """ms per evaluation (CUDA events over `reps` evaluations after a
    warm-up), n_uncorrected and the sample's errors, at `tune`."""
    from nbx_torch.ops.p3m import p3m_acceleration

    acc, unc = p3m_acceleration(pos, mass, 1.0, BOX, **tune)  # warm-up
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        acc, unc = p3m_acceleration(pos, mass, 1.0, BOX, **tune)
    end.record()
    end.synchronize()
    return dict(ms_per_eval=start.elapsed_time(end) / reps, n_uncorrected=int(unc),
                **sample_errors(pos, mass, acc, n_field))


def main(argv) -> list[dict]:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    profile = "--profile" in argv
    args = [a for a in argv if a != "--profile"]
    numbers = [a for a in args if a.isdigit()]
    modes = [a for a in args if not a.isdigit()]
    n_total = int(numbers[0]) if numbers else 1_000_000
    n_core = int(numbers[1]) if len(numbers) > 1 else 30_000
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    pos_np, mass_np, n_field = cluster_scene(n_total, n_core)
    pos, mass = torch.from_numpy(pos_np).to(dev), torch.from_numpy(mass_np).to(dev)
    results = []
    for spec in modes or [None]:
        tune = dict(PRODUCTION_TUNE) if spec is None else mode_tune(spec, pos_np)
        result = dict(device=torch.cuda.get_device_name(0), n=n_total, n_core=n_core,
                      **({} if spec is None else dict(mode=spec)), tune=tune,
                      **measure(pos, mass, n_field, tune, 5 if spec is None else 3))
        if profile and spec is None:
            result["parts_device_ms"] = profile_parts(pos, mass)
        print(json.dumps(result), flush=True)
        results.append(result)
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
