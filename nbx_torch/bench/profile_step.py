"""Where the time of one at-scale granular step goes, on the card.

    python -m nbx_torch.bench.profile_step [N] [steps]

Runs the at-scale live server's configuration (`granular_cloud(N)`, box
100 (N / 131072)^(1/3), g = 40, B = 12, PM gravity on a 64^3 mesh, one
`granular_full_kdk_scan(n_steps=1, log_events=True)` per step) and prints
one JSON line:

  * ms_per_step: host clock over 10 steps ending in a synchronize, unprofiled;
  * device_ms_per_step, kernels_per_step, busy_share: torch.profiler over
    `steps` steps (kernel time summed, over the profiled wall time);
  * parts: device ms per step of each part of the step, from profiler ranges
    opened around the port's functions for this run only (the functions are
    wrapped here, the package is not instrumented): the PM deposit, solve
    (FFTs) and gather, the cell sort, the window layout, the collision kernel,
    the epilogue, the contact timers, the fragments; `events, other` is the
    rest of the collision substep, `step, other` the rest of the step
    (kicks, drift, thermal decay, counters).

Needs a CUDA device; prints the card's name and power limit first.
"""

from __future__ import annotations

import functools
import json
import subprocess
import sys
import time

import torch

from nbx_torch import collisions_scaled
from nbx_torch.bench.granular import BOX, granular_cloud
from nbx_torch.config import SimConfig
from nbx_torch.ops import collide, pm


def _ranged(module, name: str, label: str) -> None:
    fn = getattr(module, name)

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with torch.profiler.record_function(label):
            return fn(*args, **kwargs)

    setattr(module, name, wrapped)


PARTS = (
    (pm, "pm_acceleration", "pm, all"),
    (pm, "cic_deposit", "pm deposit"),
    (pm, "pm_solve_grid", "pm solve (FFTs)"),
    (pm, "cic_gather", "pm gather"),
    (collisions_scaled, "resolve_collisions_scaled", "events, all"),
    (collide, "_bucketed_pass", "collision pass, all"),
    (collide, "cell_sort", "cell sort"),
    (collide, "_bucket_windows", "window layout"),
    (collide, "collide_fused", "K2 collide_fused"),
    (collide, "_epilogue_finish", "epilogue"),
    (collisions_scaled, "_timers", "contact timers"),
    (collisions_scaled, "_make_fragments", "fragments"),
)


def main(argv) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    n = int(argv[0]) if argv else 131072
    steps = int(argv[1]) if len(argv) > 1 else 5
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    box = BOX * (n / 131072.0) ** (1.0 / 3.0)
    pos, vel, mass = granular_cloud(n, seed=0, box=box)
    st = collisions_scaled.make_granular_state(pos, vel, mass, seed=0, device=dev)
    cfg = SimConfig(G=0.5, dt=0.016, sub_steps=1, merge_time=0.25, fracture_threshold=8.0).to(dev)
    kw = dict(n_cells=40, band_cells=12, buckets=collide.bucketed_layout_for(pos, box, 40, 12),
              force_impl="pm", pm_grid=64, log_events=True,
              green_hat=pm.isolated_green_hat(box, 64, device=dev))

    def step(s):
        return collisions_scaled.granular_full_kdk_scan(s, cfg, box, 1, **kw)[0]

    for _ in range(3):
        st = step(st)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        st = step(st)
    torch.cuda.synchronize()
    ms_per_step = (time.perf_counter() - t0) / 10 * 1e3
    # the cloud collapses: re-size the buckets before the profiled window
    kw["buckets"] = collide.bucketed_layout_for(st.pos.cpu().numpy(), box, 40, 12)

    for module, name, label in PARTS:
        _ranged(module, name, label)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            st = step(st)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    labels = {label for _, _, label in PARTS}
    cpu = torch.autograd.DeviceType.CPU
    parts = dict.fromkeys(labels, 0.0)
    device_us, n_kernels = 0.0, 0
    for e in prof.events():  # each kernel once, through the CPU op that launched it
        if e.device_type != cpu or e.name in labels:
            continue
        dur = sum(k.duration for k in e.kernels)
        if not e.kernels:
            continue
        device_us += dur
        n_kernels += len(e.kernels)
        a = e.cpu_parent
        while a is not None:  # charge every enclosing range
            if a.name in labels:
                parts[a.name] += dur
            a = a.cpu_parent
    # The collision kernel is launched through ctypes, not by a PyTorch op,
    # so the profiler links it to no CPU op: charge it by name.
    k2 = [e for e in prof.events() if e.device_type != cpu and "collide_fused_kernel" in e.name]
    k2_us = sum(e.time_range.elapsed_us() for e in k2)
    n_kernels += len(k2)
    for label in ("K2 collide_fused", "collision pass, all", "events, all"):
        parts[label] += k2_us
    device_us += k2_us
    device_ms = device_us / 1e3
    # cross-check: the device-side events themselves, user ranges left out
    device_side_ms = sum(
        e.time_range.elapsed_us() for e in prof.events()
        if e.device_type != cpu and e.name not in labels) / 1e3
    parts = {k: parts[k] / 1e3 / steps for _, _, k in PARTS}
    parts["events, other"] = parts["events, all"] - sum(
        parts[k] for k in ("collision pass, all", "contact timers", "fragments"))
    parts["collision pass, other"] = parts["collision pass, all"] - sum(
        parts[k] for k in ("cell sort", "window layout", "K2 collide_fused", "epilogue"))
    parts["pm, other"] = parts["pm, all"] - sum(
        parts[k] for k in ("pm deposit", "pm solve (FFTs)", "pm gather"))
    parts["step, other"] = device_ms / steps - parts["pm, all"] - parts["events, all"]
    top = sorted((e for e in prof.key_averages() if e.key not in labels),
                 key=lambda e: -e.self_device_time_total)[:12]
    print(json.dumps(dict(
        device=torch.cuda.get_device_name(0), n=n, buckets=kw["buckets"],
        ms_per_step=ms_per_step, profiled_ms_per_step=wall_ms / steps,
        device_ms_per_step=device_ms / steps, kernels_per_step=n_kernels / steps,
        device_side_events_ms_per_step=device_side_ms / steps,
        busy_share=device_ms / wall_ms, parts_device_ms_per_step=parts,
        top_kernels_device_ms_per_step={e.key[:80]: e.self_device_time_total / 1e3 / steps
                                        for e in top},
    )), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
