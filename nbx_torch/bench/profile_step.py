"""Where the time of one at-scale granular step goes, on the card.

    python -m nbx_torch.bench.profile_step [N] [steps]
    python -m nbx_torch.bench.profile_step spatial [N] [steps] [force]
    python -m nbx_torch.bench.profile_step sharded [N] [steps] [force]

Runs the at-scale live server's configuration (`granular_cloud(N)`, box
100 (N / 131072)^(1/3), g = 40, B = 12, PM gravity on a 64^3 mesh, one
`granular_full_kdk_scan(n_steps=1, log_events=True)` per step), or with
`spatial` the spatial halo-exchange step of `bench spatial` at world size 1
(the 131,072-body cloud, 32,8,96,104, force pm (default) or p3m, PM 128^3),
or with `sharded` the all-gather granular step (`parallel.shard`) at world
size 1 on the same scene (force pm (default), auto or zero), and prints one
JSON line:

  * ms_per_step: host clock over 10 steps ending in a synchronize, unprofiled;
  * device_ms_per_step, kernels_per_step, busy_share: torch.profiler over
    `steps` steps (kernel time summed, over the profiled wall time);
  * parts: device ms per step of each part of the step, from the spans the
    package opens (`nbx_torch.profiling.span`; PARTS, SPATIAL_PARTS and
    SHARDED_PARTS map each span read here to its part's label): the PM
    deposit, solve (FFTs) and gather, the cell sort, the window layout, the
    collision kernel, the epilogue, the contact timers, the fragments;
    `events, other` is the rest of the collision substep, `step, other`
    the rest of the step (kicks, drift, thermal decay, counters). The spatial step's parts: the
    local pass (its slab sort, window layout and kernel, K2 or K7), the PM
    deposit, solve and gather, the exchanges, the fragments; `step, other`
    the rest (kicks, migration and halo selection, gates, merges, slot
    bookkeeping, the reductions). The all-gather step's parts: the slab
    pass (its cell sort, window layout and kernel), the reduce-scatters of
    its rows, the gathers, the partner record, the PM deposit, solve and
    gather, the fragments; `step, other` the rest.

Needs a CUDA device; prints the card's name and power limit first.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

from nbx_torch import collisions_scaled
from nbx_torch.bench.granular import BOX, granular_cloud
from nbx_torch.config import SimConfig
from nbx_torch.ops import collide, pm
from nbx_torch.parallel import shard, spatial

SPAN = "nbx."  # the prefix of the package's span names

PARTS = {
    "nbx.pm": "pm, all",  # pm.pm_acceleration
    "nbx.pm.deposit": "pm deposit",  # pm.cic_deposit
    "nbx.pm.solve": "pm solve (FFTs)",  # pm._isolated_solve_r (and pm_solve_grid's periodic solve)
    "nbx.pm.gather": "pm gather",  # pm.cic_gather
    "nbx.collide": "events, all",  # collisions_scaled.resolve_collisions_scaled
    "nbx.collide.pass": "collision pass, all",  # collide.binned_collision_pass
    "nbx.collide.sort": "cell sort",  # the cell sort of collide._sorted_pass
    "nbx.collide.windows": "window layout",  # collide._bucket_windows
    "nbx.collide.kernel": "K2 collide_fused",  # collide._run, every collision kernel's launch
    "nbx.collide.epilogue": "epilogue",  # collide._epilogue_finish
    "nbx.collide.timers": "contact timers",  # collisions_scaled._timers
    "nbx.collide.fragments": "fragments",  # collisions._make_fragments
}


SPATIAL_PARTS = {
    "nbx.collide.pass": "local pass, all",  # collide._local_pass
    "nbx.collide.sort": "slab sort",  # its cell_sort_slabgrid
    "nbx.collide.windows": "window layout",
    "nbx.pm.deposit": "pm deposit",
    "nbx.pm.solve": "pm solve (FFTs)",
    "nbx.pm.gather": "pm gather",
    "nbx.spatial.exchange": "exchanges",  # spatial._exchange
    "nbx.collide.fragments": "fragments",
}


SHARDED_PARTS = {
    "nbx.collide.pass": "slab pass, all",  # shard._slab_pass
    "nbx.collide.sort": "cell sort",
    "nbx.collide.windows": "window layout",
    "nbx.reduce_scatter": "reduce-scatters",  # shard._reduce_scatter
    "nbx.gather": "gathers",  # shard._gather
    "nbx.shard.partner": "partner record",  # the shard step's partner_record
    "nbx.pm.deposit": "pm deposit",
    "nbx.pm.solve": "pm solve (FFTs)",
    "nbx.pm.gather": "pm gather",
    "nbx.collide.fragments": "fragments",
}


def profile(step, st, steps: int, parts: dict, kernel_parts) -> dict:
    """Profile `steps` calls of st = step(st) and return the per-step
    numbers: device ms, kernels, busy share, device ms of each part (each
    kernel charged to the labels `parts` gives the spans that enclose the
    CPU op that launched it), the top kernels. The collision kernel launches
    through ctypes, so no CPU op owns it: its time is charged by name to the
    labels of kernel_parts."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            st = step(st)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    labels = set(parts.values())
    cpu = torch.autograd.DeviceType.CPU
    part_us = dict.fromkeys(labels | set(kernel_parts), 0.0)
    device_us, n_kernels = 0.0, 0
    for e in prof.events():  # each kernel once, through the CPU op that launched it
        if e.device_type != cpu or e.name.startswith(SPAN):
            continue
        dur = sum(k.duration for k in e.kernels)
        if not e.kernels:
            continue
        device_us += dur
        n_kernels += len(e.kernels)
        a = e.cpu_parent
        while a is not None:  # charge every enclosing span that is a part
            if a.name in parts:
                part_us[parts[a.name]] += dur
            a = a.cpu_parent
    kern = [e for e in prof.events() if e.device_type != cpu and "collide_fused_kernel" in e.name]
    kern_us = sum(e.time_range.elapsed_us() for e in kern)
    n_kernels += len(kern)
    for label in kernel_parts:
        part_us[label] += kern_us
    device_us += kern_us
    # cross-check: the device-side events themselves, the spans left out
    device_side_ms = sum(
        e.time_range.elapsed_us() for e in prof.events()
        if e.device_type != cpu and not e.name.startswith(SPAN)) / 1e3
    top = sorted((e for e in prof.key_averages() if not e.key.startswith(SPAN)),
                 key=lambda e: -e.self_device_time_total)[:12]
    return dict(
        profiled_ms_per_step=wall_ms / steps, device_ms_per_step=device_us / 1e3 / steps,
        kernels_per_step=n_kernels / steps, device_side_events_ms_per_step=device_side_ms / steps,
        busy_share=device_us / 1e3 / wall_ms,
        parts_device_ms_per_step={k: v / 1e3 / steps for k, v in part_us.items()},
        top_kernels_device_ms_per_step={e.key[:80]: e.self_device_time_total / 1e3 / steps for e in top},
    ), st


def _host_ms(step, st, reps: int = 10):
    for _ in range(3):
        st = step(st)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        st = step(st)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3, st


def main_spatial(argv, dev) -> dict:
    """The spatial step at world size 1 (module docstring)."""
    from nbx_torch.bench import spatial as spatial_bench

    n = int(argv[0]) if argv else 131072
    steps = int(argv[1]) if len(argv) > 1 else 5
    force = argv[2] if len(argv) > 2 else "pm"
    g, b, caps = spatial_bench.parse_config("32,8,96,104")
    box = BOX * (n / 131072.0) ** (1.0 / 3.0)
    pos, vel, mass = granular_cloud(n, seed=0, box=box)
    cfg = SimConfig(G=0.5, dt=0.016, sub_steps=1, merge_time=0.25, fracture_threshold=8.0).to(dev)
    with shard.local_world("nccl"):
        mesh = shard.make_mesh()
        halo_cap, mig_cap = spatial_bench.spatial_caps(n, g)
        sstep = spatial.make_spatial_granular_step(mesh, cfg, box, g, b, caps, halo_cap=halo_cap, mig_cap=mig_cap,
                                                   force_impl=force, pm_grid=spatial_bench.PM_GRID)
        st = spatial.spatial_state_for(mesh, pos, vel, mass, box, g)

        def step(s):
            return sstep(s, cfg.dt)[0]

        ms_per_step, st = _host_ms(step, st)
        out, _ = profile(step, st, steps, SPATIAL_PARTS, ("kernel (K2 or K7)", "local pass, all"))
    parts = out["parts_device_ms_per_step"]
    parts["local pass, other"] = parts["local pass, all"] - sum(
        parts[k] for k in ("slab sort", "window layout", "kernel (K2 or K7)"))
    parts["step, other"] = out["device_ms_per_step"] - sum(
        parts[k] for k in ("local pass, all", "pm deposit", "pm solve (FFTs)", "pm gather", "exchanges",
                           "fragments"))
    return dict(device=torch.cuda.get_device_name(0), path="spatial_halo_step", n=n, force=force,
                ms_per_step=ms_per_step, **out)


def main_sharded(argv, dev) -> dict:
    """The all-gather granular step at world size 1 (module docstring)."""
    from nbx_torch.bench import sharded

    n = int(argv[0]) if argv else 131072
    steps = int(argv[1]) if len(argv) > 1 else 5
    force = argv[2] if len(argv) > 2 else "pm"
    kw = sharded.GRANULAR
    box = BOX * (n / 131072.0) ** (1.0 / 3.0)
    pos, vel, mass = granular_cloud(n, seed=0, box=box)
    cfg = SimConfig(G=0.5, dt=0.016, sub_steps=1, merge_time=0.25, fracture_threshold=8.0).to(dev)
    with shard.local_world("nccl"):
        mesh = shard.make_mesh()
        sstep = shard.make_sharded_granular_step(mesh, cfg, box, kw["n_cells"], kw["band_cells"], kw["packed_caps"],
                                                 force_impl=force, pm_grid=kw["pm_grid"])
        st = shard.shard_body_state(mesh, pos, vel, mass)

        def step(s):
            return sstep(s, cfg.dt)[0]

        ms_per_step, st = _host_ms(step, st)
        out, _ = profile(step, st, steps, SHARDED_PARTS, ("kernel (K2, slab entry)", "slab pass, all"))
    parts = out["parts_device_ms_per_step"]
    parts["slab pass, other"] = parts["slab pass, all"] - sum(
        parts[k] for k in ("cell sort", "window layout", "kernel (K2, slab entry)", "reduce-scatters"))
    parts["step, other"] = out["device_ms_per_step"] - sum(
        parts[k] for k in ("slab pass, all", "gathers", "partner record", "pm deposit", "pm solve (FFTs)",
                           "pm gather", "fragments"))
    return dict(device=torch.cuda.get_device_name(0), path="sharded_granular_step", n=n, force=force,
                ms_per_step=ms_per_step, **out)


def main(argv) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    if argv and argv[0] in ("spatial", "sharded"):
        run = main_spatial if argv[0] == "spatial" else main_sharded
        print(json.dumps(run(argv[1:], dev)), flush=True)
        return
    n = int(argv[0]) if argv else 131072
    steps = int(argv[1]) if len(argv) > 1 else 5
    box = BOX * (n / 131072.0) ** (1.0 / 3.0)
    pos, vel, mass = granular_cloud(n, seed=0, box=box)
    st = collisions_scaled.make_granular_state(pos, vel, mass, seed=0, device=dev)
    cfg = SimConfig(G=0.5, dt=0.016, sub_steps=1, merge_time=0.25, fracture_threshold=8.0).to(dev)
    kw = dict(n_cells=40, band_cells=12, buckets=collide.bucketed_layout_for(pos, box, 40, 12),
              force_impl="pm", pm_grid=64, log_events=True,
              green_hat=pm.isolated_green_hat(box, 64, device=dev))

    def step(s):
        return collisions_scaled.granular_full_kdk_scan(s, cfg, box, 1, **kw)[0]

    ms_per_step, st = _host_ms(step, st)
    # the cloud collapses: re-size the buckets before the profiled window
    kw["buckets"] = collide.bucketed_layout_for(st.pos.cpu().numpy(), box, 40, 12)
    out, _ = profile(step, st, steps, PARTS, ("K2 collide_fused", "collision pass, all", "events, all"))
    parts = out["parts_device_ms_per_step"]
    parts["events, other"] = parts["events, all"] - sum(
        parts[k] for k in ("collision pass, all", "contact timers", "fragments"))
    parts["collision pass, other"] = parts["collision pass, all"] - sum(
        parts[k] for k in ("cell sort", "window layout", "K2 collide_fused", "epilogue"))
    parts["pm, other"] = parts["pm, all"] - sum(
        parts[k] for k in ("pm deposit", "pm solve (FFTs)", "pm gather"))
    parts["step, other"] = out["device_ms_per_step"] - parts["pm, all"] - parts["events, all"]
    print(json.dumps(dict(device=torch.cuda.get_device_name(0), n=n, buckets=kw["buckets"],
                          ms_per_step=ms_per_step, **out)), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
