"""Component split of the binned-collision step (port of
`nbx/bench/collsplit.py`): where do the ms go?

Times three nested prefixes of the at-scale collision step, all in one
process:

  sort = cell_sort + inverse permutation           (the O(N log N) floor)
  pass = binned_collision_pass                     (sort + layout + kernel
         + epilogue)
  full = granular_full_kdk_scan, zero force        (pass + timers, merges,
         fractures, thermal, integration)

so (pass - sort) is layout, kernel and epilogue, and (full - pass) the event
machinery.

    python -m nbx_torch.bench.collsplit [N] [scene] [cfg ...]
    python -m nbx_torch bench collsplit [N] [scene] [cfg ...]
    # cfg as nbx_torch.bench.granular; defaults: 262144 cloudcd
    #   40,16,8,u0.8 40,16,8,a0.99

Each prefix runs a warm-up chain, then a chain of `steps` iterations (each
iteration's output feeds the next) between two CUDA events; one JSON line a
configuration with the JAX harness's keys and the device.
"""

from __future__ import annotations

import json
import sys

import torch

from nbx_torch.bench import timing
from nbx_torch.bench.granular import bench_config, parse_config, scene_arrays, size_layout
from nbx_torch.collisions_scaled import granular_full_kdk_scan, make_granular_state
from nbx_torch.config import CUDA, body_radius
from nbx_torch.ops.collide import binned_collision_pass
from nbx_torch.ops.p3m import cell_sort, inverse_permutation

DEFAULT_CONFIGS = ("40,16,8,u0.8", "40,16,8,a0.99")


def sort_chain(pos, steps: int, box: float, g: int):
    """`steps` cell sorts and inverse permutations, each nudging the
    positions by a permutation-derived epsilon (the dependency)."""
    for _ in range(steps):
        order, _, _ = cell_sort(pos, box, g)
        inv = inverse_permutation(order)
        pos = pos + (inv % 7).to(torch.float32)[:, None] * 1e-7
    return pos


def pass_chain(pos, vel, mass, radius, steps: int, box: float, g: int, k: int, band, lay: dict):
    """`steps` collision passes, each applied to the positions and
    velocities the next reads."""
    for _ in range(steps):
        dvel, dpos, *_ = binned_collision_pass(
            pos, vel, mass, radius, box, g, max_per_cell=k, band_cells=band, packed_caps=lay["packed"],
            max_blocks=lay["max_blocks"], buckets=lay["buckets"], windows_per_block=lay["windows"],
            construction=lay["construction"])
        pos, vel = pos + dpos, vel + dvel
    return pos


def _time(run, device, steps: int, warmup: int) -> float:
    run(warmup)
    t0 = timing.stamp(device)
    run(steps)
    return timing.elapsed_ms(t0, timing.stamp(device)) / steps


def main(n: int = 262144, scene: str = "cloudcd", *cfgs, steps: int = 16, warmup: int = 4,
         device=CUDA) -> list:
    """Run the split; print one JSON line a configuration and return the
    result dicts."""
    device = timing.require(device)
    pos, vel, mass, box = scene_arrays(n, scene)
    st0 = make_granular_state(pos, vel, mass, seed=0, device=device)
    cfg = bench_config().to(device)
    radius = body_radius(st0.mass, st0.mat, cfg.materials)
    name = timing.device_name(device)
    out = []
    for token in cfgs or DEFAULT_CONFIGS:
        g, k, band, packed, max_blocks = parse_config(token)
        lay, _ = size_layout(pos, box, g, band, packed, max_blocks)
        ms_sort = _time(lambda s: sort_chain(st0.pos, s, box, g), device, steps, warmup)
        ms_pass = _time(lambda s: pass_chain(st0.pos, st0.vel, st0.mass, radius, s, box, g, k, band, lay),
                        device, steps, warmup)
        ms_full = _time(lambda s: granular_full_kdk_scan(
            st0, cfg, box, s, n_cells=g, max_per_cell=k, band_cells=band, packed_caps=lay["packed"],
            max_blocks=lay["max_blocks"], buckets=lay["buckets"], windows_per_block=lay["windows"],
            construction=lay["construction"], force_impl="zero"), device, steps, warmup)
        r = dict(n=n, cfg=token, box=box, ms_sort=ms_sort, ms_pass=ms_pass, ms_full=ms_full,
                 ms_layout_kernel_epilogue=ms_pass - ms_sort, ms_event_machinery=ms_full - ms_pass,
                 device=name)
        print(json.dumps(r), flush=True)
        out.append(r)
    return out


if __name__ == "__main__":
    a = sys.argv[1:]
    main(*(int(x) if x.isdigit() else x for x in a))
