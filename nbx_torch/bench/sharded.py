"""All-gather multi-device benchmark: ms per step of `parallel.shard`'s
paths at D ranks, one a card (NCCL).

    python -m nbx_torch.bench.sharded [--ranks D]    # default D = 1

Two cells:

  * `make_sharded_step` on BASELINE config 5's scene, the 1,048,576-body
    galaxy merger of examples/merger_demo.py (`scene.galaxy_merger(N,
    separation=260, approach_speed=0.8, seed=0)`, G, eps, h = 0.5, 0.5,
    0.02): 1 warm-up step, then 3 timed; pairs per second N^2 / (s per
    step);
  * `make_sharded_granular_step` on `bench spatial`'s scene (the
    131,072-body `granular_cloud`, g = 32, B = 8, caps (96, 104), PM 128^3)
    with forces pm, auto and zero: 2 warm-up steps, then 20 timed, and the
    last step's counters.

Times are rank 0's, between two CUDA events after a barrier; every step
ends in collectives, so the ranks run in step. D = 1 runs in this process
(a world of one rank); D > 1 starts D processes of this module, rank r on
card r, meeting at tcp://127.0.0.1:<a free port>. Rank 0 prints one JSON
line a cell, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys

import torch
import torch.distributed as dist

from nbx_torch import scene
from nbx_torch.bench import timing
from nbx_torch.bench.granular import BOX, bench_config, granular_cloud
from nbx_torch.parallel import shard

MERGER_N, GRANULAR_N = 1_048_576, 131_072
MERGER = dict(separation=260.0, approach_speed=0.8, seed=0)  # examples/merger_demo.py:31
G, EPS, H = 0.5, 0.5, 0.02
FORCES = ("pm", "auto", "zero")
GRANULAR = dict(n_cells=32, band_cells=8, packed_caps=(96, 104), pm_grid=128)  # bench spatial's defaults


def _timed(mesh, dev, run, steps: int, warmup: int):
    """(ms per step, the last step's output): warmup calls, a barrier, then
    `steps` calls between two CUDA events."""
    out = None
    for _ in range(warmup):
        out = run()
    dist.barrier(group=mesh.get_group(0))
    t0 = timing.stamp(dev)
    for _ in range(steps):
        out = run()
    return timing.elapsed_ms(t0, timing.stamp(dev)) / steps, out


def time_gravity(mesh, dev, sc, steps: int = 3, warmup: int = 1):
    """make_sharded_step on the merger scene `sc`: (record, the final
    state)."""
    n = len(sc["mass"])
    st = shard.shard_state(mesh, sc["pos"], sc["vel"], sc["mass"])
    step = shard.make_sharded_step(mesh)
    box = [st]

    def run():
        box[0] = step(box[0], G, EPS, H)
        return box[0]

    ms, st = _timed(mesh, dev, run, steps, warmup)
    rec = dict(path="sharded_gravity", n=n, d=mesh.size(), ms_per_step=ms, pairs_per_s=n * n / (ms * 1e-3),
               steps=steps, device=timing.device_name(dev))
    return rec, st


def time_granular(mesh, dev, n: int, force: str, steps: int = 20, warmup: int = 2) -> dict:
    """make_sharded_granular_step on bench spatial's cloud with `force`."""
    pos, vel, mass = granular_cloud(n)
    cfg = bench_config()
    step = shard.make_sharded_granular_step(mesh, cfg, BOX, GRANULAR["n_cells"], GRANULAR["band_cells"],
                                            GRANULAR["packed_caps"], force_impl=force, pm_grid=GRANULAR["pm_grid"])
    box = [shard.shard_body_state(mesh, pos, vel, mass)]

    def run():
        box[0], c = step(box[0], cfg.dt)
        return c

    ms, c = _timed(mesh, dev, run, steps, warmup)
    counters = {k: (bool(v) if k == "cell_too_small" else int(v)) for k, v in c.items()}
    return dict(path="sharded_granular", n=n, d=mesh.size(), force=force, ms_per_step=ms, steps=steps,
                counters=counters, device=timing.device_name(dev))


def run_cells() -> list:
    """Both cells on the initialised world (one rank a card); rank 0
    prints the records."""
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = shard.make_mesh()
    recs = [time_gravity(mesh, dev, scene.galaxy_merger(MERGER_N, **MERGER))[0]]
    recs += [time_granular(mesh, dev, GRANULAR_N, f) for f in FORCES]
    if dist.get_rank() == 0:
        for r in recs:
            print(json.dumps(r), flush=True)
    return recs


def _rank_main(args) -> None:
    torch.cuda.set_device(args.rank)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{args.port}", rank=args.rank,
                            world_size=args.ranks)
    try:
        run_cells()
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, default=1)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    timing.require("cuda")
    if args.rank is not None:
        _rank_main(args)
        return
    if args.ranks > torch.cuda.device_count():
        raise SystemExit(f"--ranks {args.ranks} needs as many cards; torch sees {torch.cuda.device_count()}")
    if args.ranks == 1:
        with shard.local_world("nccl"):
            run_cells()
        return
    port = _free_port()
    cmd = [sys.executable, "-m", "nbx_torch.bench.sharded", "--ranks", str(args.ranks), "--port", str(port)]
    procs = [subprocess.Popen(cmd + ["--rank", str(r)], env=dict(os.environ, PYTHONUNBUFFERED="1"),
                              stdout=None if r == 0 else subprocess.DEVNULL) for r in range(args.ranks)]
    try:
        codes = [p.wait(timeout=1800) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(codes):
        raise SystemExit(f"ranks exited {codes}")


if __name__ == "__main__":
    main()
