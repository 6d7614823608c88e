"""The strict-sequential sweep's kernels at `chip_smoke.py`'s phase-27
shapes, timed by CUDA events, one JSON line a case.

    env PYTHONPATH=$PWD python nbx_torch/bench/sweep_turns.py [--reps N] [case ...]

Cases: ref (the reference galaxy at capacity 300: the sweep's inputs at the
first substep of `sim.step(collision_impl="sequential")`) and pile (the
4,096-body lattice pile of `chip_smoke.sequential_scenes()`); default:
both. Each line gives the case, the capacity, the overlap tests, the device
ms of the pre-pass, the walk and both (`chip_smoke.sweep_stage_ms`: each
launch between CUDA events queued behind a sleep kernel, the median of
--reps), the ms of a call with its wrapper (the mean of --reps calls), the
card's name and power limit, and a digest of the outputs (sha1 of every
output's bytes): two runs whose digests agree wrote the same bits.

The script calls `nbx_torch.ops.sequential` and `chip_smoke.py`'s helpers
from whatever checkout comes first on PYTHONPATH, so one command can time
two checkouts in turns (parent, change, change, parent). It needs a card and
raises without one.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json

import torch

import chip_smoke
from nbx_torch import scene, sim
from nbx_torch.bench import timing
from nbx_torch.config import SimConfig
from nbx_torch.ops import sequential

CASES = ("ref", "pile")


def _ref(dev):
    """The sweep's arguments at the reference scene's first substep."""
    cfg = SimConfig().to(dev)
    st = scene.make_state(cfg, scene.reference_galaxy(seed=0), dev, seed=0)
    kernel, calls = sequential.sweep, []

    def rec(*args):
        calls.append(args)
        return kernel(*args)

    rec.launches = 0
    sequential.sweep = rec
    try:
        sim.step(st, cfg, collision_impl="sequential")
    finally:
        sequential.sweep = kernel
    return calls[0]


def _pile(dev):
    cfg, sc, timers = chip_smoke.sequential_scenes()["4,096-body pile"]
    cfg = cfg.to(dev)
    return (*chip_smoke.sweep_inputs(cfg, sc, timers, dev), sim.substep_size(cfg), cfg)


def main(cases=CASES, reps: int = 20) -> list[dict]:
    dev = timing.require("cuda")
    card = timing.device_name(dev)
    rows = []
    for case in cases:
        args = globals()[f"_{case}"](dev)
        out = sequential.sweep(*args)
        h = hashlib.sha1()
        for f in dataclasses.fields(out):
            h.update(getattr(out, f.name).cpu().numpy().tobytes())
        stages = chip_smoke.sweep_stage_ms(args[:9], args[9], args[10], reps)
        call_ms = chip_smoke.cuda_ms(lambda: sequential.sweep(*args), reps)
        rows.append(dict(case=case, capacity=int(args[0].shape[0]), n_tests=int(out.count("n_tests")),
                         prepass_ms=stages["pre-pass"], walk_ms=stages["walk"], kernels_ms=stages["both"],
                         call_ms=call_ms, device=card, digest=h.hexdigest()[:16]))
        print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("cases", nargs="*", default=list(CASES), help=" ".join(CASES))
    ap.add_argument("--reps", type=int, default=20)
    a = ap.parse_args()
    main(a.cases, a.reps)
