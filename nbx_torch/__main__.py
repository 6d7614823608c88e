"""nbx_torch command-line interface.

    python -m nbx_torch bench throughput|drift|latency|granular|collsplit|spatial [args...]
    python -m nbx_torch run --scenario galaxy --frames 500 --checkpoint nbx_checkpoint.npz

`bench`: each all-digit argument becomes an int, and the arguments go
positionally to the benchmark's main, as `python -m nbx` passes them.
`run`: a headless run of `interactive.Simulation` at `--capacity`, snapshotted
every `--every` frames to `--checkpoint` (`Simulation.run_checkpointed`),
closing with one line of the final body count and energy. Both run on the
card and raise where torch sees none. The JAX CLI's `serve` and `demo` wait
for the renderer and the server (ROADMAP item 9).
"""

from __future__ import annotations

import argparse
import importlib
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="nbx_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)
    b = sub.add_parser("bench", help="benchmarks")
    b.add_argument("which", choices=["throughput", "drift", "latency", "granular", "collsplit", "spatial"])
    b.add_argument("args", nargs="*")
    r = sub.add_parser("run", help="headless run with checkpointing")
    r.add_argument("--scenario", default="galaxy")
    r.add_argument("--frames", type=int, default=500)
    r.add_argument("--checkpoint", default="nbx_checkpoint.npz")
    r.add_argument("--every", type=int, default=100)
    r.add_argument("--capacity", type=int, default=300)
    a = p.parse_args(argv)
    if a.cmd == "bench":
        importlib.import_module(f"nbx_torch.bench.{a.which}").main(
            *[int(x) if x.isdigit() else x for x in a.args]
        )
    elif a.cmd == "run":
        import torch

        from nbx_torch.config import SimConfig
        from nbx_torch.interactive import Simulation

        if not torch.cuda.is_available():
            raise RuntimeError("run runs on a CUDA device and torch sees none")
        sim = Simulation(SimConfig(capacity=a.capacity), scenario=a.scenario)
        sim.run_checkpointed(a.frames, a.checkpoint, a.every)
        d = sim.measure()
        print(f"{a.frames} frames done; alive={d.n_alive} "
              f"E={float(d.kinetic + d.potential):.3f} -> {a.checkpoint}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
