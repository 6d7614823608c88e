"""nbx_torch command-line interface.

    python -m nbx_torch serve [--port 8000] [--host 127.0.0.1] [--scenario galaxy] [--big [N]]
    python -m nbx_torch demo galaxy|merger|granular|orbit|spatial|merger_full [args...] [--device cpu]
    python -m nbx_torch bench throughput|drift|latency|granular|collsplit|spatial|microops [args...] [--device cpu]
    python -m nbx_torch run --scenario galaxy --frames 500 --checkpoint nbx_checkpoint.npz

`bench`: each all-digit argument becomes an int, and the arguments go
positionally to the benchmark's main, as `python -m nbx` passes them.
`run`: a headless run of `interactive.Simulation` at `--capacity`, snapshotted
every `--every` frames to `--checkpoint` (`Simulation.run_checkpointed`),
closing with one line of the final body count and energy. `serve`: the live
viewer (`serve.serve`); `--big` serves the at-scale granular path with N
bodies (131,072 when N is left out; the cloud or disk scenario), as the JAX
package's `python -m nbx.serve --big`. `demo`: the ports of `examples/`, each
`demos/<name>.py` with its example's positional arguments, all-digit ones as
ints: galaxy (n_frames, out_dir), merger (n, n_frames, out_dir), granular (n,
n_frames, out_dir, steps_per_frame), orbit (n_frames, out_dir,
steps_per_frame), spatial (n, n_steps, out_dir), merger_full (n, n_frames,
out_dir, steps_per_frame). Every command runs on the card and raises where
torch sees none; `demo --device cpu` and `bench --device cpu` run on the
CPU.
"""

from __future__ import annotations

import argparse
import importlib
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="nbx_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("serve", help="live interactive viewer server")
    s.add_argument("--port", type=int, default=8000)
    s.add_argument("--host", default="127.0.0.1",
                   help="bind address; endpoints are unauthenticated, pass 0.0.0.0 only to expose deliberately")
    s.add_argument("--scenario", default="galaxy")
    s.add_argument("--width", type=int, default=640)
    s.add_argument("--height", type=int, default=360)
    s.add_argument("--big", type=int, nargs="?", const=131072, default=0, metavar="N",
                   help="serve the at-scale granular path with N bodies (default 131072)")
    d = sub.add_parser("demo", help="render a demo scene to PNG frames")
    d.add_argument("which", choices=["galaxy", "merger", "granular", "orbit", "spatial", "merger_full"])
    d.add_argument("args", nargs="*")
    d.add_argument("--device", default="cuda")
    b = sub.add_parser("bench", help="benchmarks")
    b.add_argument("which", choices=["throughput", "drift", "latency", "granular", "collsplit", "spatial",
                                     "microops"])
    b.add_argument("args", nargs="*")
    b.add_argument("--device", default="cuda")
    r = sub.add_parser("run", help="headless run with checkpointing")
    r.add_argument("--scenario", default="galaxy")
    r.add_argument("--frames", type=int, default=500)
    r.add_argument("--checkpoint", default="nbx_checkpoint.npz")
    r.add_argument("--every", type=int, default=100)
    r.add_argument("--capacity", type=int, default=300)
    a = p.parse_args(argv)
    if a.cmd in ("serve", "run") or (a.cmd in ("demo", "bench") and a.device != "cpu"):
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError(f"{a.cmd} runs on a CUDA device and torch sees none")
    if a.cmd == "serve":
        from nbx_torch.serve import serve

        serve(a.port, scenario=a.scenario, width=a.width, height=a.height, host=a.host, big_n=a.big)
    elif a.cmd == "demo":
        demo = importlib.import_module(f"nbx_torch.demos.{a.which}")
        demo.main(*[int(x) if x.isdigit() else x for x in a.args], device=a.device)
    elif a.cmd == "bench":
        importlib.import_module(f"nbx_torch.bench.{a.which}").main(
            *[int(x) if x.isdigit() else x for x in a.args], device=a.device
        )
    elif a.cmd == "run":
        from nbx_torch.config import SimConfig
        from nbx_torch.interactive import Simulation

        sim = Simulation(SimConfig(capacity=a.capacity), scenario=a.scenario)
        sim.run_checkpointed(a.frames, a.checkpoint, a.every)
        d = sim.measure()
        print(f"{a.frames} frames done; alive={d.n_alive} "
              f"E={float(d.kinetic + d.potential):.3f} -> {a.checkpoint}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
