"""nbx_torch command-line interface.

    python -m nbx_torch bench throughput|drift|latency|granular|collsplit|spatial [args...]

Arguments are parsed as `python -m nbx` parses them: each all-digit argument
becomes an int, and they go positionally to the benchmark's main. The
benchmarks run on the card and raise where torch sees none. The JAX CLI's
`serve`, `demo` and `run` are not ported yet (ROADMAP.md Queue 1).
"""

from __future__ import annotations

import argparse
import importlib
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="nbx_torch", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)
    b = sub.add_parser("bench", help="benchmarks")
    b.add_argument("which", choices=["throughput", "drift", "latency", "granular", "collsplit", "spatial"])
    b.add_argument("args", nargs="*")
    a = p.parse_args(argv)
    importlib.import_module(f"nbx_torch.bench.{a.which}").main(
        *[int(x) if x.isdigit() else x for x in a.args]
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
