"""The benchmark of nbx_torch, the PyTorch and CUDA port: one run of one cell.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It runs the cell of BENCHMARK.json named by
--workload (set-up from --seed, a warm-up of the cell's own shapes, then a
window of about --seconds) and prints one JSON line last on standard output:
`correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end metrics
with --trace 0, its per-layer metrics with --trace 1), `device` (with
--trace 1 also `busy_s` and `window_s`, and `breakdown`), `card` (the card's
name and power limit) and, last, `checks`: each number compared with the
plain reference beside its limit. The same checks are the last lines on
standard error.

It exits non-zero and prints no result where torch sees no card or fewer
cards than the cell needs, where JAX or the JAX package (`nbx`) was loaded,
or where anything fails. A cell of several chips runs one process a card
(`benchmark.ranks`), rank r on card r, over NCCL; this process starts them,
waits for them under a time limit and prints rank 0's result once all have
ended.

Build and kernel caches stay in the checkout: the port builds its kernels in
`nbx_torch/_build/`, and the benchmark points PyTorch's and Triton's caches
at `.benchmark_cache/` here, so only a checkout's first run compiles.

For the tests and the control only (no run of the benchmark passes them):
--device cpu runs on the CPU over gloo without looking for a card; --set
key=value overrides a key of the configuration's file; --patch
module:function calls the function in every rank before set-up.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import tempfile
import time
from pathlib import Path

T0 = time.time()  # this process's start, as near as Python gets to it
ROOT = Path(__file__).resolve().parent.parent
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions", "TRITON_CACHE_DIR": "triton", "CUDA_CACHE_PATH": "nv"}
RANK_TIMEOUT_S = 330  # all ranks of a cell end within this, or are killed


def _args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda", help=argparse.SUPPRESS)
    ap.add_argument("--set", action="append", default=[], help=argparse.SUPPRESS)
    ap.add_argument("--patch", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--t0", type=float, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def _cell(args):
    from benchmark.spec import load_cell

    cell = load_cell(args.workload)
    for item in args.set:
        key, value = item.split("=", 1)
        cell.config[key] = json.loads(value)
    return cell


def _patch(spec) -> None:
    if spec:
        module, fn = spec.split(":")
        getattr(importlib.import_module(module), fn)()


def _emit(result: dict) -> int:
    """The result line last on stdout, the checks last on stderr; nothing
    and 1 where this process holds a forbidden module."""
    from benchmark.guard import forbidden_modules

    found = forbidden_modules()
    if found:
        print(f"benchmark: forbidden modules loaded: {found}", file=sys.stderr)
        return 1
    print(json.dumps(result), flush=True)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr, flush=True)
    return 0


def _run_here(args, cell, rank: int, world: int) -> dict | None:
    import torch

    from benchmark.harness import run_rank

    if args.device == "cuda":
        torch.cuda.set_device(rank)
        device = torch.device("cuda", rank)
    else:
        device = torch.device("cpu")
    _patch(args.patch)
    return run_rank(cell, args.seed, args.seconds, bool(args.trace), device, args.t0 if args.t0 else T0,
                    rank, world)


def _needs_cards(n: int) -> bool:
    """Whether torch sees n CUDA devices; says why on stderr where not."""
    from benchmark import clock

    try:
        clock.require_cards(n)
    except RuntimeError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return False
    return True


def _rank_main(args) -> int:
    """A rank of a cell of several chips: look for the cards, join the
    group, run, print rank 0's line; nothing and 1 where this process holds
    a forbidden module once everything has run."""
    import torch.distributed as dist

    if args.device == "cuda" and not _needs_cards(args.world):
        return 2
    cell = _cell(args)
    backend = "nccl" if args.device == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{args.port}", rank=args.rank,
                            world_size=args.world)
    try:
        result = _run_here(args, cell, args.rank, args.world)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    # the readers and the judge ran after the window's own look: look again
    # before the line, so that the launcher sees this rank fail
    from benchmark.guard import forbidden_modules

    found = forbidden_modules()
    if found:
        print(f"benchmark: forbidden modules loaded in rank {args.rank}: {found}", file=sys.stderr)
        return 1
    if result is not None:
        print(json.dumps(result), flush=True)
    return 0


def main(argv=None) -> int:
    args = _args(argv)
    cache = ROOT / ".benchmark_cache"
    for var, sub in CACHES.items():
        os.environ[var] = str(cache / sub)
    if args.rank is not None:
        return _rank_main(args)

    from benchmark import ranks, spec

    chips = spec.chips(args.workload)
    if chips == 1:
        if args.device == "cuda" and not _needs_cards(1):
            return 2
        return _emit(_run_here(args, _cell(args), 0, 1))
    # one process a card, each looking for the cards itself, so that this
    # process loads neither torch nor the program; rank 0's line comes back
    # through a file, so that it is printed after every rank has ended
    forward = list(argv if argv is not None else sys.argv[1:])
    with tempfile.TemporaryFile(mode="w+") as out:
        codes = ranks.launch(["-m", "benchmark.run", *forward, "--t0", repr(T0)], chips, RANK_TIMEOUT_S,
                             stdout=out)
        out.seek(0)
        lines = out.read().splitlines()
    if any(c != 0 for c in codes) or not lines:
        print(f"benchmark: ranks exited {codes}", file=sys.stderr)
        return 1
    for line in lines[:-1]:
        print(line)
    return _emit(json.loads(lines[-1]))


if __name__ == "__main__":
    sys.exit(main())
