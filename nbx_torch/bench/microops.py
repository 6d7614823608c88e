"""Micro-benchmark: the scatter-shaped primitives of the collision event
machinery against their scatter-free forms (port of `nbx/bench/microops.py`).

Each primitive has two forms that give the same result:

  * take_rows (first K set rows of a mask): a rank scatter (`take_scatter`)
    or binary searches over the mask's cumsum (`take_search`, the form of
    `ops.p3m.take_rows`);
  * the kill flags of merge secondaries: a scatter of True at the partners
    of the primaries (`kill_scatter`) or `mask & (i > partner)`
    (`kill_arith`); the two agree where partners are mutual and the mask
    holds both bodies of each pair, which the collision paths guarantee.
    The probe's random `partner` times them and does not compare them;
  * the inverse permutation: a scatter of arange (`inv_scatter`, the form of
    `ops.p3m.inverse_permutation`) or an argsort (`inv_argsort`).

The forms the port carried over were chosen on a TPU, where every scatter
lost; this probe says which form the card prefers.

Each variant runs STEPS chained iterations, each one's result rotating the
next iteration's mask (and the permutation by the running sum) on the
device, so no iteration can be skipped or read back; the rotation is a
gather with a device-valued shift, never a host integer. Time between two
stamps (`bench.timing`: CUDA events on the card, the host clock with
device="cpu"), best of 3 after a warm-up run, all variants in one process.
One JSON line a variant: {"n", "variant", "us_per_op", "graph_us_per_op",
"device"}. The eager loop launches each iteration's 10-15 kernels from the
host; where those launches take longer than the kernels' work, us_per_op
times the host. So on the card the chain is also captured as one CUDA graph
and replayed (graph_us_per_op: the kernels' time alone).

    python -m nbx_torch bench microops [n ...]   # default 131072 1048576
    python -m nbx_torch.bench.microops [n ...]
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from nbx_torch.bench import timing
from nbx_torch.config import CUDA

K = 256  # extraction cap (f_cap * frag_k scale)
STEPS = 300
NS = (131072, 1048576)
VARIANTS = ("take_scatter", "take_search", "kill_scatter", "kill_arith", "inv_scatter", "inv_argsort")
_I32 = torch.int32


def take_scatter(mask: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """First k set rows by a rank scatter -> (idx [k] i32, valid [k]);
    invalid entries hold N - 1."""
    n = mask.shape[0]
    rank = torch.cumsum(mask.to(_I32), 0, dtype=_I32) - 1
    tgt = torch.where(mask & (rank < k), rank, k)  # k: the pad slot
    idx = torch.full((k + 1,), n, dtype=_I32, device=mask.device)
    idx = idx.scatter(0, tgt.long(), torch.arange(n, dtype=_I32, device=mask.device))[:k]
    return idx.clamp(max=n - 1), idx < n


def take_search(mask: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """First k set rows by binary searches over the cumsum."""
    n = mask.shape[0]
    csum = torch.cumsum(mask.to(_I32), 0, dtype=_I32)
    want = torch.arange(1, k + 1, dtype=_I32, device=mask.device)
    idx = torch.searchsorted(csum, want).to(_I32)
    return idx.clamp(max=n - 1), want <= csum[-1]


def kill_scatter(mask: torch.Tensor, partner: torch.Tensor) -> torch.Tensor:
    """True at the partner of every primary (mask & i < partner)."""
    n = mask.shape[0]
    prim = mask & (torch.arange(n, dtype=_I32, device=mask.device) < partner)
    out = torch.zeros((n + 1,), dtype=torch.bool, device=mask.device)  # n: the pad slot
    return out.scatter(0, torch.where(prim, partner, n).long(), torch.ones_like(prim))[:n]


def kill_arith(mask: torch.Tensor, partner: torch.Tensor) -> torch.Tensor:
    """The secondaries of mutual pairs: mask & i > partner."""
    return mask & (torch.arange(mask.shape[0], dtype=_I32, device=mask.device) > partner)


def inv_scatter(order: torch.Tensor) -> torch.Tensor:
    """inv [N] i32 with inv[order[p]] = p, by a scatter."""
    n = order.shape[0]
    return torch.zeros((n,), dtype=_I32, device=order.device).scatter(
        0, order.long(), torch.arange(n, dtype=_I32, device=order.device))


def inv_argsort(order: torch.Tensor) -> torch.Tensor:
    """inv by an argsort."""
    return torch.argsort(order).to(_I32)


def roll(x: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """np.roll(x, shift) for a device-valued shift: a gather, no host read."""
    n = x.shape[0]
    return x[torch.remainder(torch.arange(n, device=x.device) - shift, n)]


def _out(variant: str, mask, partner, order, acc) -> torch.Tensor:
    """One iteration's result (int64 [])."""
    if variant in ("take_scatter", "take_search"):
        idx, valid = (take_scatter if variant == "take_scatter" else take_search)(mask, K)
        return torch.where(valid, idx, 0).sum()
    if variant in ("kill_scatter", "kill_arith"):
        return (kill_scatter if variant == "kill_scatter" else kill_arith)(mask, partner).sum()
    if variant in ("inv_scatter", "inv_argsort"):
        return (inv_scatter if variant == "inv_scatter" else inv_argsort)(roll(order, acc % 7)).sum()
    raise ValueError(f"unknown variant {variant!r}")


def chain(mask0, partner, order, variant: str, steps: int) -> torch.Tensor:
    """steps chained iterations of a variant; returns the running sum of
    their results (int64 [], on the device)."""
    mask, acc = mask0, torch.zeros((), dtype=torch.int64, device=mask0.device)
    for _ in range(steps):
        out = _out(variant, mask, partner, order, acc)
        mask = roll(mask, out % 3 + 1)  # data dependency on the result
        acc = acc + out
    return acc


def probe_inputs(n: int, device, seed: int = 0):
    """(mask0 with 1% set, a random partner table, a random permutation),
    from one numpy generator as the JAX package draws them."""
    rng = np.random.default_rng(seed)
    mask0 = torch.from_numpy(rng.random(n) < 0.01)
    partner = torch.from_numpy(rng.integers(0, n, n, dtype=np.int32))
    order = torch.from_numpy(rng.permutation(n).astype(np.int32))
    return tuple(x.to(device) for x in (mask0, partner, order))


def mutual_input(n: int, device, seed: int = 3):
    """(mask, partner) where the two kill forms must agree: partner a
    random involution (every body paired with another, both ways) and the
    mask holding both bodies of each pair it holds."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    partner = np.empty(n, np.int32)
    partner[perm[0::2]] = perm[1::2]
    partner[perm[1::2]] = perm[0::2]
    mask = rng.random(n) < 0.1
    mask = mask | mask[partner]
    return torch.from_numpy(mask).to(device), torch.from_numpy(partner).to(device)


def graph_us_per_op(inputs, variant: str) -> float:
    """Best of 3 replays of the chain captured as one CUDA graph, in us an
    iteration: the device's time for the variant's kernels without the
    host's launches."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # capture wants its allocations warmed off the default stream
        chain(*inputs, variant, 3)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        chain(*inputs, variant, STEPS)
    graph.replay()
    best = float("inf")
    for _ in range(3):
        t0 = timing.stamp(inputs[0].device)
        graph.replay()
        best = min(best, timing.elapsed_ms(t0, timing.stamp(inputs[0].device)))
    return best / STEPS * 1e3


def main(*ns: int, device=CUDA) -> list:
    """Time every variant at each n (default 131,072 and 1,048,576): one
    JSON line a variant, us_per_op the eager loop's (the host's launches
    included) and, on the card, graph_us_per_op the same chain replayed as
    one CUDA graph (None on the CPU). Returns the lines' dicts."""
    device = timing.require(device)
    name = timing.device_name(device)
    rows = []
    for n in ns or NS:
        inputs = probe_inputs(n, device)
        for variant in VARIANTS:
            int(chain(*inputs, variant, STEPS))  # warm-up
            best = float("inf")
            for _ in range(3):
                t0 = timing.stamp(device)
                acc = chain(*inputs, variant, STEPS)
                t1 = timing.stamp(device)
                best = min(best, timing.elapsed_ms(t0, t1))
                int(acc)
            graph_us = graph_us_per_op(inputs, variant) if device.type == "cuda" else None
            rows.append(dict(n=n, variant=variant, us_per_op=best / STEPS * 1e3, graph_us_per_op=graph_us,
                             device=name))
            print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    main(*(int(x) for x in sys.argv[1:]))
