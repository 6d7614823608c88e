"""One run of one cell on one rank: set-up, the measured window, the trace,
the metrics and the judgement.

A configuration's module (`benchmark/configs/<config>.py`) has
`setup(ctx: Setup) -> Program`. The harness then:

 1. warms up: WARMUP_CALLS calls, then PROBE_CALLS timed ones (synchronised)
    that fix the window's number of calls, the same on every rank:
    max(MIN_CALLS, seconds / the slowest rank's call);
 2. runs the window: that many calls of `program.call`, nothing read back to
    the host. A CUDA event after each call times it on the device; before
    call k the host waits for the event of call k - DEPTH, so the host never
    runs more than DEPTH calls ahead and a call's host time is its own.
    The window ends in a synchronise. With --trace 1, TRACE_SECONDS of
    whole calls in its middle run under the profiler;
 3. once it has closed: the memory peak, the program's failure counters, the
    metrics' readers, and the program's judgement of the configuration's
    `judged_calls` calls of the window (the last, and the rest drawn from
    the seed) against the plain reference.
"""

from __future__ import annotations

import dataclasses
import math
import random
import sys
import time

import torch
import torch.distributed as dist

from benchmark import clock
from benchmark.guard import forbidden_modules
from benchmark.trace import Recorder, Trace

WARMUP_CALLS = 3  # calls before the probe: the first builds, loads and allocates
PROBE_CALLS = 3  # synchronised calls whose mean time fixes the window's calls
MIN_CALLS = 40  # the fewest calls a window runs, however long a call
DEPTH = 2  # the calls the host may run ahead of the card
TRACE_SECONDS = 1.5  # the traced sub-window, whole calls in the window's middle


@dataclasses.dataclass
class Setup:
    """What a configuration's `setup` is given."""

    config: dict  # the configuration's file
    traffic: dict  # the traffic mix's file
    seed: int
    device: torch.device
    rank: int = 0
    world: int = 1


class Program:
    """What `setup` returns: the system under test, set up.

    `state` is the state the first call takes; `call(state)` is one call of
    the cell's entry and returns the next state (new tensors: the harness
    keeps the input and output of the calls it judges); `steps_per_call`
    counts the physics steps in a call. `judge(samples)` compares the calls
    [(input state, output state)] with the plain reference and returns
    {name: number}, each held to the configuration's `limits[name]`;
    `failed()` counts the calls whose own counters say work was left out."""

    state = None
    steps_per_call = 1

    def call(self, state):
        raise NotImplementedError

    def judge(self, samples: list) -> dict:
        raise NotImplementedError

    def failed(self) -> int:
        return 0


@dataclasses.dataclass
class RunData:
    """What a metric's reader is given: one rank's run."""

    config: dict  # the configuration's file
    chips: int  # ranks, one a card
    kind: str  # the card's name (torch.cuda.get_device_name), "cpu" off the card
    setup_s: float  # process start to the window's start
    window_s: float  # the window, host clock, ended by a synchronise
    calls: int
    steps_per_call: int
    host_call_s: list  # host time of each call of the window
    call_s: list  # device time of each call (between CUDA events)
    traced: range  # the calls under the profiler (empty without --trace 1)
    trace: Trace | None


def _max_over_ranks(values: list, device, world: int) -> list:
    """Each value's maximum over the ranks (NaN counts as +inf)."""
    if world == 1:
        return values
    t = torch.tensor([v if v == v else math.inf for v in values], dtype=torch.float64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return t.tolist()


def run_rank(cell, seed: int, seconds: float, trace: bool, device: torch.device, t0: float,
             rank: int = 0, world: int = 1) -> dict | None:
    """One rank's run of `cell` (spec.Cell). Returns rank 0's result line as
    a dict (None on other ranks). Raises RuntimeError where a forbidden
    module was loaded."""
    started = time.time()
    program = cell.module.setup(Setup(cell.config, cell.traffic, seed, device, rank, world))
    set_up = time.time()
    state = program.state
    for _ in range(WARMUP_CALLS):
        state = program.call(state)
    clock.sync(device)
    probe0 = time.perf_counter()
    for _ in range(PROBE_CALLS):
        state = program.call(state)
    clock.sync(device)
    (call_s,) = _max_over_ranks([(time.perf_counter() - probe0) / PROBE_CALLS], device, world)
    n = max(MIN_CALLS, math.ceil(seconds / call_s))
    checked = {n - 1, *random.Random(seed).sample(range(n - 1), cell.config["judged_calls"] - 1)}
    traced = range(0)
    if trace:
        span = min(n // 2, max(2, math.ceil(TRACE_SECONDS / call_s)))
        traced = range((n - span) // 2, (n - span) // 2 + span)
    recorder = Recorder(device, dist.barrier if world > 1 else None) if trace else None
    depth = DEPTH

    if world > 1:
        dist.barrier()
    clock.sync(device)
    marks, host_s, samples, got = [None] * n, [0.0] * n, [], None
    start = clock.stamp(device)
    wall0, w0 = time.time(), time.perf_counter()
    for k in range(n):
        if k >= depth:
            clock.wait(marks[k - depth])
        if trace and k == traced.start:
            recorder.start()
        h0 = time.perf_counter()
        out = program.call(state)
        host_s[k] = time.perf_counter() - h0
        marks[k] = clock.stamp(device)
        if k in checked:
            samples.append((state, out))
        state = out
        if trace and k == traced.stop - 1:
            recorder.stop()
    clock.sync(device)
    window_s = time.perf_counter() - w0
    if trace:
        got = recorder.read(len(traced))

    found = forbidden_modules()
    if found:
        raise RuntimeError(f"forbidden modules loaded in the measured process: {found}")
    call_times = [clock.elapsed_s(a, b) for a, b in zip([start] + marks[:-1], marks)]
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    failed = program.failed()
    del state, out
    run = RunData(cell.config, world, torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                  wall0 - t0, window_s, n, program.steps_per_call, host_s, call_times, traced, got)
    metrics = cell.per_layer if trace else cell.end_to_end
    values = {m.name: m.reader.read(run) for m in metrics}

    judge0 = time.perf_counter()
    numbers = program.judge(samples)
    judge_s = time.perf_counter() - judge0
    names = sorted(numbers)
    worst = dict(zip(names, _max_over_ranks([float(numbers[k]) for k in names], device, world)))
    limits = cell.config["limits"]
    checks = {k: {"value": worst[k], "limit": limits[k]} for k in names}
    correct = all(c["value"] <= c["limit"] for c in checks.values()) and set(names) == set(limits)

    mine = dict(values=values, peak=peak, busy=got.busy_s if got else None,
                window=got.window_s if got else None)
    every = [None] * world
    if world > 1:
        dist.all_gather_object(every, mine)
    else:
        every = [mine]
    failed = int(_max_over_ranks([float(failed)], device, world)[0])
    if rank != 0:
        return None
    print(f"benchmark: {n} calls in {window_s!r} s; set-up {wall0 - t0!r} s (to the program's set-up "
          f"{started - t0!r}, the set-up {set_up - started!r}, warm-up {wall0 - set_up!r}); the reference "
          f"{judge_s!r} s", file=sys.stderr, flush=True)

    def mean(xs):
        xs = [x for x in xs if x is not None]
        return sum(xs) / len(xs) if xs else None

    out_metrics = {}
    for m in metrics:
        v = mean([e["values"][m.name] for e in every]) if trace else values[m.name]
        if v is not None:
            out_metrics[m.name] = {"value": v, "unit": m.unit}
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": run.kind, "count": world,
           "memory_peak_bytes": max(e["peak"] for e in every)}
    result = {"correct": correct, "attempted": n, "failed": failed, "metrics": out_metrics, "device": dev}
    if trace:
        dev["busy_s"] = mean([e["busy"] for e in every])
        dev["window_s"] = mean([e["window"] for e in every])
        result["breakdown"] = {"device_ops": got.top_ops(), "idle_gaps": got.idle_gaps()}
    if device.type == "cuda":
        result["card"] = clock.card(device.index or 0)
    result["checks"] = checks
    return result
