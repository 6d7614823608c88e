"""The device trace of a sub-window of calls, and what the metrics read in it.

`Recorder` runs torch.profiler (CUPTI on the card) over whole calls: it
synchronises and starts the profiler, meets the other ranks at a barrier
(the profiler's start takes each rank its own time, which the first traced
collective would otherwise wait out) or, on one rank, runs one small kernel
(the profiler's first kernel pays for its start: 3.3 ms of idle card), and
opens a `WINDOW` annotation; at the end it synchronises again before it
stops, so the annotation spans the traced calls from the first launch to the
last kernel's end. Once the measured
window has closed, `read` writes the chrome trace to a temporary file (in
TMPDIR), reads it into a `Trace` and deletes it.

A `Trace` holds the device operations (kernels, copies, sets) and the host
operations inside that span, in microseconds on the profiler's clock.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile

import torch

WINDOW = "benchmark.traced_window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
NAME_CHARS = 120  # the breakdown's names are cut to this length


@dataclasses.dataclass
class Trace:
    t0: float  # the window's start, us
    t1: float  # its end, us
    device: list  # [(name, start, end)] us, clipped to the window
    host: list  # [(name, start, end)] us
    calls: int  # whole calls inside the window

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def busy(self) -> list:
        """The union of the device operations' intervals, [(start, end)]."""
        spans = sorted((s, e) for _, s, e in self.device if e > s)
        out = []
        for s, e in spans:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [tuple(x) for x in out]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy()) * 1e-6

    def matching(self, patterns) -> list:
        """Device operations whose name holds one of `patterns` (any case)."""
        pats = [p.lower() for p in patterns]
        return [op for op in self.device if any(p in op[0].lower() for p in pats)]

    def device_s(self, patterns) -> float:
        return sum(e - s for _, s, e in self.matching(patterns)) * 1e-6

    def count(self, patterns) -> int:
        return len(self.matching(patterns))

    def top_ops(self, k: int = 10) -> list:
        """[[name, seconds]] of the k device operations that took most time,
        summed by name."""
        by = {}
        for name, s, e in self.device:
            by[name] = by.get(name, 0.0) + (e - s) * 1e-6
        top = sorted(by.items(), key=lambda kv: -kv[1])[:k]
        return [[name[:NAME_CHARS], sec] for name, sec in top]

    def idle_gaps(self, k: int = 10) -> list:
        """[[host operation, seconds]] of the k longest intervals in the
        window in which no device operation ran, each named by the innermost
        host operation running at its start ("no host operation" where none
        was)."""
        gaps, prev = [], self.t0
        for s, e in self.busy() + [(self.t1, self.t1)]:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:k]
        out = []
        for g0, g1 in gaps:
            inside = [(e - s, name) for name, s, e in self.host if s <= g0 < e and name != WINDOW]
            out.append([min(inside)[1][:NAME_CHARS] if inside else "no host operation", (g1 - g0) * 1e-6])
        return out


def parse(events: list, calls: int) -> Trace:
    """A Trace from a chrome trace's event list: the `WINDOW` annotation's
    span and the operations inside it."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    spans = [e for e in xs if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    if not spans:
        raise ValueError(f"the trace holds no {WINDOW} annotation")
    t0 = float(spans[0]["ts"])
    t1 = t0 + float(spans[0]["dur"])

    def ops(cats):
        out = []
        for e in xs:
            if e.get("cat") in cats:
                s, end = float(e["ts"]), float(e["ts"]) + float(e["dur"])
                if end > t0 and s < t1:
                    out.append((e["name"], max(s, t0), min(end, t1)))
        return out

    return Trace(t0, t1, ops(DEVICE_CATS), ops(HOST_CATS), calls)


class Recorder:
    """Traces the calls between `start` and `stop` on `device`; `barrier`
    (called after the profiler starts) lines the ranks up, None on one."""

    def __init__(self, device: torch.device, barrier=None):
        self.device = device
        self.barrier = barrier
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.span = torch.profiler.record_function(WINDOW)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self) -> None:
        self._sync()
        self.prof.start()
        if self.barrier is not None:
            self.barrier()
        elif self.device.type == "cuda":
            torch.ones(1, device=self.device).add_(1)
        self._sync()
        self.span.__enter__()

    def stop(self) -> None:
        self._sync()
        self.span.__exit__(None, None, None)
        self.prof.stop()

    def read(self, calls: int) -> Trace:
        """The trace of the `calls` whole calls between start and stop."""
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        return parse(events, calls)
