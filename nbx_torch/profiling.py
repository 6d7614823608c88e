"""Tracing, timing and observability (port of `nbx/profiling.py`).

  * trace(): a torch.profiler trace of the enclosed block, the card's
    kernels included where there is one, written as a Chrome trace
  * StepTimer: wall-clock step latency with percentiles
  * MetricsLogger: a JSONL sink for per-step diagnostics
  * nan_guard(): raise at the op that produced a NaN (tests and debugging
    only: it reads every op's output back to the host)
  * check_finite(): a host-side check that every float tensor of a state,
    a dict or a sequence is finite
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import tempfile
import time
from dataclasses import dataclass, field

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Profile the enclosed block with torch.profiler (CPU ops, and CUDA
    kernels when torch sees a card) and write a Chrome trace,
    `<log_dir>/trace.json` (log_dir defaults to a directory under the
    temporary directory). Yields log_dir."""
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "nbx_torch-trace")
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield log_dir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@dataclass
class StepTimer:
    """Wall-clock step latency with percentiles.

    Usage:
        timer = StepTimer()
        for _ in range(steps):
            with timer:
                state, ev = sim.step(state, cfg)
                torch.cuda.synchronize()
        print(timer.summary())
    """

    samples_ms: list = field(default_factory=list)
    _t0: float = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.samples_ms.append((time.perf_counter() - self._t0) * 1e3)
        return False

    def percentile(self, p: float) -> float:
        return float(np.percentile(self.samples_ms, p)) if self.samples_ms else 0.0

    @property
    def p50(self) -> float:
        return self.percentile(50)

    @property
    def p99(self) -> float:
        return self.percentile(99)

    def summary(self) -> dict:
        return {
            "n": len(self.samples_ms),
            "p50_ms": self.p50,
            "p90_ms": self.percentile(90),
            "p99_ms": self.p99,
            "mean_ms": float(np.mean(self.samples_ms)) if self.samples_ms else 0.0,
        }


def _plain(v):
    """A tensor, numpy value or Python scalar as JSON-ready Python values."""
    if isinstance(v, torch.Tensor):
        return v.item() if v.ndim == 0 else v.tolist()
    a = np.asarray(v)
    return a.item() if a.ndim == 0 else a.tolist()


class MetricsLogger:
    """Append-only JSONL metrics sink for per-step diagnostics (energy,
    momentum, body count, event counters)."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "a")

    def log(self, step: int, **metrics) -> None:
        rec = {"step": step, **{k: _plain(v) for k, v in metrics.items()}}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class _NanGuard(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and (t.is_floating_point() or t.is_complex()) and bool(t.isnan().any()):
                raise FloatingPointError(f"NaN produced by {func}")
        return out


@contextlib.contextmanager
def nan_guard():
    """Raise FloatingPointError at the op that produces a NaN, for the
    enclosed block. Every op's output is read back to the host, so it is for
    tests and debugging only."""
    with _NanGuard():
        yield


def _walk(obj, path: str):
    """(path, tensor) for every tensor in dataclasses, dicts and sequences."""
    if isinstance(obj, torch.Tensor):
        yield path, obj
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from _walk(getattr(obj, f.name), f"{path}.{f.name}")
    elif isinstance(obj, tuple) and hasattr(obj, "_fields"):  # a NamedTuple
        for name in obj._fields:
            yield from _walk(getattr(obj, name), f"{path}.{name}")
    elif isinstance(obj, dict):
        for k, v in obj.items():
            yield from _walk(v, f"{path}[{k!r}]")
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            yield from _walk(v, f"{path}[{i}]")


def check_finite(obj, name: str = "state") -> None:
    """Raise FloatingPointError, naming the field, if any float tensor in
    `obj` (a dataclass such as SimState, a dict or a sequence of them) holds
    a NaN or an infinity. Reads each tensor back to the host."""
    for path, t in _walk(obj, ""):
        if t.is_floating_point() and not bool(torch.isfinite(t).all()):
            raise FloatingPointError(f"non-finite values in {name}{path}")
