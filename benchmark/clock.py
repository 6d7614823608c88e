"""Clocks and the card's name (a frozen copy of the port's benchmark clocks).

Device times come from CUDA events, host times from `time.perf_counter`, and
every result names the card it ran on. Nothing here falls back to the CPU:
`require_cards` raises where torch sees fewer cards than a cell needs.
"""

from __future__ import annotations

import subprocess
import time

import torch


def require_cards(n: int) -> None:
    """Raise unless torch sees at least n CUDA devices."""
    if not torch.cuda.is_available():
        raise RuntimeError("the benchmark runs on CUDA devices and torch sees none")
    if torch.cuda.device_count() < n:
        raise RuntimeError(f"the cell needs {n} CUDA devices and torch sees {torch.cuda.device_count()}")


def card(index: int = 0) -> str:
    """The card as `nvidia-smi --query-gpu=name,power.limit` reports it: its
    name and its power limit, which sets its clocks under load."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[index]


def sync(device: torch.device) -> None:
    """Wait for the device's work (nothing on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def stamp(device: torch.device):
    """A point in time on the device's clock: a recorded CUDA event on the
    card (it does not wait for the device), the host clock on the CPU."""
    if device.type == "cuda":
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event
    return time.perf_counter()


def wait(mark) -> None:
    """Wait until the device has passed `mark` (nothing for a host stamp)."""
    if not isinstance(mark, float):
        mark.synchronize()


def elapsed_s(start, end) -> float:
    """Seconds between two stamps; waits for the device to reach `end`."""
    if isinstance(start, float):
        return end - start
    end.synchronize()
    return start.elapsed_time(end) * 1e-3
