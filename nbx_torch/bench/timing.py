"""Clocks and device names for the port's benchmarks.

A benchmark runs on the device its caller names, the card by default; it
raises where torch sees no CUDA device rather than run on the CPU. Times come
from CUDA events on the card and from the host clock on a CPU run (asked for
with device="cpu"), and every result names the device it ran on.
"""

from __future__ import annotations

import subprocess
import time

import torch


def require(device) -> torch.device:
    """`device` as a torch.device; raises if it is a CUDA device and torch
    sees none."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("this benchmark runs on a CUDA device and torch sees none "
                           "(pass device='cpu' to run it on the CPU)")
    return device


def device_name(device: torch.device) -> str:
    """The card as `nvidia-smi --query-gpu=name,power.limit` reports it, or
    "cpu"."""
    if device.type != "cuda":
        return "cpu"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[device.index or 0]


def stamp(device: torch.device):
    """A point in time on the device's clock: a recorded CUDA event on the
    card (it does not wait for the device), the host clock on the CPU."""
    if device.type == "cuda":
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event
    return time.perf_counter()


def elapsed_ms(start, end) -> float:
    """Milliseconds between two stamps; waits for the device to reach `end`."""
    if isinstance(start, float):
        return (end - start) * 1e3
    end.synchronize()
    return start.elapsed_time(end)
