"""Runs of the benchmark's command at test sizes, for the tests."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SIZES = {"disk262k.gravity": 1024, "merger1m_allgather.d4": 4096}  # bodies at test size


def run(workload: str, seed: int = 12345, trace: int = 0, patch: str | None = None, seconds: float = 0.3,
        timeout: float = 300, device: str = "cpu", n: int | None = None,
        stdout: bool = False) -> tuple[int, dict | str | None, str]:
    """(exit code, the result line or None, stderr) of one run of the cell
    at `n` bodies (its test size by default), on the CPU unless `device` is
    "cuda"; with `stdout`, the whole standard output in place of the line."""
    cmd = [sys.executable, "-m", "benchmark.run", "--workload", workload, "--seed", str(seed),
           "--seconds", str(seconds), "--trace", str(trace), "--device", device,
           "--set", f"n={n or SIZES[workload]}"]
    if patch:
        cmd += ["--patch", patch]
    env = dict(os.environ, OMP_NUM_THREADS="2")
    p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=timeout, env=env)
    if stdout:
        return p.returncode, p.stdout, p.stderr
    lines = p.stdout.strip().splitlines()
    return p.returncode, (json.loads(lines[-1]) if p.returncode == 0 and lines else None), p.stderr
