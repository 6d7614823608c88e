"""One process a card: the pattern of the port's sharded benchmark, frozen.

`launch` starts `world` copies of a command, rank r told its rank, the world
size and a port on 127.0.0.1 where the ranks meet (torch.distributed's
`tcp://` rendezvous); the standard output of every rank but 0 goes to
nothing. It waits for every rank under one time limit; once a rank fails, or
the limit passes, it kills the ranks still running. It reaps every rank, so
no process outlives it.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def launch(argv: list, world: int, timeout_s: float, stdout=None) -> list:
    """Run `python <argv> --world world --port p --rank r` for r < world,
    rank 0's standard output to `stdout` (this process's by default);
    returns the exit codes (None for a rank that was killed)."""
    port = free_port()
    cmd = [sys.executable, *argv, "--world", str(world), "--port", str(port)]
    env = dict(os.environ, PYTHONUNBUFFERED="1")
    procs = [subprocess.Popen(cmd + ["--rank", str(r)], env=env, stdout=stdout if r == 0 else subprocess.DEVNULL)
             for r in range(world)]
    deadline = time.monotonic() + timeout_s
    try:
        while time.monotonic() < deadline:
            codes = [p.poll() for p in procs]
            if all(c is not None for c in codes) or any(c not in (None, 0) for c in codes):
                break
            time.sleep(0.1)
    finally:
        killed = set()
        for r, p in enumerate(procs):
            if p.poll() is None:
                p.kill()
                killed.add(r)
            p.wait()
    return [None if r in killed else p.returncode for r, p in enumerate(procs)]
