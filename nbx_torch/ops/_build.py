"""Build and load the port's CUDA kernels at first use.

Each `nbx_torch/csrc/<name>.cu` exposes a plain C entry point. It is compiled
with nvcc into `nbx_torch/_build/lib<name>-<hash>.so` (the directory is in
.gitignore) and loaded with ctypes; the hash covers the source and the flags,
so an edited source is rebuilt. A failed build raises with nvcc's output.

No PyTorch headers are included, so a build takes seconds, not the minutes of
`torch.utils.cpp_extension.load`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills into the build log
)


def nvcc_path() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless a library of the same hash exists.
    nvcc's output is kept beside the library as <lib>.log."""
    src = SRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    out = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}"
        )
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)  # atomic: concurrent builders never load a partial file
    return out


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The built library for csrc/<name>.cu, compiled if needed."""
    return ctypes.CDLL(str(build(name)))
