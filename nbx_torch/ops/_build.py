"""Build and load the port's CUDA kernels at first use.

Each `nbx_torch/csrc/<name>.cu` exposes a plain C entry point. It is compiled
with nvcc into `nbx_torch/_build/lib<name>-<hash>.so` (the directory is in
.gitignore) and loaded with ctypes; the hash covers the source, the shared
headers (csrc/*.cuh) and the flags, so an edited source or header is rebuilt. A failed build raises with nvcc's output.
`build_all` compiles every kernel of `KERNELS` at once, one nvcc each.

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

# Every kernel of the port, by source name (csrc/<name>.cu).
KERNELS = ("pairwise_f32r", "collide_fused", "pp_short", "pp_react", "pairwise_accjerk", "potential",
           "pairwise_precision", "pairwise_mxu", "pairwise_fast", "cvt_rate", "collide_sequential")

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


def library_path(name: str) -> Path:
    """Where csrc/<name>.cu's library goes, by the hash of the source, every
    shared header and the flags."""
    digest = hashlib.sha256()
    for path in (SRC_DIR / f"{name}.cu", *sorted(SRC_DIR.glob("*.cuh"))):
        digest.update(path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for csrc/<name>.cu into a temporary file, or return None
    if the library exists."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(SRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, cmd, tmp, out


def _finish(job) -> None:
    proc, cmd, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)  # atomic: concurrent builders never load a partial file


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless a library of the same hash exists.
    nvcc's output is kept beside the library as <lib>.log."""
    job = _start(name)
    if job is not None:
        _finish(job)
    return library_path(name)


def build_all(names=KERNELS) -> list[Path]:
    """Compile every named kernel, all nvcc processes started together."""
    jobs = [job for job in map(_start, names) if job is not None]
    try:
        for job in jobs:
            _finish(job)
    finally:
        for proc, *_ in jobs:  # a failed build leaves no nvcc behind
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return [library_path(name) for name in names]


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The built library for csrc/<name>.cu, compiled if needed."""
    return ctypes.CDLL(str(build(name)))
