"""Device meshes for the port's multi-device paths (port of `make_mesh` of
`nbx/parallel/shard.py`).

A mesh here is a `torch.distributed.device_mesh.DeviceMesh` over the ranks of
an initialised process group, one rank a device: ("b",), or a factored 2-D
("bx", "by") mesh. Nothing here starts processes or names a cluster: the
caller runs `torch.distributed.init_process_group` in every rank, with its
address, world size and rank. The meshes are built on the card ("cuda", one
rank a card, NCCL) unless the caller asks for the CPU ("cpu", gloo).

The rest of `shard.py`, the all-gather paths, is not ported yet (ROADMAP.md
Queue 1, item 10b).
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def make_mesh(n_devices: int | None = None, axes=("b",), device_type: str = "cuda") -> DeviceMesh:
    """A 1-D mesh of n_devices ranks (default: the whole world) named
    axes[0], or with two axes a near-square factored 2-D mesh (a, n / a), a
    the largest divisor of n not above sqrt(n), as the JAX package factors
    it. Rank r sits at (r // (n / a), r % (n / a)). Every rank of the world
    must call it (a 2-D mesh makes a group for each row and column)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group (torch.distributed.init_process_group)")
    n = n_devices or dist.get_world_size()
    if n > dist.get_world_size():
        raise ValueError(f"a mesh of {n} ranks in a world of {dist.get_world_size()}")
    if len(axes) == 1:
        shape = (n,)
    elif len(axes) == 2:
        a = int(n**0.5)
        while n % a:
            a -= 1
        shape = (a, n // a)
    else:
        raise ValueError(f"make_mesh takes one or two axes, got {axes}")
    return DeviceMesh(device_type, torch.arange(n).reshape(shape), mesh_dim_names=tuple(axes))


@contextlib.contextmanager
def local_world(backend: str):
    """A process group of this process alone (rank 0 of a world of 1, an
    in-memory store) with `backend` ("nccl", "gloo", or "cpu:gloo,cuda:nccl"
    for meshes on the card and on the CPU in one process), for the spatial
    step on one device; destroyed on exit. If a group is initialised
    already, it is used as it is and left alone."""
    if dist.is_initialized():
        yield
        return
    dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()
