"""Multi-host (multi-process) start-up, the host-major mesh and per-rank state
placement (port of `nbx/parallel/multihost.py`).

The JAX package runs one controller a host over `jax.distributed`; here every
rank is a process with one device, started by a launcher (torchrun, a job
scheduler, or the tests' spawner) and joined by `torch.distributed`:

  * `initialize()` calls `torch.distributed.init_process_group` from the
    standard launcher variables (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK,
    LOCAL_RANK; arguments override them). It is idempotent. On the card it
    binds the rank to card LOCAL_RANK and uses NCCL; with device="cpu", gloo.
  * `make_host_mesh()` builds the body-axis DeviceMesh in host-major order:
    each host's ranks sit contiguously on the axis, so the all-gather
    crosses between hosts once a host boundary. A host is named by
    GROUP_RANK (torchrun's node rank) or else the hostname; ranks must be
    numbered host-major (launchers number them so), because the all-gather
    paths place shard d on the rank at coordinate d.
  * `shard_state_multihost(mesh, pos, vel, mass)` builds a
    `parallel.shard.ShardedState` from this rank's own rows: no rank ever
    holds the global arrays.
  * checkpoints: `checkpoint.save_sharded` writes one file a rank and
    `load_sharded` re-shards on read onto a mesh of any size.
"""

from __future__ import annotations

import os
import socket
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from nbx_torch.config import CUDA


def _env(name: str, default=None):
    v = os.environ.get(name)
    return default if v is None or v == "" else v


def initialize(master_addr: Optional[str] = None, master_port: Optional[int] = None,
               world_size: Optional[int] = None, rank: Optional[int] = None, local_rank: Optional[int] = None,
               device=CUDA) -> None:
    """Join the process group (a no-op when one is initialised already).
    Arguments default to MASTER_ADDR (127.0.0.1), MASTER_PORT, WORLD_SIZE
    (1), RANK (0) and LOCAL_RANK (0). device: "cuda" binds this rank to card
    LOCAL_RANK and uses NCCL; "cpu" uses gloo."""
    if dist.is_initialized():
        return
    device = torch.device(device)
    addr = master_addr or _env("MASTER_ADDR", "127.0.0.1")
    port = master_port if master_port is not None else _env("MASTER_PORT")
    world = world_size if world_size is not None else int(_env("WORLD_SIZE", 1))
    me = rank if rank is not None else int(_env("RANK", 0))
    local = local_rank if local_rank is not None else int(_env("LOCAL_RANK", 0))
    if port is None:
        if world > 1:
            raise ValueError("a world of several ranks needs MASTER_PORT (or master_port)")
        init = dict(store=dist.HashStore())  # a world of one needs no rendezvous
    else:
        init = dict(init_method=f"tcp://{addr}:{int(port)}")
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize(device='cuda') needs a CUDA device and torch sees none")
        torch.cuda.set_device(local)
        backend = "nccl"
    elif device.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"device must be a CUDA device or the CPU, got {device}")
    dist.init_process_group(backend, world_size=world, rank=me, **init)


def host_key() -> str:
    """This rank's host: GROUP_RANK (the launcher's node rank) when set, else
    the hostname."""
    g = _env("GROUP_RANK")
    return f"node{int(g):06d}" if g is not None else socket.gethostname()


def host_major_order(keys: list) -> list:
    """The ranks sorted host-major, from each rank's (host, local rank) in
    rank order: hosts in the order of their lowest rank, ranks within a host
    by local rank."""
    first: dict = {}
    for r, (host, _) in enumerate(keys):
        first.setdefault(host, r)
    return sorted(range(len(keys)), key=lambda r: (first[keys[r][0]], keys[r][1], r))


def make_host_mesh(axis: str = "b", device_type: Optional[str] = None) -> DeviceMesh:
    """1-D mesh over every rank of the world, host-major: the ranks of a
    host are contiguous on the axis. Every rank must call it (it exchanges
    each rank's host and local rank). device_type: "cuda" or "cpu" (default:
    the process group's, "cuda" under NCCL). Raises ValueError when the ranks
    are not numbered host-major."""
    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh needs an initialised process group (multihost.initialize)")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    keys: list = [None] * dist.get_world_size()
    dist.all_gather_object(keys, (host_key(), int(_env("LOCAL_RANK", 0))))
    order = host_major_order(keys)
    if order != list(range(len(keys))):
        raise ValueError(f"ranks are not numbered host-major (hosts and local ranks by rank: {keys}); "
                         "number them host-major, as torchrun does")
    return DeviceMesh(device_type, torch.tensor(order), mesh_dim_names=(axis,))


def shard_state_multihost(mesh: DeviceMesh, pos, vel, mass):
    """A gravity-phase `parallel.shard.ShardedState` from THIS rank's rows
    (the rows of its coordinate on the host-major mesh; numpy or tensors): no
    rank holds the global state. Every rank must pass the same number of
    rows (pad with mass-0 bodies, which exert no force); acc starts at 0."""
    from nbx_torch.parallel.shard import ShardedState, mesh_device

    dev = mesh_device(mesh)
    n = torch.tensor([len(pos)], dtype=torch.int64, device=dev)
    lo, hi = n.clone(), n.clone()
    dist.all_reduce(lo, op=dist.ReduceOp.MIN)
    dist.all_reduce(hi, op=dist.ReduceOp.MAX)
    if int(lo) != int(hi):
        raise ValueError(f"ranks hold between {int(lo)} and {int(hi)} rows: pad every rank to the same count")

    def put(x):
        return torch.as_tensor(x).to(dev, torch.float32).contiguous()

    p = put(pos)
    return ShardedState(pos=p, vel=put(vel), acc=torch.zeros_like(p), mass=put(mass))
