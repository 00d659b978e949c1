"""Process groups as meshes (counterpart of batrack_tpu/parallel/mesh.py).

JAX drives a mesh of devices from one process with shard_map. PyTorch's
idiom is one process per GPU (torchrun), each holding one rank of a
torch.distributed process group; a `Mesh` here is that group with this
process's rank and device. The names follow the JAX package so that each
function has a visible counterpart:

- `get_mesh(n)`: the initialised group, which must have world size n. With
  no group and n == 1 it creates a one-rank group itself (an in-memory
  store, no port), which is how one GPU runs the multi-device code path.
- `init_distributed()`: joins the group torchrun describes in the
  environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT, LOCAL_RANK).
- `get_host_chip_mesh()`: the JAX package splits hosts from chips so that
  reductions stay on the chip interconnect before they cross hosts; NCCL
  picks its own intra- and inter-node paths, so a flat group serves it.
  This is a deviation: there is no (host, chip) axis pair here.
- `replicate_pytree_for_mesh` has no counterpart: it promotes process-local
  JAX arrays to global ones, and here every rank already holds full tensors.

Backends: NCCL for CUDA devices, gloo only where the caller asks for the CPU.

`shard_rows` and `gather_rows` move one axis between the replicated and the
sharded layout: rank r holds rows [r*n_loc, (r+1)*n_loc) of the axis padded
to a multiple of the world size.

`collective_counts()` reads what the package's collectives moved, as
`ops.launch_counts()` reads the kernels' launches: per op, the calls, the
elements and bytes, and the calls per "dtype[shape]". An all-gather counts
its whole gathered output (every rank's part, its own included, as an HLO
all-gather's output shape does), an all-reduce its buffer. The package has
two call sites, `gather_rows` and `ba/solver.py::all_reduce_sum`, and each
bumps the count of its own call; `reset_collective_counts()` sets them to 0.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from batrack_tpu_torch.utils.config import resolve_device

COLLECTIVES = ("all_gather", "all_reduce")
_collectives: dict = {}


@dataclass(frozen=True)
class Mesh:
    """One process's view of the group: the group, its rank, the world
    size and the device its tensors live on."""

    group: Any
    rank: int
    size: int
    device: torch.device


def _backend_for(dev: torch.device) -> str:
    return "nccl" if dev.type == "cuda" else "gloo"


def _local_cuda() -> torch.device:
    """torchrun's LOCAL_RANK GPU, else the current one."""
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", torch.cuda.current_device())))


def init_distributed(device="cuda") -> None:
    """Join the process group that torchrun describes in the environment.

    No-op when a group is already initialised, and for a plain
    single-process run (no WORLD_SIZE in the environment). On CUDA each
    process takes the GPU of its LOCAL_RANK as its current device. Raises
    when the group cannot be formed: a silent single-process run is the
    worst outcome for a job the user asked to distribute."""
    if dist.is_initialized() or "WORLD_SIZE" not in os.environ:
        return
    dev = resolve_device(device)
    rank = int(os.environ["RANK"])
    if dev.type == "cuda":
        torch.cuda.set_device(_local_cuda())
    dist.init_process_group(_backend_for(dev), init_method="env://", rank=rank,
                            world_size=int(os.environ["WORLD_SIZE"]))


def get_mesh(n_devices: Optional[int] = None, device="cuda") -> Mesh:
    """The process group as a Mesh of `n_devices` ranks (all of them when
    None). Raises when the group has another size, when no group exists
    and more than one rank is asked for, and when the group's backend does
    not serve `device` (NCCL for CUDA, gloo for the CPU)."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise RuntimeError(
                f"get_mesh({n_devices}): no process group is initialised; start one "
                "process per device (torchrun) and call init_distributed() first")
        dist.init_process_group(_backend_for(dev), store=dist.HashStore(), rank=0,
                                world_size=1)
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"get_mesh({n_devices}): the process group has {world} ranks")
    if dist.get_backend() != _backend_for(dev):
        raise ValueError(f"get_mesh: the group's backend {dist.get_backend()!r} does not "
                         f"serve device {dev} (NCCL for CUDA, gloo for the CPU)")
    if dev.type == "cuda" and dev.index is None:
        dev = _local_cuda()
    return Mesh(dist.group.WORLD, rank, world, dev)


def mesh_device(mesh: Mesh, device: torch.device) -> torch.device:
    """The mesh's device, checked against the one an entry point was given
    (a bare "cuda" matches the mesh's GPU)."""
    if mesh.device.type != device.type or (device.index is not None and mesh.device != device):
        raise ValueError(f"the mesh lives on {mesh.device}, the caller asked for {device}")
    return mesh.device


def get_host_chip_mesh(device="cuda") -> Mesh:
    """The JAX package's (host, chip) mesh; a flat group here (module note)."""
    return get_mesh(None, device)


def shard_rows(x: torch.Tensor, mesh: Mesh, dim: int = 0) -> torch.Tensor:
    """This rank's rows of axis `dim`, the axis zero-padded to a multiple of
    the world size first (padded rows are all zero, or False)."""
    n = x.shape[dim]
    n_loc = -(-n // mesh.size)
    lo = mesh.rank * n_loc
    rows = x.narrow(dim, min(lo, n), max(0, min(n_loc, n - lo)))
    pad = n_loc - rows.shape[dim]
    if pad == 0:
        return rows
    widths = [0, 0] * (x.ndim - 1 - dim % x.ndim) + [0, pad]
    if x.dtype == torch.bool:
        return F.pad(rows.to(torch.uint8), widths).bool()
    return F.pad(rows, widths)


def reset_collective_counts() -> None:
    """Set every collective's count to 0 (module note)."""
    _collectives.clear()
    _collectives.update({op: {"calls": 0, "elements": 0, "bytes": 0, "shapes": {}}
                         for op in COLLECTIVES})


def collective_counts() -> dict:
    """A copy of the counts since the last reset (module note)."""
    return {op: {**c, "shapes": dict(c["shapes"])} for op, c in _collectives.items()}


def count_collective(op: str, dtype: torch.dtype, shape) -> None:
    """One call of collective `op` whose output (all_gather) or buffer
    (all_reduce) has `dtype` and `shape`."""
    c = _collectives[op]
    numel = math.prod(shape)
    c["calls"] += 1
    c["elements"] += numel
    c["bytes"] += numel * dtype.itemsize
    key = f"{str(dtype).removeprefix('torch.')}[{','.join(map(str, shape))}]"
    c["shapes"][key] = c["shapes"].get(key, 0) + 1


reset_collective_counts()


def gather_rows(x: torch.Tensor, mesh: Mesh, n: int, dim: int = 0) -> torch.Tensor:
    """All ranks' rows of axis `dim` in rank order, cut to the first `n`
    (the inverse of shard_rows): one all-gather."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x, group=mesh.group)
    full = list(x.shape)
    full[dim] *= mesh.size
    count_collective("all_gather", x.dtype, full)
    return torch.cat(parts, dim=dim).narrow(dim, 0, n)
