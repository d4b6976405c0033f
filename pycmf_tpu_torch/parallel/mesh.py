"""The process group a sharded fit runs over, and its collectives.

Counterpart of ``pycmf_tpu/parallel/mesh.py:make_mesh``. The reference is
one process that drives every device through ``shard_map`` over a mesh;
the port is one process per shard, each a rank of a ``torch.distributed``
process group (launched, for example, by ``torchrun --nproc-per-node N``).
Whoever creates the group names its backend: NCCL across cards, gloo
across CPU processes (or CUDA tensors through the host). The port chooses
no backend and never switches one.

Every reduction of a sharded fit goes through :func:`all_reduce`, which
packs the terms summed at one point into one buffer and one collective,
and counts the calls, bytes and host time in :data:`COMM` (with CUDA-event
times when ``COMM.timed`` is set).
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, List, NamedTuple, Tuple

import torch
import torch.distributed as dist

AXIS = "shards"


class Mesh(NamedTuple):
    """A sharded fit's process group, this process's rank in it, the
    group's size, and the device this rank computes on."""

    group: Any
    rank: int
    world: int
    device: torch.device


def rank_device(rank: int, device="cuda") -> torch.device:
    """This rank's device: the CPU under ``device='cpu'``; an explicit
    ``cuda:i`` as given; else ``cuda:$LOCAL_RANK`` when that is set, else
    ``cuda:{rank % device_count}``."""
    dev = torch.device(device)
    if dev.type == "cpu" or dev.index is not None:
        return dev
    if dev.type != "cuda":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {dev}")
    local = os.environ.get("LOCAL_RANK")
    if local is not None:
        return torch.device("cuda", int(local))
    return torch.device("cuda", rank % torch.cuda.device_count())


def _launch_hint(n_devices) -> str:
    return (f"launch one process per shard (for example torchrun "
            f"--nproc-per-node {n_devices or 'N'}) and initialize a process "
            f"group in each")


def group_size(group=None, n_devices: int | None = None) -> int:
    """The size of ``group`` (default: the default process group); raises
    ValueError when no group is initialized."""
    if not dist.is_available() or not dist.is_initialized():
        raise ValueError(
            f"requested {n_devices or 'all'} devices but only 1 available: "
            f"no torch.distributed process group is initialized; "
            f"{_launch_hint(n_devices)}")
    return dist.get_world_size(group)


def make_mesh(n_devices: int | None = None, group=None,
              device="cuda") -> Mesh:
    """The mesh of a sharded fit over ``group`` (default: the default
    process group). Raises ValueError when no group is initialized or when
    ``n_devices`` is not the group's size."""
    world = group_size(group, n_devices)
    if n_devices is not None and n_devices != world:
        raise ValueError(
            f"requested {n_devices} devices but the process group has "
            f"{world}; {_launch_hint(n_devices)}")
    rank = dist.get_rank(group)
    return Mesh(group, rank, world, rank_device(rank, device))


@dataclasses.dataclass
class CommStats:
    """What the sharded fits' collectives did in this process: all-reduce
    calls, the bytes each rank contributed and the host's seconds inside
    the calls; with ``timed`` set, a pair of CUDA events around every
    all-reduce of CUDA tensors (``events``, read with :meth:`elapsed_ms`
    after a sync)."""

    calls: int = 0
    nbytes: int = 0
    host_s: float = 0.0
    timed: bool = False
    events: List[Tuple[Any, Any]] = dataclasses.field(default_factory=list)

    def reset(self, timed: bool = False) -> None:
        self.calls, self.nbytes, self.host_s = 0, 0, 0.0
        self.timed, self.events = timed, []

    def elapsed_ms(self) -> float:
        return sum(a.elapsed_time(b) for a, b in self.events)


COMM = CommStats()


def all_reduce(mesh: Mesh, *tensors: torch.Tensor) -> List[torch.Tensor]:
    """Each tensor summed over the mesh's ranks (new tensors; the inputs are
    left as they are), in one collective: the tensors, of one dtype, go
    into one flat buffer."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    COMM.calls += 1
    COMM.nbytes += flat.numel() * flat.element_size()
    timed = COMM.timed and flat.is_cuda
    if timed:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
    t0 = time.perf_counter()
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.group)
    COMM.host_s += time.perf_counter() - t0
    if timed:
        b.record()
        COMM.events.append((a, b))
    out, off = [], 0
    for t in tensors:
        out.append(flat[off:off + t.numel()].view(t.shape))
        off += t.numel()
    return out


def broadcast(mesh: Mesh, tensor: torch.Tensor) -> torch.Tensor:
    """``tensor`` as the group's first rank holds it, on every rank (in
    place)."""
    src = dist.get_global_rank(mesh.group, 0) if mesh.group is not None \
        else 0
    dist.broadcast(tensor, src=src, group=mesh.group)
    return tensor


def gather_rows(mesh: Mesh, block: torch.Tensor, n: int) -> torch.Tensor:
    """The first ``n`` rows of every rank's equal-sized ``block`` stacked in
    rank order, on every rank. It is an all-reduce of the blocks placed in
    zeros (each row has one nonzero addend, so the sum is exact): every
    backend takes an all-reduce of CUDA tensors, gloo's all-gather not
    always."""
    rows = block.shape[0]
    full = block.new_zeros((mesh.world * rows,) + tuple(block.shape[1:]))
    full[mesh.rank * rows:(mesh.rank + 1) * rows] = block
    return all_reduce(mesh, full)[0][:n]
