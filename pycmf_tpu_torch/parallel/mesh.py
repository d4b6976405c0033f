"""The process group a sharded fit runs over, and its collectives.

Counterpart of ``pycmf_tpu/parallel/mesh.py:make_mesh``. The reference is
one process that drives every device through ``shard_map`` over a mesh;
the port is one process per shard, each a rank of a ``torch.distributed``
process group (launched, for example, by ``torchrun --nproc-per-node N``).
Whoever creates the group names its backend: NCCL across cards, gloo
across CPU processes (or CUDA tensors through the host). The port chooses
no backend and never switches one.

The grid layout's (rows × cols) mesh is the world group plus two sets of
subgroups (:func:`make_grid_mesh`): the ranks of one mesh column (a sum over
the ROW axis) and of one mesh row (a sum over the COL axis).

Every reduction of a sharded fit goes through :func:`all_reduce`, which
packs the terms summed at one point into one buffer and one collective,
and counts the calls, bytes and host time in :data:`COMM`, in all and per
mesh axis (with CUDA-event times when ``COMM.timed`` is set). A collective
captured into a CUDA graph passes through :func:`all_reduce` once, at the
capture: the device loop takes that pass's counts back and adds them per
replay (``solvers/common.py``), so both loops count the same calls.

The device loop captures a sharded fit's collectives only over NCCL
(:func:`captures`): a gloo all-reduce of CUDA tensors goes through the
host. Its cached program is keyed on the group (:func:`group_key`) and
holds the group's communicator in its graphs: free it
(``solvers.common.clear_fit_cache``) before destroying the group.
"""
from __future__ import annotations

import dataclasses
import itertools
import os
import time
import weakref
from typing import Any, Dict, List, NamedTuple, Tuple

import torch
import torch.distributed as dist

AXIS = "shards"
GRID_AXIS = "grid"   # the grid layout's whole mesh
ROW_AXIS = "rows"    # ranks sharing a mesh column: sums over the row blocks
COL_AXIS = "cols"    # ranks sharing a mesh row: sums over the column blocks


class Mesh(NamedTuple):
    """A sharded fit's process group, this process's rank in it, the
    group's size, the device this rank computes on, and the name of the
    mesh axis the group spans (what :data:`COMM` counts it under)."""

    group: Any
    rank: int
    world: int
    device: torch.device
    axis: str = AXIS


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


class GridMesh(NamedTuple):
    """The grid layout's (rows × cols) mesh from one rank's view: rank =
    i·cols + j sits at mesh position (i, j), row-major as the reference's
    ``make_grid_mesh`` reshapes its devices.

    world : every rank (axis ``GRID_AXIS``)
    row   : the ranks of mesh column j, i = 0 .. rows − 1 (``ROW_AXIS``;
            rank i in it): sums over X's row blocks (V's X-side terms)
    col   : the ranks of mesh row i, j = 0 .. cols − 1 (``COL_AXIS``;
            rank j in it): sums over X's column blocks (U's and Z's terms)
    """

    world: Mesh
    row: Mesh
    col: Mesh
    rows: int
    cols: int

    @property
    def i(self) -> int:
        return self.world.rank // self.cols

    @property
    def j(self) -> int:
        return self.world.rank % self.cols


# the axis subgroups made for each parent group and mesh shape, kept so a
# fit does not create new communicators every time (torch frees none before
# the process group is destroyed): (parent, shape, this rank's ROW-axis
# group, its COL-axis group), all weak references, so an entry dies with
# its groups when the process group is destroyed
_GRID_GROUPS: List[Tuple[Any, Tuple[int, int], Any, Any]] = []


def _axis_groups(parent, rows: int, cols: int, i: int, j: int):
    """This rank's (ROW-axis group: mesh column j, COL-axis group: mesh row
    i) of ``parent``. Every rank creates every subgroup, in the same order
    (torch's rule for ``new_group``: a rank that skips one hangs the
    others); a rank keeps the two it belongs to."""
    key = (parent if parent is not None
           else dist.distributed_c10d._get_default_group())
    _GRID_GROUPS[:] = [e for e in _GRID_GROUPS
                       if all(ref() is not None for ref in (e[0], *e[2:]))]
    for p, shape, row_ref, col_ref in _GRID_GROUPS:
        if p() is key and shape == (rows, cols):
            return row_ref(), col_ref()

    def glob(r):
        return dist.get_global_rank(parent, r) if parent is not None else r

    row_groups = [dist.new_group([glob(a * cols + b) for a in range(rows)])
                  for b in range(cols)]
    col_groups = [dist.new_group([glob(a * cols + b) for b in range(cols)])
                  for a in range(rows)]
    row, col = row_groups[j], col_groups[i]
    _GRID_GROUPS.append((weakref.ref(key), (rows, cols), weakref.ref(row),
                         weakref.ref(col)))
    return row, col


def make_grid_mesh(rows: int, cols: int, group=None,
                   device="cuda") -> GridMesh:
    """The (rows × cols) mesh of a grid fit over ``group`` (default: the
    default process group), whose size must be rows·cols (ValueError, as
    :func:`make_mesh`). The axis subgroups are made once per parent group
    and shape, on every rank of the job: with a ``group`` other than the
    default one, every process of the job must make the same call.
    Reference: ``pycmf_tpu/parallel/mesh.py:make_grid_mesh``."""
    world = make_mesh(rows * cols, group, device)._replace(axis=GRID_AXIS)
    i, j = divmod(world.rank, cols)
    row, col = _axis_groups(group, rows, cols, i, j)
    return GridMesh(world, Mesh(row, i, rows, world.device, ROW_AXIS),
                    Mesh(col, j, cols, world.device, COL_AXIS), rows, cols)


@dataclasses.dataclass
class CommStats:
    """What the sharded fits' collectives did in this process: all-reduce
    calls, the bytes each rank contributed and the host's seconds inside
    the calls, in all and per mesh axis (``by_axis``: axis → [calls,
    bytes]); with ``timed`` set, a pair of CUDA events around every
    all-reduce of CUDA tensors (``events``, the axis of each in
    ``event_axes``; read them after a sync)."""

    calls: int = 0
    nbytes: int = 0
    host_s: float = 0.0
    timed: bool = False
    events: List[Tuple[Any, Any]] = dataclasses.field(default_factory=list)
    event_axes: List[str] = dataclasses.field(default_factory=list)
    by_axis: Dict[str, List[int]] = dataclasses.field(default_factory=dict)

    def reset(self, timed: bool = False) -> None:
        self.calls, self.nbytes, self.host_s = 0, 0, 0.0
        self.timed, self.events, self.event_axes = timed, [], []
        self.by_axis = {}

    def counts(self) -> tuple:
        """(calls, bytes, host seconds, by_axis) as they stand."""
        return (self.calls, self.nbytes, self.host_s,
                {a: list(v) for a, v in self.by_axis.items()})

    def set_counts(self, counts: tuple) -> None:
        """Put back what :meth:`counts` returned (a capture calls no
        collective: the device loop takes back what its pass counted)."""
        calls, nbytes, host_s, by_axis = counts
        self.calls, self.nbytes, self.host_s = calls, nbytes, host_s
        self.by_axis = {a: list(v) for a, v in by_axis.items()}

    def since(self, counts: tuple) -> tuple:
        """(calls, bytes, by_axis) counted since :meth:`counts` gave
        ``counts``: what one pass of a captured block calls."""
        calls, nbytes, _, by_axis = counts
        per = {a: [v[0] - by_axis.get(a, [0, 0])[0],
                   v[1] - by_axis.get(a, [0, 0])[1]]
               for a, v in self.by_axis.items()}
        return (self.calls - calls, self.nbytes - nbytes,
                {a: v for a, v in per.items() if v[0]})

    def add(self, delta: tuple, times: int = 1) -> None:
        """Count ``times`` runs of what :meth:`since` returned (the replays
        of a captured block, which pass through no Python)."""
        calls, nbytes, by_axis = delta
        self.calls += calls * times
        self.nbytes += nbytes * times
        for a, (c, b) in by_axis.items():
            per = self.by_axis.setdefault(a, [0, 0])
            per[0] += c * times
            per[1] += b * times


COMM = CommStats()


def cuda_backend(group=None) -> str:
    """The backend that takes ``group``'s collectives of CUDA tensors:
    'nccl', 'gloo', ... (the one backend the group was made with, or the
    'cuda:' entry of a 'cpu:gloo,cuda:nccl' spelling)."""
    name = str(dist.get_backend(group))
    for part in name.split(","):
        dev, _, backend = part.rpartition(":")
        if dev in ("", "cuda"):
            return backend
    return name


def captures(device, group=None) -> bool:
    """Whether a sharded fit's collectives on ``device`` can be captured
    into a CUDA graph: CUDA tensors over a group whose CUDA backend is
    NCCL. A gloo all-reduce of CUDA tensors copies them through the host,
    which a capture cannot record."""
    return torch.device(device).type == "cuda" and cuda_backend(group) \
        == "nccl"


# a serial per process group this process has seen (weakly held: it dies
# with the group object), so that a cached program keyed on it is never
# reused by a later group, whatever address the later group gets
_GROUP_SERIALS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_SERIAL = itertools.count()


def group_key(mesh: Mesh) -> tuple:
    """The part of a device fit's cache key that names its mesh: the axis,
    the world size, the group's serial in this process and its backend."""
    g = (mesh.group if mesh.group is not None
         else dist.distributed_c10d._get_default_group())
    if g not in _GROUP_SERIALS:
        _GROUP_SERIALS[g] = next(_SERIAL)
    return (mesh.axis, mesh.world, _GROUP_SERIALS[g], cuda_backend(g))


def all_ranks(mesh: Mesh, flags) -> List[bool]:
    """Each flag true on every rank of the mesh: one all-reduce (MIN) of
    the flags on mesh.device. It decides how a sharded device fit runs, so
    that every rank takes the same branch; it is the loop's control, not a
    sum of the fit, and :data:`COMM` does not count it. One rank: the
    flags as given."""
    flags = [bool(f) for f in flags]
    if mesh.world == 1:
        return flags
    t = torch.tensor(flags, dtype=torch.int32, device=mesh.device)
    dist.all_reduce(t, op=dist.ReduceOp.MIN, group=mesh.group)
    return [bool(v) for v in t.tolist()]


def all_reduce(mesh: Mesh, *tensors: torch.Tensor) -> List[torch.Tensor]:
    """Each tensor summed over the mesh's ranks (new tensors; the inputs are
    left as they are), in one collective: the tensors, of one dtype, go
    into one flat buffer. On a grid's axis of one rank the sum is the
    tensor itself: no collective, nothing counted (the world mesh, and the
    rows and cols layouts' of one rank, keep theirs)."""
    if mesh.world == 1 and mesh.axis in (ROW_AXIS, COL_AXIS):
        return [t.contiguous() for t in tensors]
    flat = torch.cat([t.reshape(-1) for t in tensors])
    nbytes = flat.numel() * flat.element_size()
    COMM.calls += 1
    COMM.nbytes += nbytes
    per = COMM.by_axis.setdefault(mesh.axis, [0, 0])
    per[0] += 1
    per[1] += nbytes
    timed = COMM.timed and flat.is_cuda
    if timed and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            "COMM.timed cannot time an all-reduce captured into a CUDA "
            "graph (its events would time the capture, not the replays); "
            "time the host loop, or reset COMM with timed=False")
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
        COMM.event_axes.append(mesh.axis)
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
