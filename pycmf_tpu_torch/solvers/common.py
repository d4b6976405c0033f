"""Shared solver machinery: static config, hyperparameters, the fit loop.

Counterpart of ``pycmf_tpu/solvers/common.py``. A solver is a step
``(X, Y, U, V, Z, hyper) → (U, V, Z)`` on tensors, run in blocks of
``eval_every`` steps that end in the loss. The host loop runs every block
eagerly and syncs with the device once per block, when it reads the loss.
The device loop (the reference's ``loop='device'``, its
``device_fit_core``) keeps the loss history and the stop rule on the
device. A key's first fit runs an eager block, then replays a graph of one
eval block per block, reading the rule's stop flag after each. Its next fit
builds the cache's one entry, and that fit and every later one of the same
config and shapes run a whole tol-checked fit as one launch of a CUDA
graph: the eval block inside a conditional while node, the stop rule
evaluated on the device. That reuse is what jit's cache gives the
reference's compiled loop (:func:`run_device_fit`). On the CPU the device
loop runs the same schedule eagerly.

A sharded fit runs the same loop on every rank, its collectives captured
into each rank's graphs (NCCL; ``parallel/mesh.py``): the ranks agree on
the branch each fit takes before it starts, so that none captures while
another runs a block eagerly, and the stop rule reads a loss that is
all-reduced, so every rank runs the same blocks.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ..ops.chunked import ChunkedT, chunked_spmm, chunked_spmm_t, is_chunked
from ..ops.kernels import bell as kbell
from ..ops.kernels import fit_loop as kfit
from ..ops.kernels import policy
from ..ops.links import LINEAR, check_link
from ..ops.sparse import generic_matmul, is_sparse
from ..parallel.mesh import COMM


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Static solver configuration (the reference's fields)."""

    x_link: str = LINEAR
    y_link: str = LINEAR
    U_non_negative: bool = True
    V_non_negative: bool = True
    Z_non_negative: bool = True
    update_U: bool = True
    update_V: bool = True
    update_Z: bool = True
    has_Y: bool = True
    hessian_form: str = "gauss"  # 'gauss' | 'full'
    line_search_trials: int = 8
    sg_sample_ratio: float = 1.0
    use_pallas: bool = False     # the fused-kernel branch (reference's name)

    def __post_init__(self):
        check_link(self.x_link)
        check_link(self.y_link)
        if self.hessian_form not in ("gauss", "full"):
            raise ValueError("hessian_form must be 'gauss' or 'full'")
        if not (0.0 < self.sg_sample_ratio <= 1.0):
            raise ValueError("sg_sample_ratio must be in (0, 1]")


class Hyper(NamedTuple):
    """Numeric hyperparameters as Python floats rounded to the factor
    dtype; l1 and l2 are derived in that dtype, as the reference's traced
    scalars are."""

    alpha: float
    l1_ratio: float
    eps: float
    hessian_pertubation: float  # reference's spelling
    l1: float
    l2: float


def make_hyper(alpha=0.0, l1_ratio=0.0, eps=1e-10, hessian_pertubation=0.2,
               dtype=torch.float32) -> Hyper:
    def c(v):
        return torch.tensor(v, dtype=dtype)

    a, r = c(alpha), c(l1_ratio)
    return Hyper(float(a), float(r), float(c(eps)),
                 float(c(hessian_pertubation)), float(a * r),
                 float(a * (1.0 - r)))


class Coupled(NamedTuple):
    """A data matrix on the device (dense, CsrMatrix, BlockEll or
    ChunkedCoo) plus fit-time constants. The sparsity pattern is fixed for
    a fit, so a CSR matrix comes with the same layout of its transpose,
    built once on the host: CSR, or BlockEll where the blocks are full
    enough (then A is A_bell and At is At_bell). A chunked matrix streams
    its transpose from its own chunks."""

    A: Any
    row_sq: Optional[torch.Tensor] = None    # (p,) per-row ‖aᵢ‖²
    row_sq_t: Optional[torch.Tensor] = None  # (q,) per-row norms of Aᵀ
    a_sq: Optional[torch.Tensor] = None      # ‖A‖²_F (dense A)
    # Aᵀ: the layout of Aᵀ for a sparse A; for dense A the contiguous Aᵀ
    # that run_newton makes once per fit for the fused sigmoid passes that
    # read A transposed (Z against Yᵀ, V against Xᵀ), else None
    At: Any = None
    A_bell: Any = None   # BlockEll layouts of A and Aᵀ (ops/kernels/bell.py)
    At_bell: Any = None


def layout_spmm(A, layout, B: torch.Tensor, use_pallas: bool) -> torch.Tensor:
    """A @ B for dense, CSR or BlockEll A: under ``use_pallas`` through
    A's BlockEll ``layout`` when it has one, else the CSR kernel; otherwise
    the plain product. Layouts are built once per fit by as_coupled. A
    chunked A (or its transpose, ChunkedT) streams its chunks."""
    if isinstance(A, ChunkedT):
        return chunked_spmm_t(A.ck, B)
    if is_chunked(A):
        return chunked_spmm(A, B)
    if use_pallas and layout is not None:
        return kbell.bell_spmm(layout, B)
    return generic_matmul(A, B, use_pallas)


def coupled_mm(C: Coupled, B: torch.Tensor, transpose: bool = False,
               use_pallas: bool = False) -> torch.Tensor:
    """C.A @ B (or C.Aᵀ @ B) for dense, sparse or chunked data (see
    layout_spmm)."""
    if not transpose:
        return layout_spmm(C.A, C.A_bell, B, use_pallas)
    At = (ChunkedT(C.A) if is_chunked(C.A) else C.At if is_sparse(C.A)
          else C.A.mT)
    return layout_spmm(At, C.At_bell, B, use_pallas)


_CAPTURE_STREAMS: Dict[torch.device, torch.cuda.Stream] = {}


def _capture_stream(device: torch.device) -> torch.cuda.Stream:
    if device not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[device] = torch.cuda.Stream(device)
    return _CAPTURE_STREAMS[device]


@contextlib.contextmanager
def fit_stream(device: torch.device):
    """Run a device loop on the capture stream kept for a CUDA ``device``
    (on the CPU: nothing changes; yields None). Every device loop on a
    device runs on the same stream, eager blocks and captures included:
    PyTorch keeps a cuBLAS workspace per stream, and a new stream per fit
    would cycle through its pool of streams, each with a workspace of its
    own. Yields the caller's stream, which waits for the loop's work on
    the way out."""
    if device.type != "cuda":
        yield None
        return
    stream = _capture_stream(device)
    caller = torch.cuda.current_stream(device)
    stream.wait_stream(caller)
    try:
        with torch.cuda.stream(stream):
            yield caller
    finally:
        caller.wait_stream(stream)


class CudaBlockGraph:
    """One block as a CUDA graph (``torch.cuda.graph`` on the device's
    capture stream, a private memory pool, or ``pool`` shared with another
    block of the same fit, which never runs beside it). A cached entry's
    graph is kept (``keep``) so the fit graph can copy it into a
    conditional node (``raw``). Neither capture nor replay is guarded: an
    error raises."""

    def __init__(self, device, pool=None, keep=False):
        self.stream = _capture_stream(device)
        self.graph = torch.cuda.CUDAGraph(keep_graph=keep)
        self.pool, self.keep = pool, keep

    def capture(self, fn, outputs):
        """Record fn(), which writes its results into ``outputs`` (a
        sampled block among them its KeyStream's counter, which each
        replay advances on the device). The capture runs nothing. It
        checks this thread's CUDA calls only ('thread_local'): another
        thread's, such as the NCCL watchdog's event queries, cannot
        invalidate it."""
        with torch.cuda.graph(self.graph, pool=self.pool, stream=self.stream,
                              capture_error_mode="thread_local"):
            fn()

    def replay(self):
        self.graph.replay()

    def raw(self) -> int:
        """The captured graph's ``cudaGraph_t`` (a kept graph)."""
        return self.graph.raw_cuda_graph()

    def close(self):
        self.graph.reset()


class EagerBlockGraph:
    """CudaBlockGraph's stand-in for CPU tensors, with its contract:
    capture passes through fn once, as a capture does (the kernel wrappers
    and ``mesh.all_reduce`` count what it records), and leaves ``outputs``
    as they were (a capture runs nothing: a sampled block's key counter
    stays where it was; a sharded block's collectives do run, on every
    rank, since the ranks take the same branch); replay runs fn again
    with the wrappers' and collectives' counts hidden (a replay passes
    through no wrapper), from the counter where it stands. Every block
    thus runs eagerly, and a capture's pass costs one block more."""

    def capture(self, fn, outputs):
        saved = [t.clone() for t in outputs]
        fn()
        for t, s in zip(outputs, saved):
            t.copy_(s)
        self._fn = fn

    def replay(self):
        counts, comm = policy.launch_counts(), COMM.counts()
        self._fn()
        policy.set_launch_counts(counts)
        COMM.set_counts(comm)

    def close(self):
        self._fn = None


def block_graph(U: torch.Tensor, pool=None, keep=False):
    """A block graph for a fit whose factor U is given: a CudaBlockGraph on
    U's CUDA device, else the eager stand-in."""
    if U.is_cuda:
        return CudaBlockGraph(U.device, pool, keep)
    return EagerBlockGraph()


class Recorded(NamedTuple):
    """What one run of a captured block does that its replay cannot count
    itself, recorded at the capture: each kernel's launches (the wrappers'
    counts) and its collectives (``mesh.COMM``: calls, bytes, by axis)."""

    launches: Dict[str, int]
    comm: tuple

    def add(self, times: int = 1) -> None:
        """Count ``times`` replays."""
        policy.add_launches({k: n * times for k, n in self.launches.items()})
        COMM.add(self.comm, times)


def _capture_block(graph, block_fn, state, hyper, rng, n_steps: int,
                  statics, loss):
    """Capture one block of ``n_steps`` from ``state`` (X, Y and the static
    U, V, Z), writing U, V, Z back into ``statics`` and the loss (float64)
    into the 0-d ``loss``. ``rng``, a sampled block's KeyStream (its
    counter advanced by each replay) or None, is handed to the block.
    Returns what one replay does (:class:`Recorded`); the capture itself
    is counted as nothing."""

    def body():
        out, block_loss, _ = block_fn(state, hyper, rng, n_steps)
        for dst, src in zip(statics, out[2:]):
            dst.copy_(src)
        loss.copy_(block_loss)

    before, comm = policy.launch_counts(), COMM.counts()
    graph.capture(body, list(statics) + [loss]
                  + ([] if rng is None else list(rng)))
    rec = Recorded(policy.launches_since(before), COMM.since(comm))
    policy.set_launch_counts(before)  # a capture launches nothing
    COMM.set_counts(comm)
    return rec


def _as_loss(loss_t, device) -> torch.Tensor:
    """A block's loss as the stop rule takes it: a 0-d float64 tensor on
    the fit's device."""
    return torch.as_tensor(loss_t).to(device=device,
                                      dtype=torch.float64).reshape(())


def _control(device):
    """The loop's state buffers (ctl, fctl; see ops/kernels/fit_loop.py)."""
    return (torch.zeros(kfit.CTL_SLOTS, dtype=torch.int64, device=device),
            torch.zeros(kfit.FCTL_SLOTS, dtype=torch.float64, device=device))


def _run_blocks(run_block, ctl, fctl, hist, n_full: int) -> bool:
    """Full blocks one at a time from block 0 (``run_block(j)`` runs block
    j and returns its loss as a 0-d float64 tensor), each followed by the
    stop rule (``kfit.stop_rule``) and a read of its stop flag: one sync
    per block, as the host loop's read of the loss. Returns whether the
    rule stopped the fit."""
    for j in range(n_full):
        kfit.stop_rule(ctl, fctl, hist, run_block(j))
        if int(ctl[2]):
            return True
    return False


class EagerFitGraph:
    """FitGraph's stand-in for CPU tensors (``ops/kernels/fit_loop.py``):
    the same nodes in the same order, each run eagerly, the stop rule by
    its plain version (which counts no launch). ``entry`` holds the
    buffers and the blocks."""

    nodes = 0

    def __init__(self, entry: "FitEntry"):
        self.entry = entry

    def launch(self):
        e = self.entry
        go, _ = kfit.stop_rule_ref(e.ctl, e.fctl, e.hist, None, kfit.GATE)
        while bool(go):
            e.block.replay()
            go, _ = kfit.stop_rule_ref(e.ctl, e.fctl, e.hist, e.loss,
                                       kfit.BLOCK)
        if e.rem is not None:
            _, run = kfit.stop_rule_ref(e.ctl, e.fctl, e.hist, None,
                                        kfit.GATE)
            if bool(run):
                e.rem.replay()
                kfit.stop_rule_ref(e.ctl, e.fctl, e.hist, e.rem_loss,
                                   kfit.REMAINDER)

    def ran(self, blocks: int, rem_ran: bool) -> None:
        pass

    def close(self):
        self.entry = None


def _describe(obj):
    """A hashable description of a data layout: every tensor by dtype,
    shape, stride and device type, every other field by value."""
    if obj is None or isinstance(obj, (bool, int, float, str, torch.dtype)):
        return obj
    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, torch.Tensor):
        return ("tensor", obj.dtype, tuple(obj.shape), obj.stride(),
                obj.device.type)
    if isinstance(obj, tuple):
        return (type(obj).__name__,) + tuple(_describe(v) for v in obj)
    if dataclasses.is_dataclass(obj):
        return (type(obj).__name__,) + tuple(
            (f.name, _describe(getattr(obj, f.name)))
            for f in dataclasses.fields(obj))
    raise TypeError(f"the device loop cannot key a layout field of type "
                    f"{type(obj).__name__}")


def _map_tensors(obj, fn, scratch: bool = False):
    """obj with every tensor t replaced by fn(t, scratch); scratch is True
    for a dataclass field that takes no part in comparisons (a layout's
    work buffer, whose contents no pass reads before writing them)."""
    if isinstance(obj, torch.Tensor):
        return fn(obj, scratch)
    if isinstance(obj, tuple):
        vals = [_map_tensors(v, fn, scratch) for v in obj]
        return type(obj)(*vals) if hasattr(obj, "_fields") else tuple(vals)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: _map_tensors(getattr(obj, f.name), fn, not f.compare)
            for f in dataclasses.fields(obj)})
    return obj


def _leaves(obj) -> list:
    """The tensors of obj, with their scratch flags, in _map_tensors's
    order."""
    out = []
    _map_tensors(obj, lambda t, s: out.append((t, s)))
    return out


def _nbytes(tensors) -> int:
    """Bytes of the distinct storages under ``tensors``."""
    seen = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
            for t in tensors}
    return sum(seen.values())


def _owned_copy(t: torch.Tensor) -> torch.Tensor:
    """A copy of t in memory of its own, with t's strides."""
    return torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                               device=t.device).copy_(t)


# The fit cache holds one program at most, with a copy of its fit's data,
# and only where that copy takes at most 1/FIT_CACHE_SHARE of the card's
# memory: a fit of larger data runs the first fit's schedule every time.
FIT_CACHE_SHARE = 8
# the cached entry, and the key of the last device fit that found none
_CACHE: Dict[str, Any] = {"entry": None, "seen": None}
# What the last device fit did: hit (the cache held its program), eager
# blocks, captures, fit graph launches and block replays.
LAST_FIT: Dict[str, Any] = {}


def clear_fit_cache() -> None:
    """Drop the cached fit program, freeing its graphs, memory pool and
    buffers, and forget the last key seen."""
    entry = _CACHE["entry"]
    _CACHE.update(entry=None, seen=None)
    if entry is not None:
        entry.close()


def fit_cache_entries() -> List["FitEntry"]:
    """The cached fit programs (one at most)."""
    return [] if _CACHE["entry"] is None else [_CACHE["entry"]]


def fit_cache_limit(device: torch.device) -> Optional[int]:
    """The most bytes of data and factors a cache entry may copy on
    ``device``: 1/FIT_CACHE_SHARE of the card's memory; no limit on the
    CPU."""
    if device.type != "cuda":
        return None
    return torch.cuda.get_device_properties(device).total_memory \
        // FIT_CACHE_SHARE


class FitEntry:
    """One cached fit program, the counterpart of a jitted fit: the device
    buffers its graphs read and write (a copy of the data layouts, the
    static factors U, V, Z, the loop's control and loss buffers, a sampled
    fit's KeyStream: its key and iteration counter), the captured blocks
    and the fit graph (on the card ``ops/kernels/fit_loop.FitGraph``, on
    the CPU its stand-in). A fit whose captured block holds a node type a
    conditional body refuses (``fit_loop.refused_node``; ``refused`` names
    it) keeps the blocks alone and replays them per block: the rule is
    read off the captured graph, the same on every rank of a sharded fit.

    Built from a fit's initial ``state`` (X, Y, U, V, Z): the captures read
    the copies. ``nbytes``: the buffers' bytes (the graph pool's apart)."""

    def __init__(self, key, block_fn, state, hyper, rng, *,
                 eval_every: int, rem: int):
        X, Y, U, V, Z = state
        dev, self.key, self.card = U.device, key, U.is_cuda
        copies: Dict[int, torch.Tensor] = {}

        def own(t, scratch):
            if id(t) not in copies:
                copies[id(t)] = torch.empty_strided(
                    t.shape, t.stride(), dtype=t.dtype, device=t.device) \
                    if scratch else _owned_copy(t)
            return copies[id(t)]

        self.X, self.Y = _map_tensors(X, own), _map_tensors(Y, own)
        self.data = [(own(t, s), s) for t, s in _leaves((X, Y))]
        self.statics = [_owned_copy(t) for t in (U, V, Z)]
        self.ctl, self.fctl = _control(dev)
        self.loss = torch.zeros((), dtype=torch.float64, device=dev)
        self.rem_loss = torch.zeros((), dtype=torch.float64, device=dev)
        self.hist = None
        self.rng = None if rng is None else rng.copy()
        self.block, self.block_rec = self._capture(
            block_fn, hyper, eval_every, self.loss, None)
        self.rem, self.rem_rec = None, None
        if rem:
            self.rem, self.rem_rec = self._capture(
                block_fn, hyper, rem, self.rem_loss, self.block)
        self.refused = None
        for g in (self.block, self.rem) if self.card else ():
            bad = kfit.refused_node(g.raw(), dev.index)[1] if g else None
            if bad is not None and self.refused is None:
                self.refused = kfit.NODE_TYPES.get(bad, str(bad))
        self.fit = None
        if self.refused is None:
            self.fit = (kfit.FitGraph(
                self.block.raw(), self.rem.raw() if self.rem else 0,
                self.ctl, self.fctl, self.loss, self.rem_loss)
                if self.card else EagerFitGraph(self))
        self.nbytes = _nbytes(list(copies.values()) + self.statics + [
            self.ctl, self.fctl, self.loss, self.rem_loss]
            + ([] if self.rng is None else list(self.rng)))

    def _capture(self, block_fn, hyper, n_steps, loss_buf, share):
        graph = block_graph(self.statics[0],
                            share.graph.pool() if self.card and share
                            else None, keep=True)
        rec = _capture_block(graph, block_fn,
                             (self.X, self.Y, *self.statics), hyper,
                             self.rng, n_steps, self.statics, loss_buf)
        return graph, rec

    @property
    def nodes(self) -> int:
        return self.fit.nodes if self.fit is not None else 0

    def load(self, state, rng) -> None:
        """Copy a fit's data, initial factors and key stream into the
        entry's buffers (exact: device copies)."""
        X, Y, U, V, Z = state
        if rng is not None:
            self.rng.load(rng)
        for (dst, scratch), (src, _) in zip(self.data, _leaves((X, Y))):
            if not scratch:
                dst.copy_(src)
        for dst, src in zip(self.statics, (U, V, Z)):
            dst.copy_(src)

    def start(self, hist, L0, *, n_full: int, tol: float) -> None:
        """Write a fit's loop state (block 0, its n_full, tol and L0)."""
        self.hist = hist
        kfit.write_control(self.ctl, self.fctl, hist, L0, start=0,
                           n_full=n_full, tol=tol)

    def run(self, *, n_full: int, rem: int, info):
        """Run a fit from block 0 on the entry's buffers; returns U, V, Z.
        The fit is one launch of the fit graph; with a refused node the
        eval block is replayed per block (_run_blocks) and the remainder
        after them. A sampled fit's blocks draw from the entry's key
        stream (loaded from the fit's by :meth:`load`)."""
        if self.fit is not None:
            self.fit.launch()
            info["graph_launches"] = 1
        else:
            def replay(j):
                self.block.replay()
                self.block_rec.add()
                info["replays"] += 1
                return self.loss

            stopped = _run_blocks(replay, self.ctl, self.fctl, self.hist,
                                  n_full)
            if rem and not stopped:
                self.rem.replay()
                self.rem_rec.add()
                info["replays"] += 1
                kfit.stop_rule(self.ctl, self.fctl, self.hist, self.rem_loss,
                               kfit.REMAINDER)
        return self.statics

    def count_launches(self, blocks: int, rem_ran: bool) -> None:
        """Add what the fit graph ran to the launch and collective counts:
        a graph passes through no wrapper (fit_loop's rule nodes are
        FitGraph's to count)."""
        self.block_rec.add(blocks)
        if rem_ran:
            self.rem_rec.add()
        self.fit.ran(blocks, rem_ran)

    def close(self) -> None:
        """Free the fit graph, the captured blocks and the buffers."""
        for g in (self.fit, self.block, self.rem):
            if g is not None:
                g.close()
        self.fit = self.block = self.rem = None
        self.X = self.Y = self.data = self.statics = self.hist = None
        self.rng = None


def fit_key(key, state, hyper, eval_every: int, rem: int,
            sampled: bool) -> tuple:
    """The cache key of a device fit: everything its captured work reads
    by address or bakes in: ``key`` (the solver, its SolverConfig and its
    eval-loss kind), the Hyper floats, eval_every and the remainder, the
    device, and the dtype, shape and strides of U, V, Z and of every tensor
    of the X and Y layouts with each layout's host-side fields (CSR nnz,
    the BlockEll plan, the chunk count and rows, the storage dtype)."""
    X, Y, U, V, Z = state
    return (key, hyper, eval_every, rem, sampled, str(U.device),
            _describe(X), _describe(Y), _describe((U, V, Z)))


def _read_back(ctl, hist):
    """(i, whether the remainder ran, the history) in one readback: both
    copies start before the one wait."""
    if ctl.is_cuda:
        c = torch.empty(4, dtype=torch.int64, pin_memory=True)
        h = torch.empty(hist.shape, dtype=torch.float64, pin_memory=True)
        c.copy_(ctl[:4], non_blocking=True)
        h.copy_(hist, non_blocking=True)
        torch.cuda.current_stream(ctl.device).synchronize()
    else:
        c, h = ctl, hist
    return int(c[0]), bool(c[3]), h.numpy()


def finish_device_fit(n_iter: int, hist, eval_every: int,
                      max_iter: int) -> tuple:
    """(losses, loss_iters) from a device fit's iteration count and
    NaN-padded history. The slots written follow from n_iter (the initial
    loss, one per full block, the remainder if it ran); a non-finite value
    among them is divergence and raises, as the host loop does at once."""
    eval_every = max(1, min(eval_every, max_iter))
    n_blocks = n_iter // eval_every
    rem_ran = n_iter - n_blocks * eval_every > 0
    written = np.asarray(hist, dtype=np.float64)[:1 + n_blocks + rem_ran]
    if not np.all(np.isfinite(written)):
        raise FloatingPointError(
            f"non-finite loss during device-resident fit (n_iter={n_iter}, "
            f"history={written.tolist()}); this usually means the problem "
            "scale overflows the compute dtype — try dtype='float64' (CPU), "
            "a larger hessian_pertubation (Newton), or alpha-regularization. "
            "Use loop='host' to locate the failing iteration.")
    losses = [float(v) for v in written]
    iters = [0] + [min((j + 1) * eval_every, max_iter)
                   for j in range(len(losses) - 1)]
    return losses, iters


def amortize_step_times(wall: float, loss_iters) -> List[float]:
    """Per-eval-block times of a device fit: the whole fit's wall time,
    the only time the host observes, shared out in proportion to each
    block's iterations, so ``len(step_times) == len(loss_history) - 1``."""
    spans = np.diff(np.asarray(loss_iters, dtype=np.float64))
    total = float(spans.sum())
    if spans.size == 0 or total <= 0:
        return [wall] if spans.size else []
    return [wall * float(s) / total for s in spans]


def _first_fit(block_fn, state, hyper, rng, ctl, fctl, hist, *,
               n_full: int, rem: int, eval_every: int, info):
    """A key's first device fit, on the fit's own tensors: block 1 eager
    (the warm-up: it loads each kernel library, sets the kernels'
    shared-memory attributes and makes the library handles of the capture
    stream); if a second full block runs, one eval block captured into a
    graph of this fit (reading static copies of U, V, Z and the fit's X and
    Y; a sampled fit's ``rng``, its KeyStream, advanced by each block) and
    replayed per later full block; the remainder eager; the stop rule after
    each block (_run_blocks). Returns the final U, V, Z."""
    cur = {"state": state, "rng": rng}
    graph = block_graph(state[2])
    loss = torch.zeros((), dtype=torch.float64, device=ctl.device)
    rec = None

    def run_block(j):
        nonlocal rec
        if j == 0:
            cur["state"], loss_t, cur["rng"] = block_fn(
                cur["state"], hyper, cur["rng"], eval_every)
            info["eager_blocks"] += 1
            return _as_loss(loss_t, ctl.device)
        if rec is None:
            s = cur["state"]
            statics = [t.clone() for t in s[2:]]
            rec = _capture_block(graph, block_fn, (*s[:2], *statics),
                                 hyper, cur["rng"], eval_every, statics, loss)
            cur["state"] = (*s[:2], *statics)
            info["captures"] += 1
            if "collectives" in info:
                info["collectives"] = rec.comm[0]
        graph.replay()
        rec.add()
        info["replays"] += 1
        return loss

    stopped = _run_blocks(run_block, ctl, fctl, hist, n_full)
    if rem and not stopped:
        cur["state"], loss_t, _ = block_fn(cur["state"], hyper, cur["rng"],
                                           rem)
        kfit.stop_rule(ctl, fctl, hist, _as_loss(loss_t, ctl.device),
                       kfit.REMAINDER)
    return cur["state"][2:]


def run_device_fit(block_fn, state, hyper, rng, *, max_iter: int, tol: float,
                   eval_every: int, initial_loss_fn, key=(),
                   agree=None) -> tuple:
    """The device loop, counterpart of the reference's ``device_fit_core``
    with jit's cache, keyed on :func:`fit_key`.

    A key's first fit runs on its own tensors (_first_fit: an eager block,
    then a graph of one eval block replayed per block, the stop rule by
    ``stop_rule_kernel`` after each): it copies nothing and keeps nothing.
    The next fit of that key, where its data and factors take at most
    fit_cache_limit bytes, builds the cache's one entry (FitEntry: evicting
    the entry it held, copying the fit's data and factors, capturing the
    blocks from them) and runs on it; later fits of the key copy theirs in
    and run on it too, from block 0, as one launch of the fit graph (a
    sampled fit's draws keyed on the entry's device counter). Every fit
    ends in one readback of the iteration count and the
    loss history; the results are never the entry's buffers; a non-finite
    loss raises FloatingPointError after the readback, and ``step_times``
    are the wall time amortized over the blocks (amortize_step_times).

    A sharded fit passes ``agree`` (``mesh.all_ranks`` over its mesh):
    whether the cache holds the key, whether the key was seen last and
    whether the copy fits the limit are each taken as true only where they
    hold on every rank, so every rank takes the same branch even where
    their caches, limits or layouts' bytes differ. Its record (LAST_FIT)
    adds ``collectives``: the all-reduces one captured eval block makes
    (0 when the fit captured none). A fit whose cached block holds a node
    type a conditional body refuses runs the eval block per block and
    names the type under ``refused``."""
    if initial_loss_fn is None:
        raise ValueError("the device loop needs initial_loss_fn (L0)")
    eval_every = max(1, min(eval_every, max_iter))
    n_full, rem = divmod(max_iter, eval_every)
    X, Y, U = state[0], state[1], state[2]
    full_key = fit_key(key, state, hyper, eval_every, rem, rng is not None)
    entry = _CACHE["entry"]
    limit = fit_cache_limit(U.device)
    flags = [entry is not None and entry.key == full_key,
             _CACHE["seen"] == full_key,
             limit is None or _nbytes(
                 [t for t, s in _leaves((X, Y)) if not s] + list(state[2:]))
             <= limit]
    hit, seen, fits = agree(flags) if agree is not None else flags
    build = not hit and seen and fits
    info = dict(hit=hit, eager_blocks=0, captures=0, graph_launches=0,
                replays=0)
    if agree is not None:
        info["collectives"] = 0
    _CACHE["seen"] = full_key
    with fit_stream(U.device) as caller:
        t0 = time.perf_counter()
        L0 = torch.as_tensor(initial_loss_fn(state, hyper), device=U.device)
        hist = torch.full((n_full + 2,), float("nan"), dtype=torch.float64,
                          device=U.device)
        if hit or build:
            if build:
                clear_fit_cache()  # one entry: free it before copying
                entry = FitEntry(full_key, block_fn, state, hyper, rng,
                                 eval_every=eval_every, rem=rem)
                _CACHE.update(entry=entry, seen=full_key)
                info["captures"] = 1 + (entry.rem is not None)
            else:
                entry.load(state, rng)
            if agree is not None:
                info["collectives"] = entry.block_rec.comm[0]
            if entry.refused is not None:
                info["refused"] = entry.refused
            entry.start(hist, L0, n_full=n_full, tol=tol)
            out = entry.run(n_full=n_full, rem=rem, info=info)
            factors = [t.clone() if any(t is s for s in entry.statics) else t
                       for t in out]
            ctl = entry.ctl
        else:
            ctl, fctl = _control(U.device)
            kfit.write_control(ctl, fctl, hist, L0, start=0, n_full=n_full,
                               tol=tol)
            factors = list(_first_fit(block_fn, state, hyper, rng, ctl, fctl,
                                      hist, n_full=n_full, rem=rem,
                                      eval_every=eval_every, info=info))
        i_end, rem_ran, hist_vals = _read_back(ctl, hist)
        wall = time.perf_counter() - t0
        if caller is not None:
            for t in factors:
                t.record_stream(caller)
    if entry is not None and (hit or build) and entry.fit is not None:
        entry.count_launches(i_end, rem_ran)
    LAST_FIT.clear()
    LAST_FIT.update(info)
    n_iter = i_end * eval_every + (rem if rem_ran else 0)
    losses, iters = finish_device_fit(n_iter, hist_vals, eval_every,
                                      max_iter)
    return ((X, Y, *factors), n_iter, losses, iters,
            amortize_step_times(wall, iters))


def run_solver_loop(block_fn, state, hyper, rng, *, max_iter: int, tol: float,
                    eval_every: int, verbose: int = 0,
                    initial_loss_fn=None, loop: str = "host",
                    key=(), agree=None) -> tuple:
    """Loop over blocks of ``eval_every`` iterations with the
    relative-decrease stopping rule

        stop when (L_prev − L) / L_init < tol

    checked after every block (the last block may be shorter). A non-finite
    loss raises FloatingPointError.

    loop 'host' runs every block eagerly and reads each block's loss (one
    sync per block); ``step_times`` holds each block's host clock, so
    ``len(step_times) == len(loss_history) - 1``. loop 'device' is
    :func:`run_device_fit` (``key``: the solver's part of its cache key;
    ``agree``: a sharded fit's agreement of its ranks on the branch).
    """
    check_loop(loop)
    if loop == "device":
        return run_device_fit(block_fn, state, hyper, rng, max_iter=max_iter,
                              tol=tol, eval_every=eval_every,
                              initial_loss_fn=initial_loss_fn, key=key,
                              agree=agree)
    eval_every = max(1, min(eval_every, max_iter))
    loss_history: List[float] = []
    loss_iters: List[int] = []
    step_times: List[float] = []

    if initial_loss_fn is not None:
        loss_init = float(initial_loss_fn(state, hyper))
        loss_history.append(loss_init)
        loss_iters.append(0)
    else:
        loss_init = None

    prev_loss = loss_init
    n_iter = 0
    while n_iter < max_iter:
        n_steps = min(eval_every, max_iter - n_iter)
        t0 = time.perf_counter()
        state, loss_t, rng = block_fn(state, hyper, rng, n_steps)
        loss = float(loss_t)
        step_times.append(time.perf_counter() - t0)
        n_iter += n_steps
        if not np.isfinite(loss):
            raise FloatingPointError(
                f"non-finite loss ({loss}) at iteration {n_iter}; this "
                "usually means the problem scale overflows the compute "
                "dtype — try dtype='float64' (CPU), a larger "
                "hessian_pertubation (Newton), or alpha-regularization. "
                f"History so far: {loss_history}")
        loss_history.append(loss)
        loss_iters.append(n_iter)
        if verbose:
            print(f"[pycmf_tpu_torch] iter {n_iter:5d}  loss {loss:.8g}")
        if loss_init is None:
            loss_init = loss_history[0]
        if prev_loss is not None and loss_init > 0:
            if (prev_loss - loss) / loss_init < tol:
                break
        prev_loss = loss
    return state, n_iter, loss_history, loss_iters, step_times


def check_loop(loop: str) -> None:
    """'host': every block eager; 'device': the device loop
    (run_device_fit: on the card a graph of one eval block per fit, and from
    a key's second fit one launch of a cached fit graph; on the CPU the
    same schedule run eagerly)."""
    if loop not in ("host", "device"):
        raise ValueError("loop must be 'host' or 'device'")
