"""Shared solver machinery: static config, hyperparameters, the fit loop.

Counterpart of ``pycmf_tpu/solvers/common.py``. A solver is a step
``(X, Y, U, V, Z, hyper) → (U, V, Z)`` on tensors, run in blocks of
``eval_every`` steps that end in the loss. The host loop runs every block
eagerly; the device loop (the reference's ``loop='device'``) runs a full
block after the first as the replay of one CUDA graph, captured once per
fit. Both sync with the device once per block, when they read its loss.
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
from ..ops.kernels import policy
from ..ops.links import LINEAR, check_link
from ..ops.sparse import generic_matmul, is_sparse


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


class CudaBlockGraph:
    """One eval block as a CUDA graph (``torch.cuda.graph``: a side stream,
    a private memory pool). The whole device loop runs on that stream, its
    eager blocks too: the first is the warm-up the capture needs (it loads
    each kernel library, sets the kernels' shared-memory attributes and
    makes the cuBLAS and cuSOLVER handles and workspaces of this stream).
    Every device loop on a device uses the same stream, as
    ``torch.cuda.graph`` keeps one default capture stream: PyTorch keeps a
    cuBLAS workspace per stream, and a new stream per fit would cycle
    through its pool of streams, each with a workspace of its own. Neither
    capture nor replay is guarded: an error raises."""

    def __init__(self, device):
        if device not in _CAPTURE_STREAMS:
            _CAPTURE_STREAMS[device] = torch.cuda.Stream(device)
        self.stream = _CAPTURE_STREAMS[device]
        self.graph = torch.cuda.CUDAGraph()
        self._caller = None

    @contextlib.contextmanager
    def on_stream(self):
        self._caller = torch.cuda.current_stream(self.stream.device)
        self.stream.wait_stream(self._caller)
        try:
            with torch.cuda.stream(self.stream):
                yield
        finally:
            self._caller.wait_stream(self.stream)

    def capture(self, fn, outputs, generators=()):
        """Record fn(), which writes its results into ``outputs`` and may
        draw from ``generators`` (torch.Generators on this device). They
        are registered with the graph first: each replay then draws at
        the generator's offset and advances it, as the same calls made
        eagerly would, and the capture itself advances none."""
        for g in generators:
            self.graph.register_generator_state(g)
        with torch.cuda.graph(self.graph, stream=self.stream):
            fn()

    def replay(self):
        self.graph.replay()

    def hand_back(self, tensors):
        """Mark the loop's results as used on the caller's stream, so the
        caching allocator does not hand their memory to this stream while
        the caller still reads them."""
        for t in tensors:
            t.record_stream(self._caller)


class EagerBlockGraph:
    """CudaBlockGraph's stand-in for CPU tensors, with its contract:
    capture passes through fn once, as a capture does (the kernel wrappers
    count what it records), and leaves ``outputs`` and ``generators`` as
    they were (a capture runs nothing and draws nothing); replay runs fn
    again with the wrappers' counts hidden (a replay passes through no
    wrapper) and draws anew. Every block thus runs eagerly, and the
    capture's pass costs one block more per fit."""

    def on_stream(self):
        return contextlib.nullcontext()

    def capture(self, fn, outputs, generators=()):
        saved = [t.clone() for t in outputs]
        states = [g.get_state() for g in generators]
        fn()
        for t, s in zip(outputs, saved):
            t.copy_(s)
        for g, s in zip(generators, states):
            g.set_state(s)
        self._fn = fn

    def replay(self):
        counts = policy.launch_counts()
        self._fn()
        policy.set_launch_counts(counts)

    def hand_back(self, tensors):
        pass


def block_graph(loop: str, U: torch.Tensor):
    """The block graph of a fit whose factor U is given: None for the host
    loop; for the device loop a CudaBlockGraph on U's CUDA device, else the
    eager stand-in."""
    check_loop(loop)
    if loop == "host":
        return None
    if U.is_cuda:
        return CudaBlockGraph(U.device)
    return EagerBlockGraph()


def _capture_block(graph, block_fn, state, hyper, rng, n_steps: int, loss):
    """Capture one block of ``n_steps`` that reads and writes static
    copies of U, V and Z and writes its loss into a static 0-d tensor like
    ``loss``. Returns (the static state, the static loss, the launches one
    replay makes). ``rng``, the block's torch.Generator or None, is
    registered with the graph (each replay draws anew)."""
    statics = [t.clone() for t in state[2:]]
    static_state = tuple(state[:2]) + tuple(statics)
    static_loss = torch.empty_like(loss)

    def body():
        out, block_loss, _ = block_fn(static_state, hyper, rng, n_steps)
        for dst, src in zip(statics, out[2:]):
            dst.copy_(src)
        static_loss.copy_(block_loss)

    before = policy.launch_counts()
    graph.capture(body, statics + [static_loss],
                  (rng,) if isinstance(rng, torch.Generator) else ())
    launches = policy.launches_since(before)
    policy.set_launch_counts(before)  # a capture launches nothing
    return static_state, static_loss, launches


def run_solver_loop(block_fn, state, hyper, rng, *, max_iter: int, tol: float,
                    eval_every: int, verbose: int = 0,
                    initial_loss_fn=None, graph=None) -> tuple:
    """Loop over blocks of ``eval_every`` iterations with the
    relative-decrease stopping rule

        stop when (L_prev − L) / L_init < tol

    checked after every block (the last block may be shorter). A non-finite
    loss raises FloatingPointError.

    graph None is the host loop: every block runs eagerly. Otherwise it is
    the device loop (counterpart of the reference's ``device_fit_core``),
    with ``graph`` from :func:`block_graph`: the first block runs eagerly
    (the capture's warm-up); if a second full block will run, one full
    block is captured before it, and every full block after the first is a
    replay; a shorter last block runs eagerly. Either way the host reads
    the loss once per block, and ``step_times`` holds each block's host
    clock (the capture's in the block after it), so
    ``len(step_times) == len(loss_history) - 1``.
    """
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
    captured = False
    with graph.on_stream() if graph is not None else contextlib.nullcontext():
        while n_iter < max_iter:
            n_steps = min(eval_every, max_iter - n_iter)
            t0 = time.perf_counter()
            if graph is None or n_iter == 0 or n_steps < eval_every:
                state, loss_t, rng = block_fn(state, hyper, rng, n_steps)
            else:
                if not captured:
                    state, loss_t, launches = _capture_block(
                        graph, block_fn, state, hyper, rng, n_steps, loss_t)
                    captured = True
                graph.replay()
                policy.add_launches(launches)
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
        if graph is not None:
            graph.hand_back(state[2:])
    return state, n_iter, loss_history, loss_iters, step_times


def check_loop(loop: str) -> None:
    """'host': every block eager; 'device': the device loop, a CUDA graph
    of one block replayed per block on the card and the same schedule run
    eagerly on the CPU (see run_solver_loop)."""
    if loop not in ("host", "device"):
        raise ValueError("loop must be 'host' or 'device'")
