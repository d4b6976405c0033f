"""Sharded CMF: X split over the ranks of a process group, by rows or by
columns.

Counterpart of the ``"rows"`` and ``"cols"`` layouts of
``pycmf_tpu/parallel/sharded.py``, one process per shard.

**rows.** Rank r of d holds rows r·n_loc .. (r+1)·n_loc − 1 of X and U,
n_loc = ⌈n / d⌉, the last block padded with zero rows; V, Z and Y are
replicated. Each iteration sums V's shared X-side terms over the ranks
(BASELINE.json config #5: row-sharded X with an all-reduce of the
shared-V terms):

- MU: XᵀU_new and U_newᵀU_new, from K1 on a dense shard (rows past the
  shard's real ones come out zero), else from the CSR or BlockEll products;
- Newton on a linear X with the fused U pass (K2): the same pair, handed
  to V's update as already-summed terms;
- Newton otherwise: V's per-row G and H (K3's partials on a dense sigmoid
  X) and every line-search φ (K4's) of V's X term.

U's update is row-local and its padding rows stay exactly zero, so they add
nothing to any sum. At the end every rank gathers U.

**cols.** Rank r holds the shared dimension's block r·m_loc ..
(r+1)·m_loc − 1, m_loc = ⌈m / d⌉: X's column block, Y's row block and V's
row block, the last block padded with zeros; U and Z are replicated. The
sums move to U's and Z's terms: MU sums X·V, VᵀV and YᵀV (one all-reduce,
all from the same V); Newton sums U's and Z's G, H and φ (K3/K4's group
form on a dense sigmoid term). V's update is local to its rows (its
padding rows forced back to zero), and K1/K2 do not run: no rank holds
whole rows of X. At the end every rank gathers V.

The loss sums its per-rank parts in one all-reduce; with the
zero-extra-pass eval losses (the summed or local V terms, or V's Σφ) a
block's loss costs one small all-reduce. Every rank is given the whole host
X and Y, as the reference's single controller holds them, and uploads only
its own block of X (CSR or BlockEll by the single-device rule for that
block, the streamed chunked layout of ``ops/chunked.py``, or dense; under
fp8 data densified on the host and stored as e4m3, Y at bf16). The 2-D
``grid`` layout is ``parallel/grid.py``.

**Chunked blocks.** Under ``sparse_mode='chunked'``, or 'auto' for a
sigmoid-linked X under Newton whose block is past the densify threshold,
each rank builds the chunked layout of its own zero-padded block, its
chunk rows picked on the local shape (the same geometry on every rank).
Under 'rows' the U passes stream it chunk by chunk (K1, K2, or K3-K5 on
each chunk of a sigmoid X), the shard's padding rows cut by ``n_valid``
or its row mask, and V's terms stream its transpose (``ChunkedT``) and
are summed over the ranks; under 'cols' the products stream it. A
sigmoid-linked sparse Y past the threshold (or under 'chunked') takes the
chunked carrier: replicated under 'rows', one row block per rank under
'cols'.

**Sampled Newton** (``sg_sample_ratio`` < 1) draws the reference's
columns on every rank: each iteration's (kU, kZ, kV) split from the fit's
key, the rows layout folding kU with the rank and the cols layout kV
(``pycmf_tpu/parallel/sharded.py:1288, 1498``), a distributed term's key
folded with the rank (``solvers/newton.term_key``).

**The device loop** (``loop='device'``) runs ``solvers/common.py``'s loop
on each rank's state, as the reference runs ``device_fit_core`` inside
``shard_map``: the state is ``(ops, None, U, V, Z)`` (the reference's
``core(ops, None, U, V, Z, …)``), each block's collectives are captured
into the rank's graphs, and the ranks agree on each fit's branch
(``mesh.all_ranks``). On CUDA tensors it needs an NCCL group
(``mesh.captures``); on the CPU it runs the same schedule eagerly over
gloo.
"""
from __future__ import annotations

import warnings
from functools import partial
from typing import NamedTuple, Optional

import numpy as np
import scipy.sparse as sp
import torch

from ..ops.chunked import (chunked_inner, chunked_mu_u_pass,
                           chunked_newton_linear_u_pass, is_chunked)
from ..ops.links import LINEAR
from ..ops.losses import (penalty, reconstruction_term, sigmoid_sq_rows,
                          streamed_inner)
from ..ops.kernels import bell as kbell
from ..ops.kernels import mu_fused, newton_fused
from ..ops.kernels import spmm as kspmm
from ..ops.matmul import FP8_DTYPES, gram, matmul
from ..ops.random import KeyStream, fold_in, prng_key
from ..ops.sparse import is_sparse, sddmm_dot
from ..solvers.common import (Coupled, Hyper, SolverConfig, check_loop,
                              coupled_mm, run_solver_loop)
from ..solvers.mu import mu_ratio_update
from ..solvers.newton import (Term, _transposed, _with_transposes,
                              check_device_loop, fused_newton_u_allowed,
                              fused_sigmoid_allowed, fused_sigmoid_update,
                              newton_update_factor, shared_gauss_hinv)
from ..solvers.newton_chunked import chunked_sigmoid_row_update
from ..utils.validation import DENSIFY_THRESHOLD, as_coupled, check_fp8_range
from .mesh import (Mesh, all_ranks, all_reduce, captures, gather_rows,
                   group_key, make_mesh)


def key_stream(solver: str, cfg: SolverConfig, seed: int, device):
    """A sampled Newton fit's KeyStream, ``PRNGKey(seed)`` on ``device``
    from iteration 0 (the same key on every rank, folded per rank in the
    iterations), or None when nothing draws."""
    if solver != "newton" or cfg.sg_sample_ratio >= 1.0:
        return None
    return KeyStream.start(prng_key(seed, device))


def rank_keys(layout: str, keys, index: int) -> tuple:
    """(kU, kZ, kV) of this rank's factor updates from the step's keys
    (None when the step draws nothing): the rows layout folds kU with the
    rank (``pycmf_tpu/parallel/sharded.py:1288``), the cols layout kV with
    the rank (``:1498``), the grid kV with its COL index j
    (``pycmf_tpu/parallel/grid.py:479``); ``index``: the rank, or j. A
    distributed term folds its own key again (``solvers/newton.term_key``)."""
    if keys is None:
        return (None,) * 3
    kU, kZ, kV = keys
    if layout == "rows":
        return fold_in(kU, index), kZ, kV
    return kU, kZ, fold_in(kV, index)


class RowOperands(NamedTuple):
    """This rank's operands of the rows layout.

    X       : its row block of X, padded to n_loc rows, as a Coupled (dense,
              CSR or BlockEll, with the layout of the block's transpose, or
              chunked; and the block's norms: row_sq (n_loc,), row_sq_t (m,))
    Y       : the replicated Y (a Coupled) or None
    mask    : (n_loc,) 1 on the block's real rows, 0 on its padding
    n_valid : the block's real rows
    n_pad   : padding rows over all ranks (d·n_loc − n)
    a_sq    : ‖X‖² over all ranks (the factored eval loss)
    col_sq  : (m,) ‖(Xᵀ)ⱼ‖² over all ranks (V's term after the fused U pass)
    x_size  : elements of the padded X over all ranks (the eval-loss rule)
    """

    X: Coupled
    Y: Optional[Coupled]
    mask: torch.Tensor
    n_valid: int
    n_pad: int
    a_sq: torch.Tensor
    col_sq: torch.Tensor
    x_size: int


def row_block(X, n_loc: int, rank: int):
    """Rows rank·n_loc .. (rank+1)·n_loc − 1 of host X (CSR or ndarray),
    padded with zero rows to n_loc, and how many rows are real: the
    reference's split (``_prepare_rows``, ``_stack_csr_blocks``), of which
    each rank keeps its own block."""
    n, m = X.shape
    lo = min(rank * n_loc, n)
    hi = min(lo + n_loc, n)
    if sp.issparse(X):
        blk = sp.csr_matrix(X)[lo:hi]
        if hi - lo < n_loc:
            blk = sp.vstack([blk, sp.csr_matrix((n_loc - (hi - lo), m))])
        return sp.csr_matrix(blk), hi - lo
    blk = np.zeros((n_loc, m), dtype=np.asarray(X).dtype)
    blk[:hi - lo] = np.asarray(X)[lo:hi]
    return blk, hi - lo


def y_dtype(data_dtype) -> torch.dtype:
    """Y's storage dtype: X's, but bf16 under fp8 X (the reference
    quantizes only the big matrix)."""
    return torch.bfloat16 if data_dtype in FP8_DTYPES else data_dtype


def stored_block(blk, data_dtype):
    """A rank's block of X as it is uploaded: under fp8 a sparse block is
    densified on the host (at X's dtype) and stored as e4m3 at 1 byte per
    element by as_coupled, the norms those of the stored values (the
    reference's sharded fp8 shards and cells); else as it is."""
    if sp.issparse(blk) and data_dtype in FP8_DTYPES:
        return blk.toarray()
    return blk


def y_chunked(Y, rows: int, ydt, cfg: SolverConfig, chunked: bool) -> bool:
    """Whether a sigmoid-linked sparse Y takes the chunked carrier: under
    sparse_mode='chunked' (``chunked``), or when its dense copy of ``rows``
    rows (the whole Y under 'rows', the padded m under 'cols' and 'grid')
    is past the densify threshold. Reference: ``_prepare_rows``,
    ``_prepare_cols``, ``grid.py:_prepare_grid``."""
    return (sp.issparse(Y) and cfg.y_link != LINEAR
            and (chunked or rows * Y.shape[1] * ydt.itemsize
                 > DENSIFY_THRESHOLD))


def prepare_rows(X, Y, U0, mesh: Mesh, dtype, data_dtype, cfg: SolverConfig,
                 x_mode: str = "dense", chunked: bool = False):
    """(RowOperands, this rank's U block, n) on mesh.device.

    x_mode: how a sparse X's block is stored: 'dense' (densified on the
    device), 'csr' (CSR, or BlockEll under use_pallas where the block's
    128×128 tiles fill enough: as_coupled's single-device rule) or
    'chunked' (the streamed layout of the block, its chunk rows picked on
    the block's shape). A sparse Y stays CSR under a linear link (as the
    reference's rows layout keeps it); under a sigmoid one it is
    densified on the device, or replicated as the chunked carrier past the
    densify threshold or under ``chunked`` (sparse_mode='chunked').
    Reference: ``pycmf_tpu/parallel/sharded.py:_prepare_rows``."""
    n, m = X.shape
    d, dev, up = mesh.world, mesh.device, cfg.use_pallas
    n_loc = -(-n // d)
    blk, n_valid = row_block(X, n_loc, mesh.rank)
    blk = stored_block(blk, data_dtype)
    Xc = as_coupled(blk, data_dtype, dev, use_pallas=up,
                    sparse_mode=x_mode if sp.issparse(blk) else "auto")
    ydt = y_dtype(data_dtype)
    if Y is None:
        Yc = None
    elif sp.issparse(Y) and cfg.y_link == LINEAR:
        Yc = as_coupled(Y, ydt, dev, use_pallas=up, sparse_mode="csr")
    else:
        Yc = as_coupled(Y, ydt, dev, sparse_mode=(
            "chunked" if y_chunked(Y, Y.shape[0], ydt, cfg, chunked)
            else "dense"))
    # ‖X‖² and the column norms over all ranks: one all-reduce of the
    # blocks' own (host float64, stored at the factor precision)
    a_sq = _a_sq(Xc)
    col_sq, a_sq = all_reduce(mesh, Xc.row_sq_t, a_sq.to(Xc.row_sq_t.dtype))
    mask = torch.zeros(n_loc, dtype=dtype, device=dev)
    mask[:n_valid] = 1
    U = torch.zeros((n_loc, U0.shape[1]), dtype=dtype, device=dev)
    lo = min(mesh.rank * n_loc, n)
    U[:n_valid] = torch.as_tensor(np.asarray(U0[lo:lo + n_valid],
                                             dtype=np.float64)).to(dev, dtype)
    ops = RowOperands(Xc, Yc, mask, n_valid, d * n_loc - n, a_sq, col_sq,
                      d * n_loc * m)
    return ops, U, n


def _a_sq(Xc: Coupled) -> torch.Tensor:
    """A block's ‖X‖²: a sparse or chunked layout's own Σ data², else the
    dense block's host norm."""
    return Xc.A.sq_norm if is_sparse(Xc.A) or is_chunked(Xc.A) else Xc.a_sq


class ColOperands(NamedTuple):
    """This rank's operands of the cols layout.

    X       : its column block of X, padded to m_loc columns, as a Coupled
              (dense, CSR or BlockEll, with the layout of the block's
              transpose, or chunked; row_sq (n,) the PARTIAL ‖xᵢ‖² over the
              block's columns, which U's summed φ completes; row_sq_t
              (m_loc,) the EXACT norms of the block's rows of Xᵀ)
    Y       : its row block of Y (dense or chunked, m_loc rows) or None
    mask    : (m_loc,) 1 on the block's real shared-dimension entries
    m_valid : the block's real columns
    a_sq    : ‖X‖² over all ranks (the factored eval loss)
    x_size  : elements of the padded X over all ranks (the eval-loss rule)
    """

    X: Coupled
    Y: Optional[Coupled]
    mask: torch.Tensor
    m_valid: int
    a_sq: torch.Tensor
    x_size: int


def col_block(X, m_loc: int, rank: int):
    """Columns rank·m_loc .. (rank+1)·m_loc − 1 of host X (sparse or
    ndarray), padded with zero columns to m_loc, and how many are real:
    the reference's split (``_prepare_cols``), of which each rank keeps
    its own block (CSR when X is sparse)."""
    n, m = X.shape
    lo = min(rank * m_loc, m)
    hi = min(lo + m_loc, m)
    if sp.issparse(X):
        blk = sp.csc_matrix(X)[:, lo:hi]
        if hi - lo < m_loc:
            blk = sp.hstack([blk, sp.csc_matrix((n, m_loc - (hi - lo)))])
        return sp.csr_matrix(blk), hi - lo
    blk = np.zeros((n, m_loc), dtype=np.asarray(X).dtype)
    blk[:, :hi - lo] = np.asarray(X)[:, lo:hi]
    return blk, hi - lo


def prepare_cols(X, Y, V0, mesh: Mesh, dtype, data_dtype, cfg: SolverConfig,
                 x_mode: str = "dense", chunked: bool = False):
    """(ColOperands, this rank's V block, m) on mesh.device.

    x_mode: how a sparse X's block is stored, as in :func:`prepare_rows`
    ('dense'; 'csr': CSR, or BlockEll under use_pallas by the
    single-device rule; 'chunked'). Y's rows are the sharded axis here, so
    each rank stores its row block (:func:`y_block`: dense, or a
    sigmoid-linked sparse Y's chunked carrier). Reference:
    ``pycmf_tpu/parallel/sharded.py:_prepare_cols``."""
    n, m = X.shape
    d, dev, up = mesh.world, mesh.device, cfg.use_pallas
    m_loc = -(-m // d)
    blk, m_valid = col_block(X, m_loc, mesh.rank)
    blk = stored_block(blk, data_dtype)
    Xc = as_coupled(blk, data_dtype, dev, use_pallas=up,
                    sparse_mode=x_mode if sp.issparse(blk) else "auto")
    Yc = y_block(Y, d * m_loc, m_loc, mesh.rank, data_dtype, dev, cfg,
                 "cols", chunked)
    # ‖X‖² over all ranks: one all-reduce of the blocks' own
    a_sq = _a_sq(Xc)
    a_sq = all_reduce(mesh, a_sq.to(dtype))[0]
    mask = torch.zeros(m_loc, dtype=dtype, device=dev)
    mask[:m_valid] = 1
    V = torch.zeros((m_loc, V0.shape[1]), dtype=dtype, device=dev)
    lo = min(mesh.rank * m_loc, m)
    V[:m_valid] = torch.as_tensor(np.asarray(V0[lo:lo + m_valid],
                                             dtype=np.float64)).to(dev, dtype)
    ops = ColOperands(Xc, Yc, mask, m_valid, a_sq, n * d * m_loc)
    return ops, V, m


def y_block(Y, m_pad: int, m_loc: int, block: int, data_dtype, device,
            cfg: SolverConfig, layout: str,
            chunked: bool = False) -> Optional[Coupled]:
    """Row block ``block`` of Y (its rows are the sharded shared dimension,
    padded to m_pad) on ``device``, or None: dense, or the chunked
    carrier of the block for a sigmoid-linked sparse Y past the densify
    threshold or under ``chunked`` (sparse_mode='chunked'). A smaller
    sigmoid-linked sparse Y is densified on the device; a linear-linked
    sparse Y on the host, with the reference's warning. Reference:
    ``_prepare_cols``, ``pycmf_tpu/parallel/grid.py:_prepare_grid``."""
    if Y is None:
        return None
    ydt = y_dtype(data_dtype)
    mode = "dense"
    if sp.issparse(Y) and cfg.y_link != LINEAR:
        if y_chunked(Y, m_pad, ydt, cfg, chunked):
            mode = "chunked"
    elif sp.issparse(Y):
        what = ("a dense row-sharded block on each device" if layout == "cols"
                else "dense COL-sharded blocks")
        warnings.warn(
            f"shard_layout={layout!r} stores a LINEAR-linked sparse Y as "
            f"{what}; the sparse Y was densified on the host "
            f"({Y.shape[0]}x{Y.shape[1]}). Fine for label matrices; for a "
            "large sparse Y use shard_layout='rows'"
            + (" (keeps Y CSR)." if layout == "cols" else "."),
            UserWarning, stacklevel=4)
        Y = np.asarray(Y.todense())
    yblk = col_block(Y.T, m_loc, block)[0].T
    return as_coupled(yblk, ydt, device, sparse_mode=mode)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


def _plus_y(cfg: SolverConfig, ops: RowOperands, loss, V, Z, hyper: Hyper):
    """loss + the replicated Y's term + R(Z)."""
    Y = ops.Y
    loss = loss + reconstruction_term(
        Y.A, V, Z, cfg.y_link, a_sq=Y.a_sq, bell_t=Y.At_bell,
        use_pallas=cfg.use_pallas)
    return loss + penalty(Z, hyper.alpha, hyper.l1_ratio)


def _padded(ops: RowOperands) -> bool:
    return ops.n_valid < ops.mask.shape[0]


def loss_rows(cfg: SolverConfig, ops: RowOperands, U, V, Z, hyper: Hyper,
              mesh: Mesh):
    """L(U, V, Z) with X and U row-sharded: the X side and U's penalty
    summed over the ranks in one all-reduce. A chunked block streams its
    inner product, or its sigmoid residual with the shard's padding rows
    masked. Reference: ``pycmf_tpu/parallel/sharded.py:_loss_rows``."""
    X, up = ops.X, cfg.use_pallas
    pen_u = penalty(U, hyper.alpha, hyper.l1_ratio)
    if cfg.x_link == LINEAR:
        if is_chunked(X.A):
            a_sq = X.A.sq_norm
            inner = chunked_inner(X.A, U, V)
        elif is_sparse(X.A):
            a_sq = X.A.sq_norm
            if up and X.At_bell is not None:
                inner = kbell.bell_inner(X.At_bell, U, V)
            elif up:
                inner = torch.sum(kspmm.csr_rowdots(X.A, U, V))
            else:
                inner = sddmm_dot(X.A, U, V)
        else:
            a_sq = X.a_sq
            inner = streamed_inner(X.A, U, V)
        gU, part, pen_u = all_reduce(mesh, gram(U), a_sq - 2.0 * inner,
                                     pen_u)
        x_term = 0.5 * (part + torch.sum(gU * gram(V)))
    elif is_chunked(X.A):
        x_term, pen_u = all_reduce(mesh, reconstruction_term(
            X.A, U, V, cfg.x_link,
            row_mask=ops.mask if _padded(ops) else None), pen_u)
    else:
        rows = sigmoid_sq_rows(X.A, U, V)
        if _padded(ops):
            rows = rows * ops.mask
        x_term, pen_u = all_reduce(mesh, torch.sum(rows), pen_u)
    loss = x_term + pen_u + penalty(V, hyper.alpha, hyper.l1_ratio)
    if cfg.has_Y:
        loss = _plus_y(cfg, ops, loss, V, Z, hyper)
    return loss


def _aux_loss_rows(cfg: SolverConfig, mesh: Mesh, kind: str):
    """The eval loss from what the last step summed anyway: "factored"
    (ΣXᵀU_new, ΣU_newᵀU_new: the factored identity with ‖X‖²) or "phi"
    (V's Σφ at the accepted candidates, X and Y terms and R(V) in it);
    U's penalty is the one all-reduce. Reference:
    ``pycmf_tpu/parallel/sharded.py:_aux_loss_rows``, ``_aux_loss_rows_phi``."""

    def loss_fn(state, aux, hyper: Hyper):
        ops, U, V, Z = state
        pen_u = all_reduce(mesh, penalty(U, hyper.alpha, hyper.l1_ratio))[0]
        if kind == "phi":
            loss = aux + pen_u
            if cfg.has_Y:
                loss = loss + penalty(Z, hyper.alpha, hyper.l1_ratio)
            return loss
        num, S = aux
        inner = (num * V).sum()
        x_term = 0.5 * (ops.a_sq - 2.0 * inner + (S * gram(V)).sum())
        loss = x_term + pen_u + penalty(V, hyper.alpha, hyper.l1_ratio)
        if cfg.has_Y:
            loss = _plus_y(cfg, ops, loss, V, Z, hyper)
        return loss

    return loss_fn


def _rows_aux_ok(cfg: SolverConfig, ops: RowOperands, U) -> bool:
    """MU qualifies whenever U and V both update (their summed V terms are
    the aux pair); not a small dense X stored below the factors' precision
    (the identity's cancellation), judged on the whole padded X."""
    if not (cfg.update_U and cfg.update_V and cfg.x_link == LINEAR):
        return False
    A = ops.X.A
    return (is_sparse(A) or is_chunked(A) or A.dtype == U.dtype
            or ops.x_size >= (1 << 22))


def rows_aux_kind(cfg: SolverConfig, ops: RowOperands, U, solver: str):
    """None | "factored" | "phi" (reference: ``_rows_aux_kind``): Newton's
    factored loss needs the fused U pass (or a chunked block's streamed U
    pass, full batch), its φ loss (a sigmoid X) the V update, a line
    search and the full batch."""
    if solver == "mu" or cfg.x_link == LINEAR:
        A = ops.X.A
        ok = _rows_aux_ok(cfg, ops, U) and (
            solver == "mu"
            or (cfg.sg_sample_ratio >= 1.0 if is_chunked(A)
                else fused_newton_u_allowed(cfg, A, ops.X.row_sq, U)))
        return "factored" if ok else None
    if not (cfg.update_V and cfg.line_search_trials >= 1
            and cfg.sg_sample_ratio >= 1.0):
        return None
    return "phi"


# ---------------------------------------------------------------------------
# iterations
# ---------------------------------------------------------------------------


def mu_rows_iter(cfg: SolverConfig, ops: RowOperands, U, V, Z, hyper: Hyper,
                 mesh: Mesh):
    """One MU iteration: (U, V, Z, (ΣXᵀU_new, ΣU_newᵀU_new) or None). A
    chunked block takes the streamed U pass (K1 per chunk under
    use_pallas), the shard's padding rows cut by ``n_valid``. Reference:
    ``pycmf_tpu/parallel/sharded.py:_mu_rows_iter``."""
    l1, l2, eps, up = hyper.l1, hyper.l2, hyper.eps, cfg.use_pallas
    X = ops.X
    chunk = is_chunked(X.A) and cfg.update_V
    fused = (up and cfg.update_U and cfg.update_V and not is_sparse(X.A)
             and not is_chunked(X.A) and U.dtype != torch.bfloat16)
    num_vx = gram_u = None
    VtV = gram(V) if (cfg.update_U or (cfg.has_Y and cfg.update_Z)) else None
    if cfg.update_U:
        # the padding rows come out exactly zero: their ratio is 0·0/0 = NaN
        # when l1 = eps = 0, and a NaN row would poison every sum
        if chunk:
            U, num_vx, gram_u = chunked_mu_u_pass(
                X.A, U, V, VtV, l1, l2, eps, up, n_valid=ops.n_valid)
        elif fused:
            U, num_vx, gram_u = mu_fused.fused_mu_u_pass(
                X.A, U, V, VtV, l1, l2, eps, n_valid=ops.n_valid)
        else:
            num = coupled_mm(X, V, use_pallas=up)
            U = mu_ratio_update(U, VtV, num, l1, l2, eps, up)
            if _padded(ops):
                U = torch.where(ops.mask[:, None] > 0.5, U, 0.0)
    if cfg.has_Y and cfg.update_Z:
        num = coupled_mm(ops.Y, V, transpose=True, use_pallas=up)
        Z = mu_ratio_update(Z, VtV, num, l1, l2, eps, up)
    aux = None
    if cfg.update_V:
        if num_vx is None:
            num_vx = coupled_mm(X, U, transpose=True, use_pallas=up)
            gram_u = gram(U)
        num, S = aux = tuple(all_reduce(mesh, num_vx, gram_u))
        if cfg.has_Y:
            num = num + coupled_mm(ops.Y, Z, use_pallas=up)
            S = S + gram(Z)
        V = mu_ratio_update(V, S, num, l1, l2, eps, up)
    return U, V, Z, aux


def newton_rows_iter(cfg: SolverConfig, ops: RowOperands, U, V, Z,
                     hyper: Hyper, mesh: Mesh, with_aux=None, keys=None):
    """One Newton iteration, U then Z then V: (U, V, Z, aux), aux the
    summed (XᵀU_new, U_newᵀU_new) under with_aux="factored", V's Σφ under
    "phi", else None. Sampled (``keys``: the step's (kU, kZ, kV)): kU is
    folded with the rank (the rank's own rows), V's X term, distributed,
    folds its key with the rank; Z's term and V's Y term draw alike on
    every rank. A chunked block: U's full-batch update streams its chunks
    (K2 per chunk on a linear X, handing V the summed pair; K3-K5 per
    chunk on a sigmoid X), V's X term its transpose (``ChunkedT``), summed
    over the ranks. Reference: ``pycmf_tpu/parallel/sharded.py:_newton_rows_iter``."""
    common = dict(trials=cfg.line_search_trials,
                  hessian_form=cfg.hessian_form,
                  sample_ratio=cfg.sg_sample_ratio, use_pallas=cfg.use_pallas)
    fused_kw = dict(trials=cfg.line_search_trials, use_pallas=cfg.use_pallas)
    X, Y = ops.X, ops.Y
    mask = mask_u = ops.mask if _padded(ops) else None
    kU, kZ, kV = rank_keys("rows", keys, mesh.rank)
    chunk = is_chunked(X.A) and cfg.sg_sample_ratio >= 1.0
    numv_x = gram_u = None
    if cfg.update_U:
        # row-local: no collective; the padding rows stay exactly zero
        if chunk and cfg.x_link != LINEAR:
            U = chunked_sigmoid_row_update(
                X.A, U, V, hyper, trials=cfg.line_search_trials,
                non_negative=cfg.U_non_negative,
                hessian_form=cfg.hessian_form, use_pallas=cfg.use_pallas,
                row_mask=mask)
            mask_u = None   # zeroed inside
        elif chunk and cfg.update_V:
            BtB, Hinv, l1, l2 = shared_gauss_hinv(V, hyper)
            U, numv_x, gram_u = chunked_newton_linear_u_pass(
                X.A, U, V, BtB, Hinv, X.row_sq, l1, l2,
                trials=cfg.line_search_trials,
                non_negative=cfg.U_non_negative, use_pallas=cfg.use_pallas,
                n_valid=ops.n_valid)
        elif fused_newton_u_allowed(cfg, X.A, X.row_sq, U):
            BtB, Hinv, l1, l2 = shared_gauss_hinv(V, hyper)
            U, numv_x, gram_u = newton_fused.fused_newton_linear_u_pass(
                X.A, U, V, BtB, Hinv, X.row_sq, l1, l2,
                trials=cfg.line_search_trials,
                non_negative=cfg.U_non_negative)
        elif cfg.x_link != LINEAR and fused_sigmoid_allowed(cfg, X.A, U):
            U = fused_sigmoid_update(U, X.A, V, hyper,
                                     non_negative=cfg.U_non_negative,
                                     row_mask=mask, **fused_kw)
            mask_u = None   # zeroed inside
        else:
            # local rows, kU folded with the rank (rank_keys)
            U = newton_update_factor(
                kU, U, (Term(X.A, V, X.row_sq, layout=X.A_bell),),
                (cfg.x_link,), hyper, non_negative=cfg.U_non_negative,
                **common)
        if mask_u is not None:
            U = U * mask_u[:, None]
    if cfg.has_Y and cfg.update_Z:
        # Y is replicated: every rank makes the same update (a sampled
        # one under the same key)
        if cfg.y_link != LINEAR and fused_sigmoid_allowed(cfg, Y.A, Z):
            Z = fused_sigmoid_update(Z, _transposed(Y), V, hyper,
                                     non_negative=cfg.Z_non_negative,
                                     **fused_kw)
        else:
            Z = newton_update_factor(
                kZ, Z, (Term(_transposed(Y), V, Y.row_sq_t,
                                 layout=Y.At_bell),),
                (cfg.y_link,), hyper, non_negative=cfg.Z_non_negative,
                **common)
    aux = None
    if cfg.update_V:
        phi = with_aux == "phi"
        yterm = (Term(Y.A, Z, Y.row_sq, layout=Y.A_bell) if cfg.has_Y
                 else None)
        Xt = _transposed(X)
        if numv_x is not None:
            # the fused U pass's terms, summed once: V's X term is then
            # global, with the column norms of the whole X
            num, S = aux = tuple(all_reduce(mesh, numv_x, gram_u))
            terms, dist = (Term(Xt, U, ops.col_sq, DB=num, BtB=S),), (False,)
        elif cfg.x_link != LINEAR and fused_sigmoid_allowed(cfg, Xt, V):
            out = fused_sigmoid_update(
                V, Xt, U, hyper, non_negative=cfg.V_non_negative,
                yterm=yterm, y_link=cfg.y_link, group=mesh, return_phi=phi,
                **fused_kw)
            if phi:
                # K4's φ counts σ(0) = ½ on every padding column: 0.125
                # per padding row of X and row of V, summed over the ranks
                V, phi_rows = out
                aux = phi_rows.sum() - 0.125 * V.shape[0] * ops.n_pad
            else:
                V = out
            terms = None
        else:
            terms = (Term(Xt, U, X.row_sq_t, layout=X.At_bell),)
            dist = (True,)
        if terms is not None:
            links = (cfg.x_link,)
            masks = (mask if cfg.x_link != LINEAR else None,)
            if cfg.has_Y:
                terms, links = terms + (yterm,), links + (cfg.y_link,)
                dist, masks = dist + (False,), masks + (None,)
            out = newton_update_factor(
                kV, V, terms, links, hyper,
                non_negative=cfg.V_non_negative, distributed=dist,
                masks=masks, group=mesh, return_phi=phi, **common)
            if phi:
                V, phi_rows = out
                aux = phi_rows.sum()
            else:
                V = out
    return U, V, Z, aux


# ---------------------------------------------------------------------------
# the cols layout: losses and iterations
# ---------------------------------------------------------------------------


def _cols_padded(ops: ColOperands) -> bool:
    return ops.m_valid < ops.mask.shape[0]


def _reduce_cols(cfg: SolverConfig, ops: ColOperands, V, Z, hyper: Hyper,
                 mesh: Mesh, x_parts, need_gv: bool):
    """Sum ``x_parts`` over the ranks with what every cols loss sums: VᵀV
    (when ``need_gv``), R(V) and the local parts of Y's term, in one
    all-reduce. Returns (the summed x_parts, ΣVᵀV or None, R(V) + Y's
    term + R(Z)). Y's term is summed over its row blocks: linear,
    ½(‖Y‖² − 2⟨YᵀV, Z⟩ + ⟨VᵀV, ZᵀZ⟩); sigmoid, the masked residual (a
    padding row's σ(0) = ½ is not data). Reference: ``_loss_cols``."""
    dt = V.dtype
    local = list(x_parts)
    if need_gv:
        local.append(gram(V))
    local.append(penalty(V, hyper.alpha, hyper.l1_ratio))
    if cfg.has_Y:
        local += y_parts(cfg, ops.Y, V, Z,
                         ops.mask if _cols_padded(ops) else None)
    sums = all_reduce(mesh, *(t.to(dt) for t in local))
    nx = len(x_parts)
    x_sums, rest = sums[:nx], sums[nx:]
    gV = rest.pop(0) if need_gv else None
    rest_loss = rest.pop(0)
    if cfg.has_Y:
        rest_loss = rest_loss + y_term(cfg, rest, gV, Z, hyper)
    return x_sums, gV, rest_loss


def y_parts(cfg: SolverConfig, Y: Coupled, V, Z, mask=None) -> list:
    """This rank's parts of Y's term over its row block Y_b (V_b its rows
    of V), each summed over the blocks by the caller: linear, ‖Y_b‖² and
    ⟨Y_bᵀV_b, Z⟩; sigmoid, the residual masked on the padding rows
    (``mask``: σ(0) = ½ is not data), streamed over a chunked carrier's
    chunks."""
    if is_chunked(Y.A):
        return [reconstruction_term(Y.A, V, Z, cfg.y_link, row_mask=mask)]
    Yf = Y.A.to(V.dtype)
    if cfg.y_link == LINEAR:
        return [torch.sum(Yf * Yf), torch.sum(matmul(Yf.mT, V) * Z)]
    rows = sigmoid_sq_rows(Yf, V, Z)
    if mask is not None:
        rows = rows * mask
    return [torch.sum(rows)]


def y_term(cfg: SolverConfig, sums, gV, Z, hyper: Hyper):
    """Y's term + R(Z) from the summed :func:`y_parts` (linear:
    ½(‖Y‖² − 2⟨YᵀV, Z⟩ + ⟨VᵀV, ZᵀZ⟩), gV the summed VᵀV)."""
    if cfg.y_link == LINEAR:
        y_sq, y_inner = sums
        term = 0.5 * (y_sq - 2.0 * y_inner + torch.sum(gV * gram(Z)))
    else:
        term = sums[0]
    return term + penalty(Z, hyper.alpha, hyper.l1_ratio)


def loss_cols(cfg: SolverConfig, ops: ColOperands, U, V, Z, hyper: Hyper,
              mesh: Mesh):
    """L(U, V, Z) with the shared dimension sharded: X's term, R(V) and Y's
    term summed over the ranks in one all-reduce, whose one Gram of V
    serves both linear terms. A linear X term takes the factored identity
    with ⟨X_loc, U V_locᵀ⟩ = Σ((X_locᵀU) ⊙ V_loc); a sigmoid one the
    residual masked on the padding columns (σ(0) = ½ ≠ 0). A chunked
    block streams both. Reference:
    ``pycmf_tpu/parallel/sharded.py:_loss_cols``."""
    X, up = ops.X, cfg.use_pallas
    mask = ops.mask if _cols_padded(ops) else None
    if cfg.x_link == LINEAR:
        if is_chunked(X.A):
            a_sq = X.A.sq_norm
            inner = chunked_inner(X.A, U, V)
        elif is_sparse(X.A):
            a_sq = X.A.sq_norm
            if up and X.At_bell is not None:
                inner = kbell.bell_inner(X.At_bell, U, V)
            else:
                inner = torch.sum(coupled_mm(X, U, transpose=True,
                                             use_pallas=up) * V)
        else:
            a_sq = X.a_sq
            inner = streamed_inner(X.A.mT, V, U)
        parts = (a_sq.to(U.dtype) - 2.0 * inner,)
    elif is_chunked(X.A):
        parts = (reconstruction_term(X.A, U, V, cfg.x_link, col_mask=mask),)
    else:
        parts = (torch.sum(sigmoid_sq_rows(X.A, U, V, mask)),)
    need_gv = cfg.x_link == LINEAR or (cfg.has_Y and cfg.y_link == LINEAR)
    (x_sum,), gV, rest = _reduce_cols(cfg, ops, V, Z, hyper, mesh, parts,
                                      need_gv)
    if cfg.x_link == LINEAR:
        x_sum = 0.5 * (x_sum + torch.sum(gram(U) * gV))
    return x_sum + penalty(U, hyper.alpha, hyper.l1_ratio) + rest


def _aux_loss_cols(cfg: SolverConfig, mesh: Mesh, kind: str):
    """The eval loss from what the last step computed anyway: "factored"
    (this rank's X_locᵀU_new and U_newᵀU_new: V is sharded, so only
    ⟨X_locᵀU_new, V_loc⟩, VᵀV, R(V) and Y's parts are summed) or "phi"
    (V's Σφ at the accepted candidates, already summed: X and Y terms and
    R(V)); U and Z are replicated, their penalties added once. Reference:
    ``pycmf_tpu/parallel/sharded.py:_aux_loss_cols``,
    ``_aux_loss_cols_phi``."""

    def loss_fn(state, aux, hyper: Hyper):
        ops, U, V, Z = state
        pen_u = penalty(U, hyper.alpha, hyper.l1_ratio)
        if kind == "phi":
            loss = aux + pen_u
            if cfg.has_Y:
                loss = loss + penalty(Z, hyper.alpha, hyper.l1_ratio)
            return loss
        num, S = aux
        (inner,), gV, rest = _reduce_cols(cfg, ops, V, Z, hyper, mesh,
                                          (torch.sum(num * V),), True)
        x_term = 0.5 * (ops.a_sq - 2.0 * inner + torch.sum(S * gV))
        return x_term + pen_u + rest

    return loss_fn


def cols_aux_kind(cfg: SolverConfig, ops: ColOperands, V, solver: str):
    """None | "factored" | "phi" (reference: ``_cols_aux_kind``,
    ``_cols_aux_ok``, ``_cols_aux_ok_newton``). The factored loss needs U
    and V updating, a linear X, and not a small dense X stored below the
    factors' precision (the identity's cancellation, judged on the whole
    padded X); under Newton also the full batch and the Gauss-Newton form
    (V's update hands over its X term's pair). The φ loss (a sigmoid X)
    needs the V update, a line search and the full batch."""
    if solver == "mu" or cfg.x_link == LINEAR:
        A = ops.X.A
        ok = (cfg.update_U and cfg.update_V and cfg.x_link == LINEAR
              and (is_sparse(A) or is_chunked(A) or A.dtype == V.dtype
                   or ops.x_size >= (1 << 22)))
        if solver != "mu":
            ok = (ok and cfg.sg_sample_ratio >= 1.0
                  and cfg.hessian_form == "gauss")
        return "factored" if ok else None
    if not (cfg.update_V and cfg.line_search_trials >= 1
            and cfg.sg_sample_ratio >= 1.0):
        return None
    return "phi"


def mu_cols_iter(cfg: SolverConfig, ops: ColOperands, U, V, Z, hyper: Hyper,
                 mesh: Mesh):
    """One MU iteration: (U, V, Z, (X_locᵀU_new, U_newᵀU_new) or None).
    U's X·V and VᵀV and Z's YᵀV are summed in one all-reduce (all from the
    same V); V's update is local. Reference:
    ``pycmf_tpu/parallel/sharded.py:_mu_cols_iter``."""
    l1, l2, eps, up = hyper.l1, hyper.l2, hyper.eps, cfg.use_pallas
    X, Y = ops.X, ops.Y
    upd_z = cfg.has_Y and cfg.update_Z
    local = []
    if cfg.update_U or upd_z:
        local.append(gram(V))
    if cfg.update_U:
        local.append(coupled_mm(X, V, use_pallas=up))
    if upd_z:
        local.append(matmul(Y.A.mT, V))
    sums = all_reduce(mesh, *local) if local else []
    if cfg.update_U:
        U = mu_ratio_update(U, sums[0], sums[1], l1, l2, eps, up)
    if upd_z:
        Z = mu_ratio_update(Z, sums[0], sums[-1], l1, l2, eps, up)
    aux = None
    if cfg.update_V:
        num = coupled_mm(X, U, transpose=True, use_pallas=up)
        S = gram(U)
        aux = (num, S)
        if cfg.has_Y:
            num = num + matmul(Y.A, Z)
            S = S + gram(Z)
        V = mu_ratio_update(V, S, num, l1, l2, eps, up)
        if _cols_padded(ops):
            # the padding rows are 0·0/0 = NaN when l1 = eps = 0: back to
            # exact zeros before they enter any sum
            V = torch.where(ops.mask[:, None] > 0.5, V, 0.0)
    return U, V, Z, aux


def newton_cols_iter(cfg: SolverConfig, ops: ColOperands, U, V, Z,
                     hyper: Hyper, mesh: Mesh, with_aux=None, keys=None):
    """One Newton iteration, U then Z then V: (U, V, Z, aux), aux this
    rank's (X_locᵀU_new, U_newᵀU_new) under with_aux="factored", V's
    summed Σφ under "phi", else None. U's and Z's G, H and φ are summed
    over the ranks (their terms' columns are the sharded m); V's update is
    local. Sampled (``keys``: the step's (kU, kZ, kV)): U's and Z's terms,
    distributed, fold their keys with the rank, and kV is folded with the
    rank before V's update (its rows are the rank's own columns). A
    chunked block or Y carrier streams its products (its
    transpose through ``ChunkedT``). Reference:
    ``pycmf_tpu/parallel/sharded.py:_newton_cols_iter``."""
    common = dict(trials=cfg.line_search_trials,
                  hessian_form=cfg.hessian_form,
                  sample_ratio=cfg.sg_sample_ratio, use_pallas=cfg.use_pallas)
    fused_kw = dict(trials=cfg.line_search_trials, use_pallas=cfg.use_pallas)
    X, Y = ops.X, ops.Y
    mask = ops.mask if _cols_padded(ops) else None
    kU, kZ, kV = rank_keys("cols", keys, mesh.rank)
    if cfg.update_U:
        if cfg.x_link != LINEAR and fused_sigmoid_allowed(cfg, X.A, U):
            # K3/K4's partials summed; the padding columns pair with V's
            # zero rows (fused_sigmoid_update's group contract)
            U = fused_sigmoid_update(U, X.A, V, hyper,
                                     non_negative=cfg.U_non_negative,
                                     group=mesh, **fused_kw)
        else:
            U = newton_update_factor(
                kU, U, (Term(X.A, V, X.row_sq, layout=X.A_bell),),
                (cfg.x_link,), hyper, non_negative=cfg.U_non_negative,
                distributed=(True,),
                masks=(mask if cfg.x_link != LINEAR else None,), group=mesh,
                **common)
    if cfg.has_Y and cfg.update_Z:
        if cfg.y_link != LINEAR and fused_sigmoid_allowed(cfg, Y.A, Z):
            Z = fused_sigmoid_update(Z, _transposed(Y), V, hyper,
                                     non_negative=cfg.Z_non_negative,
                                     group=mesh, **fused_kw)
        else:
            Z = newton_update_factor(
                kZ, Z, (Term(_transposed(Y), V),), (cfg.y_link,), hyper,
                non_negative=cfg.Z_non_negative, distributed=(True,),
                masks=(mask if cfg.y_link != LINEAR else None,), group=mesh,
                **common)
    aux = None
    if cfg.update_V:
        phi = with_aux == "phi"
        yterm = Term(Y.A, Z, Y.row_sq) if cfg.has_Y else None
        Xt = _transposed(X)
        if cfg.x_link != LINEAR and fused_sigmoid_allowed(cfg, Xt, V):
            # V's rows see whole columns of X and whole rows of Y: the
            # single-device call, the padding rows zeroed by row_mask
            out = fused_sigmoid_update(
                V, Xt, U, hyper, non_negative=cfg.V_non_negative,
                yterm=yterm, y_link=cfg.y_link, row_mask=mask,
                return_phi=phi, **fused_kw)
            if phi:
                V, phi_rows = out
                aux = all_reduce(mesh, phi_rows.sum())[0]
            else:
                V = out
        else:
            terms = (Term(Xt, U, X.row_sq_t, layout=X.At_bell),)
            links = (cfg.x_link,)
            if cfg.has_Y:
                terms, links = terms + (yterm,), links + (cfg.y_link,)
            # V's rows are this rank's columns: kV folded with the rank
            out = newton_update_factor(
                kV, V, terms, links, hyper,
                non_negative=cfg.V_non_negative, return_phi=phi,
                term_cache=0 if with_aux == "factored" else None, **common)
            if phi:
                V, phi_rows = out
                if mask is not None:
                    phi_rows = phi_rows * mask
                aux = all_reduce(mesh, phi_rows.sum())[0]
            elif with_aux == "factored":
                V, aux = out
            else:
                V = out
            if mask is not None:
                V = V * mask[:, None]   # the padding rows back to zero
    return U, V, Z, aux


# ---------------------------------------------------------------------------
# the fit
# ---------------------------------------------------------------------------


def make_block(cfg: SolverConfig, solver: str, mesh, aux, *, mu_iter,
               newton_iter, loss, aux_loss):
    """(block, initial loss) for run_solver_loop over a sharded layout's
    state (ops, None, U, V, Z), the solvers' (X, Y, U, V, Z) with the
    layout's operands in X's place, so the host and device loops take it
    as they take a single device's (the reference's ``core(ops, None, U,
    V, Z, …)``): a block runs n_steps iterations (``mu_iter`` or
    ``newton_iter``, the latter given each step's (kU, kZ, kV) from the
    loop's rng, a sampled fit's KeyStream, advanced past the block), then
    the eval loss (``aux_loss(cfg, mesh, aux)`` where
    ``aux`` names one, else ``loss``). Each layout passes its own functions
    and the mesh they take (a Mesh, or the grid's GridMesh). Reference:
    ``_make_rows_block`` and ``_make_cols_block`` in
    ``pycmf_tpu/parallel/sharded.py``, ``_make_grid_block`` in ``grid.py``."""
    aux_fn = aux_loss(cfg, mesh, aux) if aux is not None else None

    def loss_fn(state, hyper: Hyper):
        ops, _, U, V, Z = state
        return loss(cfg, ops, U, V, Z, hyper, mesh)

    def block(state, hyper: Hyper, rng, n_steps: int):
        ops, _, U, V, Z = state
        a = None
        for i in range(n_steps):
            if solver == "mu":
                U, V, Z, a = mu_iter(cfg, ops, U, V, Z, hyper, mesh)
            else:
                U, V, Z, a = newton_iter(
                    cfg, ops, U, V, Z, hyper, mesh, with_aux=aux,
                    keys=None if rng is None else rng.step_keys(i))
        if rng is not None:
            rng.advance(n_steps)
        state = (ops, None, U, V, Z)
        if aux is None:
            return state, loss_fn(state, hyper), rng
        return state, aux_fn((ops, U, V, Z), a, hyper), rng

    return block, loss_fn


def check_shardable(*, layout: str = "rows", loop: str = "host",
                    mesh: Optional[Mesh] = None) -> None:
    """Raise ValueError for an unknown layout and, given the fit's
    ``mesh``, for loop='device' on CUDA tensors over a group whose
    collectives a CUDA graph cannot capture (gloo: ``mesh.captures``)."""
    if layout not in ("rows", "cols", "grid"):
        raise ValueError(
            f"layout must be 'rows', 'cols' or 'grid', got {layout!r}")
    if (loop == "device" and mesh is not None and mesh.device.type == "cuda"
            and not captures(mesh.device, mesh.group)):
        raise ValueError(
            "loop='device' under n_shards > 1 captures each block's "
            "collectives into CUDA graphs, which needs an NCCL process "
            "group: a gloo all-reduce of CUDA tensors goes through the host "
            "and cannot be captured; use loop='host' (or 'auto') over gloo")


def factor(A, device, dtype) -> torch.Tensor:
    return torch.as_tensor(np.asarray(A, dtype=np.float64)).to(device, dtype)


def x_mode(X, local: int, ddt, cfg: SolverConfig, solver: str,
           sparse_mode: str, where: str = "shard") -> str:
    """How each rank stores its block of X (``local`` elements): 'dense',
    or for a sparse X 'chunked' under 'chunked', 'csr' under 'csr', and
    under 'auto', when the block's dense copy at the storage dtype (fp8: 1
    byte per element) is past the densify threshold (the reference's rule
    on the local shard or cell), 'chunked' for a sigmoid-linked X under
    Newton (the reference's per-shard streamed layout) and 'csr' for any
    other. The reference streams a scattered linear block past the
    threshold too; the port keeps it CSR (or BlockEll), as on one device
    (ROADMAP C4, owned by A7). Under fp8 the range is checked and a block
    that would stay sparse raises the reference's ValueError. A
    sigmoid-linked X under Newton cannot stay CSR (its terms need dense
    or chunked data): 'csr' raises ValueError there. ``where``: 'shard'
    or 'cell'."""
    mode = "dense"
    sig_newton = cfg.x_link != LINEAR and solver == "newton"
    if sp.issparse(X) and sparse_mode in ("csr", "chunked"):
        mode = sparse_mode
    elif (sp.issparse(X) and sparse_mode != "dense"
          and local * ddt.itemsize > DENSIFY_THRESHOLD):
        mode = "chunked" if sig_newton else "csr"
    if ddt in FP8_DTYPES:
        if mode != "dense":
            more = "more shards" if where == "shard" else "a bigger grid"
            raise ValueError(
                f"fp8 data storage requires dense device {where}s, but X "
                f"stays sparse under sparse_mode={sparse_mode!r} at this "
                f"{where} size; use data_dtype='bfloat16' or {more}")
        check_fp8_range(X, ddt)
    if mode == "csr" and sig_newton:
        raise ValueError(
            "sparse_mode='csr' cannot hold a sigmoid-linked X under Newton "
            f"(its terms need dense or chunked data); use sparse_mode="
            "'dense', 'chunked' or 'auto'")
    return mode


def run_sharded(solver: str, X, Y, U0, V0, Z0, cfg: SolverConfig,
                hyper: Hyper, *, n_shards: Optional[int] = None,
                group=None, layout: str = "rows", dtype=torch.float32,
                data_dtype=None, device="cuda", max_iter: int = 200,
                tol: float = 1e-4, eval_every: int = 10, verbose: int = 0,
                loop: str = "host", sparse_mode: str = "auto",
                seed: int = 0):
    """The sharded fit, on this process's rank of ``group`` (default: the
    default process group), whose size must be ``n_shards`` when that is
    given. X, Y: the whole host matrices (ndarray or scipy.sparse), on every
    rank; U0, V0, Z0: host arrays (Z0 may be None), the same on every rank.
    Returns (U, V, Z, n_iter, loss_history, loss_iters, step_times), the
    sharded factor (U under 'rows', V's real rows under 'cols') gathered
    over the ranks: the same on every rank.

    sparse_mode (a sparse X): 'dense' densifies this rank's block; 'csr'
    keeps it CSR, or BlockEll under use_pallas where its tiles fill
    enough; 'chunked' streams it (a chunked block per rank, and a
    sigmoid-linked sparse Y's chunked carrier); 'auto' densifies it when
    the block's dense copy (⌈n/d⌉·m elements under 'rows', n·⌈m/d⌉ under
    'cols') fits the densify threshold (the reference's rule on the local
    shard), else streams a sigmoid-linked X under Newton and keeps any
    other as 'csr' does (:func:`x_mode`). data_dtype fp8: each block dense
    on the host, stored as e4m3 (a block that stays sparse raises
    ValueError), Y at bf16; a dense rows block takes K1/K2's e4m3 forms.

    seed: a sampled Newton fit's (``cfg.sg_sample_ratio`` < 1) key,
    ``PRNGKey(seed)`` (``ops/random.prng_key``), folded per rank as the
    reference folds it (the module docstring).

    loop: 'host' or 'device' (the device loop on every rank: see the module
    docstring; on CUDA tensors over an NCCL group only, ValueError
    otherwise). Reference: ``pycmf_tpu/parallel/sharded.py:run_sharded``,
    layouts 'rows' and 'cols' (the grid layout:
    ``parallel/grid.py:run_grid``)."""
    check_loop(loop)
    if layout not in ("rows", "cols"):
        raise ValueError(f"layout must be 'rows' or 'cols' (the grid "
                         f"layout is run_grid's), got {layout!r}")
    mesh = make_mesh(n_shards, group, device)
    check_shardable(layout=layout, loop=loop, mesh=mesh)
    if solver == "newton":
        check_device_loop(cfg, mesh.device.type == "cuda", loop)
    ddt = dtype if data_dtype is None else data_dtype
    n, m = X.shape
    d, dev = mesh.world, mesh.device
    local = (-(-n // d) * m if layout == "rows" else n * -(-m // d))
    mode = x_mode(X, local, ddt, cfg, solver, sparse_mode)
    k = U0.shape[1]
    Z = (factor(Z0, dev, dtype) if Z0 is not None and cfg.has_Y
         else torch.zeros((0, k), dtype=dtype, device=dev))
    chunked = sparse_mode == "chunked"
    if layout == "rows":
        ops, U, _ = prepare_rows(X, Y, U0, mesh, dtype, ddt, cfg, mode,
                                 chunked)
        V = factor(V0, dev, dtype)
    else:
        ops, V, _ = prepare_cols(X, Y, V0, mesh, dtype, ddt, cfg, mode,
                                 chunked)
        U = factor(U0, dev, dtype)
    if solver == "newton":
        # the contiguous Xᵀ and Yᵀ the fused sigmoid V and Z updates read
        Xc, Yc = _with_transposes(cfg, ops.X, ops.Y, V, Z)
        ops = ops._replace(X=Xc, Y=Yc)
    if layout == "rows":
        aux = rows_aux_kind(cfg, ops, U, solver)
        fns = dict(mu_iter=mu_rows_iter, newton_iter=newton_rows_iter,
                   loss=loss_rows, aux_loss=_aux_loss_rows)
    else:
        aux = cols_aux_kind(cfg, ops, V, solver)
        fns = dict(mu_iter=mu_cols_iter, newton_iter=newton_cols_iter,
                   loss=loss_cols, aux_loss=_aux_loss_cols)
    block, loss_fn = make_block(cfg, solver, mesh, aux, **fns)
    state, n_iter, losses, iters, times = run_solver_loop(
        block, (ops, None, U, V, Z), hyper, key_stream(solver, cfg, seed, dev),
        max_iter=max_iter,
        tol=tol, eval_every=eval_every,
        verbose=verbose if mesh.rank == 0 else 0, initial_loss_fn=loss_fn,
        loop=loop, key=(layout, solver, cfg, aux, group_key(mesh)),
        agree=partial(all_ranks, mesh))
    _, _, U, V, Z = state
    if layout == "rows":
        U = gather_rows(mesh, U, n)
    else:
        V = gather_rows(mesh, V, m)
    return U, V, Z, n_iter, losses, iters, times
