"""Row-sharded CMF: X's rows (and U) split over the ranks of a process group.

Counterpart of the ``"rows"`` layout of ``pycmf_tpu/parallel/sharded.py``.
Rank r of d holds rows r·n_loc .. (r+1)·n_loc − 1 of X and U, n_loc =
⌈n / d⌉, the last block padded with zero rows; V, Z and Y are replicated.
Each iteration sums V's shared X-side terms over the ranks (BASELINE.json
config #5: row-sharded X with an all-reduce of the shared-V terms):

- MU: XᵀU_new and U_newᵀU_new, from K1 on a dense shard (rows past the
  shard's real ones come out zero), else from the CSR or BlockEll products;
- Newton on a linear X with the fused U pass (K2): the same pair, handed
  to V's update as already-summed terms;
- Newton otherwise: V's per-row G and H (K3's partials on a dense sigmoid
  X) and every line-search φ (K4's) of V's X term.

U's update is row-local and its padding rows stay exactly zero, so they add
nothing to any sum. The loss sums the X side over the ranks; with the
zero-extra-pass eval losses (the summed V terms, or V's Σφ) a block's loss
costs one scalar all-reduce. At the end every rank gathers U, so every rank
returns the same result.

Every rank is given the whole host X and Y, as the reference's single
controller holds them, and uploads only its own row block of X (CSR or
BlockEll by the single-device rule for that block, or dense). Not ported
yet: the ``cols`` and ``grid`` layouts (ROADMAP A10b) and, across shards,
the chunked layout, fp8 data, sampled Newton and the device loop (A10c);
each raises NotImplementedError naming its item.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import scipy.sparse as sp
import torch

from ..ops.links import LINEAR
from ..ops.losses import (penalty, reconstruction_term, sigmoid_sq_rows,
                          streamed_inner)
from ..ops.kernels import bell as kbell
from ..ops.kernels import mu_fused, newton_fused
from ..ops.kernels import spmm as kspmm
from ..ops.matmul import FP8_DTYPES, gram
from ..ops.sparse import is_sparse, sddmm_dot
from ..solvers.common import (Coupled, Hyper, SolverConfig, check_loop,
                              coupled_mm, run_solver_loop)
from ..solvers.mu import mu_ratio_update
from ..solvers.newton import (Term, _transposed, _with_transposes,
                              fused_newton_u_allowed, fused_sigmoid_allowed,
                              fused_sigmoid_update, newton_update_factor,
                              shared_gauss_hinv)
from ..utils.validation import DENSIFY_THRESHOLD, as_coupled
from .mesh import Mesh, all_reduce, gather_rows, make_mesh


class RowOperands(NamedTuple):
    """This rank's operands of the rows layout.

    X       : its row block of X, padded to n_loc rows, as a Coupled (dense,
              CSR or BlockEll, with the layout of the block's transpose and
              the block's norms: row_sq (n_loc,), row_sq_t (m,))
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


def prepare_rows(X, Y, U0, mesh: Mesh, dtype, data_dtype, cfg: SolverConfig,
                 x_mode: str = "dense"):
    """(RowOperands, this rank's U block, n) on mesh.device.

    x_mode: how a sparse X's block is stored: 'dense' (densified on the
    device) or 'csr' (CSR, or BlockEll under use_pallas where the block's
    128×128 tiles fill enough: as_coupled's single-device rule). A sparse
    Y stays CSR under a linear link (as the reference's rows layout keeps
    it) and is densified under a sigmoid one up to the densify threshold.
    Reference: ``pycmf_tpu/parallel/sharded.py:_prepare_rows``."""
    n, m = X.shape
    d, dev, up = mesh.world, mesh.device, cfg.use_pallas
    n_loc = -(-n // d)
    blk, n_valid = row_block(X, n_loc, mesh.rank)
    Xc = as_coupled(blk, data_dtype, dev, use_pallas=up,
                    sparse_mode=x_mode if sp.issparse(blk) else "auto")
    if Y is None:
        Yc = None
    elif sp.issparse(Y) and cfg.y_link == LINEAR:
        Yc = as_coupled(Y, data_dtype, dev, use_pallas=up, sparse_mode="csr")
    else:
        if sp.issparse(Y) and (Y.shape[0] * Y.shape[1]
                               * data_dtype.itemsize > DENSIFY_THRESHOLD):
            raise NotImplementedError(
                "a sigmoid-linked sparse Y past the densify threshold under "
                "n_shards takes the replicated chunked layout, which is not "
                "ported yet (ROADMAP A10c)")
        Yc = as_coupled(Y, data_dtype, dev, sparse_mode="dense")
    # ‖X‖² and the column norms over all ranks: one all-reduce of the
    # blocks' own (host float64, stored at the factor precision)
    a_sq = Xc.A.sq_norm if is_sparse(Xc.A) else Xc.a_sq
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
    summed over the ranks in one all-reduce. Reference:
    ``pycmf_tpu/parallel/sharded.py:_loss_rows``."""
    X, up = ops.X, cfg.use_pallas
    pen_u = penalty(U, hyper.alpha, hyper.l1_ratio)
    if cfg.x_link == LINEAR:
        if is_sparse(X.A):
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
    return is_sparse(A) or A.dtype == U.dtype or ops.x_size >= (1 << 22)


def rows_aux_kind(cfg: SolverConfig, ops: RowOperands, U, solver: str):
    """None | "factored" | "phi" (reference: ``_rows_aux_kind``): Newton's
    factored loss needs the fused U pass, its φ loss (a sigmoid X) the V
    update, a line search and the full batch."""
    if solver == "mu" or cfg.x_link == LINEAR:
        ok = _rows_aux_ok(cfg, ops, U) and (
            solver == "mu"
            or fused_newton_u_allowed(cfg, ops.X.A, ops.X.row_sq, U))
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
    """One MU iteration: (U, V, Z, (ΣXᵀU_new, ΣU_newᵀU_new) or None).
    Reference: ``pycmf_tpu/parallel/sharded.py:_mu_rows_iter``."""
    l1, l2, eps, up = hyper.l1, hyper.l2, hyper.eps, cfg.use_pallas
    X = ops.X
    fused = (up and cfg.update_U and cfg.update_V and not is_sparse(X.A)
             and U.dtype != torch.bfloat16)
    num_vx = gram_u = None
    VtV = gram(V) if (cfg.update_U or (cfg.has_Y and cfg.update_Z)) else None
    if cfg.update_U:
        # the padding rows come out exactly zero: their ratio is 0·0/0 = NaN
        # when l1 = eps = 0, and a NaN row would poison every sum
        if fused:
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
                     hyper: Hyper, mesh: Mesh, with_aux=None):
    """One full-batch Newton iteration, U then Z then V: (U, V, Z, aux),
    aux the summed (XᵀU_new, U_newᵀU_new) under with_aux="factored", V's
    Σφ under "phi", else None. Reference:
    ``pycmf_tpu/parallel/sharded.py:_newton_rows_iter``."""
    common = dict(trials=cfg.line_search_trials,
                  hessian_form=cfg.hessian_form, use_pallas=cfg.use_pallas)
    fused_kw = dict(trials=cfg.line_search_trials, use_pallas=cfg.use_pallas)
    X, Y = ops.X, ops.Y
    mask = mask_u = ops.mask if _padded(ops) else None
    numv_x = gram_u = None
    if cfg.update_U:
        # row-local: no collective; the padding rows stay exactly zero
        if fused_newton_u_allowed(cfg, X.A, X.row_sq, U):
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
            U = newton_update_factor(
                None, U, (Term(X.A, V, X.row_sq, layout=X.A_bell),),
                (cfg.x_link,), hyper, non_negative=cfg.U_non_negative,
                **common)
        if mask_u is not None:
            U = U * mask_u[:, None]
    if cfg.has_Y and cfg.update_Z:
        # Y is replicated: every rank makes the same update
        if cfg.y_link != LINEAR and fused_sigmoid_allowed(cfg, Y.A, Z):
            Z = fused_sigmoid_update(Z, _transposed(Y), V, hyper,
                                     non_negative=cfg.Z_non_negative,
                                     **fused_kw)
        else:
            Z = newton_update_factor(
                None, Z, (Term(_transposed(Y), V, Y.row_sq_t,
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
                None, V, terms, links, hyper,
                non_negative=cfg.V_non_negative, distributed=dist,
                masks=masks, group=mesh, return_phi=phi, **common)
            if phi:
                V, phi_rows = out
                aux = phi_rows.sum()
            else:
                V = out
    return U, V, Z, aux


# ---------------------------------------------------------------------------
# the fit
# ---------------------------------------------------------------------------


def make_rows_block(cfg: SolverConfig, solver: str, mesh: Mesh, aux):
    """(block, initial loss) for run_solver_loop, whose state is (ops, U,
    V, Z): a block runs n_steps iterations, then the eval loss (the aux
    loss of ``aux``, else :func:`loss_rows`). Reference:
    ``pycmf_tpu/parallel/sharded.py:_make_rows_block``."""
    aux_loss = _aux_loss_rows(cfg, mesh, aux) if aux is not None else None

    def loss_fn(state, hyper: Hyper):
        ops, U, V, Z = state
        return loss_rows(cfg, ops, U, V, Z, hyper, mesh)

    def block(state, hyper: Hyper, rng, n_steps: int):
        ops, U, V, Z = state
        a = None
        for _ in range(n_steps):
            if solver == "mu":
                U, V, Z, a = mu_rows_iter(cfg, ops, U, V, Z, hyper, mesh)
            else:
                U, V, Z, a = newton_rows_iter(cfg, ops, U, V, Z, hyper, mesh,
                                              with_aux=aux)
        state = (ops, U, V, Z)
        if aux is None:
            return state, loss_fn(state, hyper), rng
        return state, aux_loss(state, a, hyper), rng

    return block, loss_fn


def check_shardable(*, layout: str = "rows", loop: str = "host",
                    sg_sample_ratio: float = 1.0, sparse_mode: str = "auto",
                    data_dtype=None) -> None:
    """Raise NotImplementedError, naming its ROADMAP item, for a sharded
    request this port does not run yet."""
    if layout in ("cols", "grid"):
        raise NotImplementedError(
            f"shard_layout={layout!r} is not ported yet (ROADMAP A10b); "
            "use shard_layout='rows'")
    if layout != "rows":
        raise ValueError(
            f"layout must be 'rows', 'cols' or 'grid', got {layout!r}")
    todo = []
    if loop == "device":
        todo.append("loop='device' (the device loop under shards: NCCL "
                    "collectives inside the fit's CUDA graphs)")
    if sg_sample_ratio < 1.0:
        todo.append("sg_sample_ratio < 1 (the per-shard draws)")
    if sparse_mode == "chunked":
        todo.append("sparse_mode='chunked' (per-shard chunked layouts)")
    if data_dtype in FP8_DTYPES:
        todo.append("data_dtype='fp8' (per-shard fp8 storage)")
    if todo:
        raise NotImplementedError(
            "not ported yet under n_shards > 1 (ROADMAP A10c): "
            + "; ".join(todo))


def run_sharded(solver: str, X, Y, U0, V0, Z0, cfg: SolverConfig,
                hyper: Hyper, *, n_shards: Optional[int] = None,
                group=None, layout: str = "rows", dtype=torch.float32,
                data_dtype=None, device="cuda", max_iter: int = 200,
                tol: float = 1e-4, eval_every: int = 10, verbose: int = 0,
                loop: str = "host", sparse_mode: str = "auto"):
    """The sharded fit, on this process's rank of ``group`` (default: the
    default process group), whose size must be ``n_shards`` when that is
    given. X, Y: the whole host matrices (ndarray or scipy.sparse), on every
    rank; U0, V0, Z0: host arrays (Z0 may be None), the same on every rank.
    Returns (U, V, Z, n_iter, loss_history, loss_iters, step_times), U
    gathered over the ranks: the same on every rank.

    sparse_mode (a sparse X): 'dense' densifies this rank's block; 'auto'
    densifies it when the block's dense copy fits the densify threshold
    (the reference's rule on the local shard), else keeps it as 'csr'
    does: CSR, or BlockEll under use_pallas where its tiles fill enough (a
    sigmoid-linked X would take a chunked block there: ROADMAP A10c).
    Reference: ``pycmf_tpu/parallel/sharded.py:run_sharded``, layout
    'rows', loop 'host'."""
    check_loop(loop)
    check_shardable(layout=layout, loop=loop,
                    sg_sample_ratio=cfg.sg_sample_ratio,
                    sparse_mode=sparse_mode, data_dtype=data_dtype)
    mesh = make_mesh(n_shards, group, device)
    ddt = dtype if data_dtype is None else data_dtype
    x_mode = "dense"
    if sp.issparse(X) and sparse_mode != "dense":
        n, m = X.shape
        local = -(-n // mesh.world) * m * ddt.itemsize
        x_mode = ("csr" if sparse_mode == "csr" or local > DENSIFY_THRESHOLD
                  else "dense")
        if x_mode == "csr" and cfg.x_link != LINEAR and solver == "newton":
            raise NotImplementedError(
                "a sigmoid-linked sparse X whose shard is past the densify "
                "threshold takes a chunked layout per shard, which is not "
                "ported yet (ROADMAP A10c); use sparse_mode='dense' or more "
                "shards")
    ops, U, n = prepare_rows(X, Y, U0, mesh, dtype, ddt, cfg, x_mode)
    k = U.shape[1]
    V = torch.as_tensor(np.asarray(V0, dtype=np.float64)).to(mesh.device,
                                                            dtype)
    Z = (torch.as_tensor(np.asarray(Z0, dtype=np.float64)).to(mesh.device,
                                                              dtype)
         if Z0 is not None and cfg.has_Y
         else torch.zeros((0, k), dtype=dtype, device=mesh.device))
    if solver == "newton":
        # the contiguous Xᵀ and Yᵀ the fused sigmoid V and Z updates read
        Xc, Yc = _with_transposes(cfg, ops.X, ops.Y, V, Z)
        ops = ops._replace(X=Xc, Y=Yc)
    aux = rows_aux_kind(cfg, ops, U, solver)
    block, loss_fn = make_rows_block(cfg, solver, mesh, aux)
    state, n_iter, losses, iters, times = run_solver_loop(
        block, (ops, U, V, Z), hyper, None, max_iter=max_iter, tol=tol,
        eval_every=eval_every, verbose=verbose if mesh.rank == 0 else 0,
        initial_loss_fn=loss_fn)
    _, U, V, Z = state
    return gather_rows(mesh, U, n), V, Z, n_iter, losses, iters, times
