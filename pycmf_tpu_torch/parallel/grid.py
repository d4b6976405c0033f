"""Grid-sharded CMF: X split over both axes of a (rows × cols) mesh.

Counterpart of ``pycmf_tpu/parallel/grid.py``, one process per cell. Rank
i·c + j of an r×c mesh (``parallel/mesh.py:make_grid_mesh``) holds

    X[i, j] : the (n_loc, m_loc) cell, n_loc = ⌈n/r⌉, m_loc = ⌈m/c⌉, the
              last row and column blocks padded with zeros
    U_i     : row block i of U (replicated over the mesh row)
    V_j     : row block j of V, the shared dimension (replicated over the
              mesh column)
    Y_j     : row block j of Y (its rows index m); Z replicated

and each factor's terms are summed over the other axis only:

    MU      U: Σ_j X[i,j] V_j and VᵀV over COL (with Z's Σ_j Y_jᵀ V_j: one
            all-reduce, all from the same V); V: Σ_i X[i,j]ᵀ U_i and UᵀU
            over ROW, Y_j Z local
    Newton  U's and Z's G, H and φ over COL, V's X-side over ROW (K3/K4's
            ``group`` forms on a dense sigmoid cell, ``newton_update_factor``'s
            ``distributed`` terms otherwise), V's Y-side local.

Padding rows of U and V are forced to exact zero after every update; under
a sigmoid link U's terms take the column mask of the padded m and V's the
mask of the padded n. No rank holds whole rows or columns of X, so K1/K2
never run here; every other kernel of the path does (K3-K6, and on a sparse
cell ``csr_spmm``/``csr_rowdots`` or ``bell_spmm``). A chunked cell
(``sparse_mode='chunked'``, or 'auto' past the threshold for a
sigmoid-linked X under Newton) is streamed by every product, its transpose
through ``ChunkedT``, and a sigmoid-linked sparse Y past the threshold
takes one chunked carrier per row block j. A sampled Newton step draws
the reference's columns: U's and Z's terms and V's Y term alike on the
ranks of mesh column j, V's X term per cell (their keys folded with j and
i as the reference folds them).

The loss sums its parts over the whole mesh in one all-reduce: a term of a
factor replicated along an axis (U_i's along the mesh row, V_j's and Y_j's
along the mesh column) is contributed by the axis's first rank alone, the
others adding exact zeros. The eval losses read what the step computed: the
local pair (X[i,j]ᵀU_new, U_newᵀU_new) of V's update (factored) or V's Σφ
(a sigmoid X), both summed at the eval point only.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import numpy as np
import scipy.sparse as sp
import torch

from ..ops.chunked import chunked_inner, is_chunked
from ..ops.kernels import bell as kbell
from ..ops.kernels import spmm as kspmm
from ..ops.links import LINEAR
from ..ops.losses import (penalty, reconstruction_term, sigmoid_sq_rows,
                          streamed_inner)
from ..ops.matmul import FP8_DTYPES, gram, matmul
from ..ops.sparse import is_sparse, sddmm_dot
from ..solvers.common import (Coupled, Hyper, SolverConfig, check_loop,
                              coupled_mm, run_solver_loop)
from ..solvers.mu import mu_ratio_update
from ..solvers.newton import (Term, _transposed, _with_transposes,
                              check_device_loop, fused_sigmoid_allowed,
                              fused_sigmoid_update, newton_update_factor)
from ..utils.validation import as_coupled
from .mesh import (GridMesh, all_ranks, all_reduce, gather_rows, group_key,
                   make_grid_mesh)
from .sharded import (check_shardable, col_block, cols_aux_kind,
                      factor, key_stream, make_block, rank_keys, row_block,
                      stored_block, x_mode, y_block, y_parts, y_term)


def factor_grid(n_devices: int) -> tuple[int, int]:
    """Near-square (rows, cols) factorization of a device count (the
    reference's: rows the largest divisor ≤ √n)."""
    r = int(np.sqrt(n_devices))
    while n_devices % r:
        r -= 1
    return r, n_devices // r


class GridOperands(NamedTuple):
    """This rank's cell of the grid layout.

    X       : cell (i, j) of X, padded to (n_loc, m_loc), as a Coupled
              (dense, or CSR or BlockEll with the layout of the cell's
              transpose, or chunked; row_sq (n_loc,) the PARTIAL ‖xᵢ‖² over
              the cell's columns, row_sq_t (m_loc,) the partial norms over
              its rows, which the summed φ complete)
    Y       : row block j of Y (dense or chunked, m_loc rows) or None
    nmask   : (n_loc,) 1 on the cell's real rows
    mmask   : (m_loc,) 1 on its real columns
    n_valid : the cell's real rows
    m_valid : its real columns
    n_pad   : padding rows of X over the mesh (r·n_loc − n)
    a_sq    : ‖X‖² over the mesh, summed from the cells' float64 norms
    x_size  : elements of the padded X over the mesh (the eval-loss rule)
    """

    X: Coupled
    Y: Optional[Coupled]
    nmask: torch.Tensor
    mmask: torch.Tensor
    n_valid: int
    m_valid: int
    n_pad: int
    a_sq: torch.Tensor
    x_size: int


def grid_cell(X, n_loc: int, m_loc: int, i: int, j: int):
    """Cell (i, j) of host X (CSR or ndarray): rows i·n_loc .., columns
    j·m_loc .., padded with zeros to (n_loc, m_loc), and its real rows and
    columns (the reference's split, ``_prepare_grid``)."""
    blk, n_valid = row_block(X, n_loc, i)
    cell, m_valid = col_block(blk, m_loc, j)
    return cell, n_valid, m_valid


def _sq_norm64(cell, data_dtype) -> float:
    """‖cell‖² in float64 on the host, of the stored values under fp8."""
    v = sp.csr_matrix(cell) if sp.issparse(cell) else np.asarray(cell)
    if sp.issparse(v):
        v.sum_duplicates()
        v = v.data
    if data_dtype in FP8_DTYPES:
        v = torch.from_numpy(np.ascontiguousarray(v)).to(data_dtype).to(
            torch.float64).numpy()
    v = np.asarray(v, dtype=np.float64).ravel()
    return float(np.dot(v, v))


def prepare_grid(X, Y, U0, V0, gm: GridMesh, dtype, data_dtype,
                 cfg: SolverConfig, mode: str = "dense",
                 chunked: bool = False):
    """(GridOperands, this rank's U block, its V block) on the mesh's
    device.

    mode: how a sparse X's cell is stored: 'dense' (densified on the
    device; under fp8 on the host), 'csr' (CSR with the CSR of its local
    transpose, or under use_pallas BlockEll layouts of both where the
    cell's tiles fill enough) or 'chunked' (the streamed layout of the
    cell, its chunk rows picked on the cell's shape: the same geometry on
    every rank). BlockEll is taken on every cell or on none, as the
    reference's ``_stack_bell_grid`` decides: one all-reduce of a flag,
    with ‖X‖²'s, so every rank launches the same kernels. Y's row block j
    as in the cols layout (``sharded.y_block``; ``chunked``: a
    sigmoid-linked sparse Y's chunked carrier at any size). Reference:
    ``pycmf_tpu/parallel/grid.py:_prepare_grid``."""
    n, m = X.shape
    r, c, dev, up = gm.rows, gm.cols, gm.world.device, cfg.use_pallas
    i, j = gm.i, gm.j
    n_loc, m_loc = -(-n // r), -(-m // c)
    cell, n_valid, m_valid = grid_cell(X, n_loc, m_loc, i, j)
    cell = stored_block(cell, data_dtype)

    def upload(pallas):
        return as_coupled(cell, data_dtype, dev, use_pallas=pallas,
                          sparse_mode=mode if sp.issparse(cell) else "auto")

    Xc = upload(up)
    bell = Xc.A_bell is not None
    sq, n_bell = all_reduce(gm.world, torch.tensor(
        [_sq_norm64(cell, data_dtype), float(bell)], dtype=torch.float64,
        device=dev))[0].tolist()
    if bell and n_bell < r * c:
        Xc = upload(False)   # another cell is too scattered: CSR everywhere
    Yc = y_block(Y, c * m_loc, m_loc, j, data_dtype, dev, cfg, "grid",
                 chunked)
    fdt = Xc.row_sq.dtype
    nmask = torch.zeros(n_loc, dtype=dtype, device=dev)
    nmask[:n_valid] = 1
    mmask = torch.zeros(m_loc, dtype=dtype, device=dev)
    mmask[:m_valid] = 1
    k = U0.shape[1]
    U = torch.zeros((n_loc, k), dtype=dtype, device=dev)
    U[:n_valid] = factor(U0[i * n_loc:i * n_loc + n_valid], dev, dtype)
    V = torch.zeros((m_loc, k), dtype=dtype, device=dev)
    V[:m_valid] = factor(V0[j * m_loc:j * m_loc + m_valid], dev, dtype)
    ops = GridOperands(Xc, Yc, nmask, mmask, n_valid, m_valid,
                       r * n_loc - n, torch.tensor(sq, dtype=fdt, device=dev),
                       r * n_loc * c * m_loc)
    return ops, U, V


def _masks(ops: GridOperands):
    """(nmask, mmask), each None where its axis has no padding here."""
    return (ops.nmask if ops.n_valid < ops.nmask.shape[0] else None,
            ops.mmask if ops.m_valid < ops.mmask.shape[0] else None)


# ---------------------------------------------------------------------------
# iterations
# ---------------------------------------------------------------------------


def mu_grid_iter(cfg: SolverConfig, ops: GridOperands, U, V, Z,
                 hyper: Hyper, gm: GridMesh):
    """One MU iteration, U then Z then V: (U, V, Z, (X[i,j]ᵀU_new,
    U_newᵀU_new) or None), the pair this cell's part of V's sums (the
    factored eval loss sums it). U's X·V, VᵀV and Z's YᵀV are summed over
    COL in one all-reduce; V's XᵀU and UᵀU over ROW in one. Reference:
    ``pycmf_tpu/parallel/grid.py:_mu_grid_iter``."""
    l1, l2, eps, up = hyper.l1, hyper.l2, hyper.eps, cfg.use_pallas
    X, Y = ops.X, ops.Y
    nmask, mmask = _masks(ops)
    upd_z = cfg.has_Y and cfg.update_Z
    local = []
    if cfg.update_U or upd_z:
        local.append(gram(V))
    if cfg.update_U:
        local.append(coupled_mm(X, V, use_pallas=up))
    if upd_z:
        local.append(matmul(Y.A.mT, V))
    sums = all_reduce(gm.col, *local) if local else []
    if cfg.update_U:
        U = mu_ratio_update(U, sums[0], sums[1], l1, l2, eps, up)
        if nmask is not None:
            # the padding rows are 0·0/0 = NaN when l1 = eps = 0: back to
            # exact zeros before they enter V's sums
            U = torch.where(nmask[:, None] > 0.5, U, 0.0)
    if upd_z:
        Z = mu_ratio_update(Z, sums[0], sums[-1], l1, l2, eps, up)
    aux = None
    if cfg.update_V:
        aux = (coupled_mm(X, U, transpose=True, use_pallas=up), gram(U))
        num, S = all_reduce(gm.row, *aux)
        if cfg.has_Y:
            num = num + matmul(Y.A, Z)
            S = S + gram(Z)
        V = mu_ratio_update(V, S, num, l1, l2, eps, up)
        if mmask is not None:
            V = torch.where(mmask[:, None] > 0.5, V, 0.0)
    return U, V, Z, aux


def newton_grid_iter(cfg: SolverConfig, ops: GridOperands, U, V, Z,
                     hyper: Hyper, gm: GridMesh, with_aux=None, keys=None):
    """One Newton iteration, U then Z then V: (U, V, Z, aux), aux this
    cell's (X[i,j]ᵀU_new, U_newᵀU_new) under "factored" (V's update hands
    them over, ``term_cache``), V_j's Σφ summed over ROW under "phi" (the
    same on every rank of the mesh column), else None. Sampled (``keys``:
    the step's (kU, kZ, kV)): U's and Z's terms, distributed over COL,
    fold their keys with the COL index j; kV is folded with j before V's
    update (``pycmf_tpu/parallel/grid.py:479``) and V's X term,
    distributed over ROW, folds its key with the ROW index i. Reference:
    ``pycmf_tpu/parallel/grid.py:_newton_grid_iter``."""
    common = dict(trials=cfg.line_search_trials,
                  hessian_form=cfg.hessian_form,
                  sample_ratio=cfg.sg_sample_ratio, use_pallas=cfg.use_pallas)
    fused_kw = dict(trials=cfg.line_search_trials, use_pallas=cfg.use_pallas)
    X, Y = ops.X, ops.Y
    nmask, mmask = _masks(ops)
    sig_x = cfg.x_link != LINEAR
    kU, kZ, kV = rank_keys("grid", keys, gm.j)
    if cfg.update_U:
        if sig_x and fused_sigmoid_allowed(cfg, X.A, U):
            # K3/K4's partials summed over COL; the padding columns pair
            # with V's zero padding rows (fused_sigmoid_update's group
            # contract), the padding rows zeroed by row_mask
            U = fused_sigmoid_update(U, X.A, V, hyper,
                                     non_negative=cfg.U_non_negative,
                                     row_mask=nmask, group=gm.col, **fused_kw)
        else:
            U = newton_update_factor(
                kU, U, (Term(X.A, V, X.row_sq, layout=X.A_bell),),
                (cfg.x_link,), hyper, non_negative=cfg.U_non_negative,
                distributed=(True,), masks=(mmask if sig_x else None,),
                group=gm.col, **common)
            if nmask is not None:
                U = U * nmask[:, None]   # the padding rows back to zero
    if cfg.has_Y and cfg.update_Z:
        if cfg.y_link != LINEAR and fused_sigmoid_allowed(cfg, Y.A, Z):
            Z = fused_sigmoid_update(Z, _transposed(Y), V, hyper,
                                     non_negative=cfg.Z_non_negative,
                                     group=gm.col, **fused_kw)
        else:
            Z = newton_update_factor(
                kZ, Z, (Term(_transposed(Y), V),), (cfg.y_link,), hyper,
                non_negative=cfg.Z_non_negative, distributed=(True,),
                masks=(mmask if cfg.y_link != LINEAR else None,),
                group=gm.col, **common)
    aux = None
    if cfg.update_V:
        phi = with_aux == "phi"
        yterm = Term(Y.A, Z, Y.row_sq) if cfg.has_Y else None
        Xt = _transposed(X)
        if sig_x and fused_sigmoid_allowed(cfg, Xt, V):
            # K3/K4's partials over the cell's transpose summed over ROW
            # (U's padding rows are zero); Y_j's term local
            out = fused_sigmoid_update(
                V, Xt, U, hyper, non_negative=cfg.V_non_negative,
                yterm=yterm, y_link=cfg.y_link, row_mask=mmask,
                group=gm.row, return_phi=phi, **fused_kw)
            if phi:
                # K4's summed φ counts σ(0) = ½ on every padding row of X:
                # 0.125 per padding row and real row of V
                V, phi_rows = out
                aux = phi_rows.sum() - 0.125 * ops.n_pad * ops.m_valid
            else:
                V = out
        else:
            terms = (Term(Xt, U, X.row_sq_t, layout=X.At_bell),)
            links, dist = (cfg.x_link,), (True,)
            masks = (nmask if sig_x else None,)
            if cfg.has_Y:
                terms, links = terms + (yterm,), links + (cfg.y_link,)
                dist, masks = dist + (False,), masks + (None,)
            out = newton_update_factor(
                kV, V, terms, links, hyper,
                non_negative=cfg.V_non_negative, distributed=dist,
                masks=masks, group=gm.row, return_phi=phi,
                term_cache=0 if with_aux == "factored" else None, **common)
            if phi:
                V, phi_rows = out
                if mmask is not None:
                    phi_rows = phi_rows * mmask
                aux = phi_rows.sum()
            elif with_aux == "factored":
                V, aux = out
            else:
                V = out
            if mmask is not None:
                V = V * mmask[:, None]   # the padding rows back to zero
    return U, V, Z, aux


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


def _mesh_sum(gm: GridMesh, per_cell, per_row, per_col):
    """Sums over the whole mesh, in one all-reduce, of: ``per_cell`` (a
    part from every cell), ``per_row`` (parts of a factor replicated along
    the mesh row, U_i's: counted by j = 0) and ``per_col`` (parts of one
    replicated along the mesh column, V_j's and Y_j's: counted by i = 0).
    The other ranks add exact zeros. Returns the three lists summed."""
    def keep(parts, counted):
        return [p if counted else torch.zeros_like(p) for p in parts]

    parts = (list(per_cell) + keep(per_row, gm.j == 0)
             + keep(per_col, gm.i == 0))
    dt = per_row[0].dtype    # the factors' (U's penalty is always a part)
    sums = all_reduce(gm.world, *(p.to(dt) for p in parts))
    a, b = len(per_cell), len(per_cell) + len(per_row)
    return sums[:a], sums[a:b], sums[b:]


def _col_parts(cfg: SolverConfig, ops: GridOperands, V, Z, hyper: Hyper,
               need_gv: bool) -> list:
    """V_j's and Y_j's loss parts: VᵀV (when ``need_gv``), R(V), Y's."""
    parts = [gram(V)] if need_gv else []
    parts.append(penalty(V, hyper.alpha, hyper.l1_ratio))
    if cfg.has_Y:
        parts += y_parts(cfg, ops.Y, V, Z, _masks(ops)[1])
    return parts


def _finish(cfg: SolverConfig, col_sums, need_gv: bool, Z, hyper: Hyper):
    """(ΣVᵀV or None, R(V) + Y's term + R(Z)) from the summed _col_parts."""
    col_sums = list(col_sums)
    gV = col_sums.pop(0) if need_gv else None
    rest = col_sums.pop(0)
    if cfg.has_Y:
        rest = rest + y_term(cfg, col_sums, gV, Z, hyper)
    return gV, rest


def loss_grid(cfg: SolverConfig, ops: GridOperands, U, V, Z, hyper: Hyper,
              gm: GridMesh):
    """L(U, V, Z) over the mesh in one all-reduce: a linear X term by the
    factored identity, its ⟨X[i,j], U_i V_jᵀ⟩ summed over both axes with
    ‖X‖² and UᵀU, VᵀV; a sigmoid one as the residual masked on both
    padding axes (a chunked cell streams both). Reference:
    ``pycmf_tpu/parallel/grid.py:_loss_grid``."""
    X, up = ops.X, cfg.use_pallas
    nmask, mmask = _masks(ops)
    linear = cfg.x_link == LINEAR
    if linear:
        if is_chunked(X.A):
            cell = chunked_inner(X.A, U, V)
        elif is_sparse(X.A):
            if up and X.At_bell is not None:
                cell = kbell.bell_inner(X.At_bell, U, V)
            elif up:
                cell = torch.sum(kspmm.csr_rowdots(X.A, U, V))
            else:
                cell = sddmm_dot(X.A, U, V)
        else:
            cell = streamed_inner(X.A, U, V)
    elif is_chunked(X.A):
        cell = reconstruction_term(X.A, U, V, cfg.x_link, row_mask=nmask,
                                   col_mask=mmask)
    else:
        rows = sigmoid_sq_rows(X.A, U, V, mmask)
        if nmask is not None:
            rows = rows * nmask
        cell = torch.sum(rows)
    per_row = ([gram(U)] if linear else []) + [
        penalty(U, hyper.alpha, hyper.l1_ratio)]
    need_gv = linear or (cfg.has_Y and cfg.y_link == LINEAR)
    (cell,), row_sums, col_sums = _mesh_sum(
        gm, [cell], per_row, _col_parts(cfg, ops, V, Z, hyper, need_gv))
    gV, rest = _finish(cfg, col_sums, need_gv, Z, hyper)
    if linear:
        gU, pen_u = row_sums
        x_term = 0.5 * (ops.a_sq - 2.0 * cell + torch.sum(gU * gV))
    else:
        (pen_u,), x_term = row_sums, cell
    return x_term + pen_u + rest


def _aux_loss_grid(cfg: SolverConfig, gm: GridMesh, kind: str):
    """The eval loss from what the last step computed, in one all-reduce:
    "factored" (each cell's (X[i,j]ᵀU_new, U_newᵀU_new): ⟨·, V_j⟩ summed
    over the mesh, UᵀU over the mesh rows, then the factored identity with
    ‖X‖²) or "phi" (V_j's Σφ, X and Y terms and R(V) in it, summed over the
    mesh columns); U's penalty over the mesh rows, Z's once. Reference:
    ``pycmf_tpu/parallel/grid.py:_aux_loss_grid``, ``_aux_loss_grid_phi``."""

    def loss_fn(state, aux, hyper: Hyper):
        ops, U, V, Z = state
        pen_u = penalty(U, hyper.alpha, hyper.l1_ratio)
        if kind == "phi":
            _, (pen_u,), (phi,) = _mesh_sum(gm, [], [pen_u], [aux])
            loss = phi + pen_u
            if cfg.has_Y:
                loss = loss + penalty(Z, hyper.alpha, hyper.l1_ratio)
            return loss
        num, S = aux
        (inner,), (S, pen_u), col_sums = _mesh_sum(
            gm, [torch.sum(num * V)], [S, pen_u],
            _col_parts(cfg, ops, V, Z, hyper, True))
        gV, rest = _finish(cfg, col_sums, True, Z, hyper)
        x_term = 0.5 * (ops.a_sq - 2.0 * inner + torch.sum(S * gV))
        return x_term + pen_u + rest

    return loss_fn


# ---------------------------------------------------------------------------
# the fit
# ---------------------------------------------------------------------------


def run_grid(solver: str, X, Y, U0, V0, Z0, cfg: SolverConfig,
             hyper: Hyper, *, grid: tuple, group=None, dtype=torch.float32,
             data_dtype=None, device="cuda", max_iter: int = 200,
             tol: float = 1e-4, eval_every: int = 10, verbose: int = 0,
             loop: str = "host", sparse_mode: str = "auto", seed: int = 0):
    """The grid fit on this process's rank of ``group`` (default: the
    default process group), whose size must be rows·cols of ``grid``. X, Y:
    the whole host matrices, on every rank; U0, V0, Z0: host arrays, the
    same on every rank. Returns (U, V, Z, n_iter, loss_history,
    loss_iters, step_times), U gathered over the mesh column and V over the
    mesh row: the same on every rank.

    sparse_mode (a sparse X): 'dense' densifies this rank's cell; 'csr'
    keeps it CSR (and the CSR of its local transpose), or BlockEll on
    every cell under use_pallas where every cell's tiles fill enough;
    'chunked' streams it; 'auto' densifies it when the cell's dense copy
    (⌈n/r⌉·⌈m/c⌉ elements at the storage dtype) fits the densify
    threshold, else streams a sigmoid-linked X under Newton and keeps any
    other as 'csr' does (the reference streams a scattered linear cell
    too: ROADMAP C4, ``sharded.x_mode``). data_dtype fp8: each cell dense
    on the host, stored as e4m3, Y at bf16.

    seed: a sampled Newton fit's key, ``PRNGKey(seed)``, folded per cell
    as the reference folds it (:func:`newton_grid_iter`).

    loop: 'host' or 'device', as in ``sharded.run_sharded`` (the device
    loop's cache key names the world and both axis groups; the ranks agree
    on each fit's branch over the world). Reference:
    ``pycmf_tpu/parallel/grid.py:run_grid``."""
    check_loop(loop)
    r, c = grid
    gm = make_grid_mesh(r, c, group, device)
    check_shardable(layout="grid", loop=loop, mesh=gm.world)
    if solver == "newton":
        check_device_loop(cfg, gm.world.device.type == "cuda",
                          loop)
    ddt = dtype if data_dtype is None else data_dtype
    n, m = X.shape
    mode = x_mode(X, -(-n // r) * -(-m // c), ddt, cfg, solver, sparse_mode,
                  "cell")
    dev = gm.world.device
    ops, U, V = prepare_grid(X, Y, U0, V0, gm, dtype, ddt, cfg, mode,
                             sparse_mode == "chunked")
    k = U0.shape[1]
    Z = (factor(Z0, dev, dtype) if Z0 is not None and cfg.has_Y
         else torch.zeros((0, k), dtype=dtype, device=dev))
    if solver == "newton":
        # the contiguous Xᵀ and Yᵀ cells the fused sigmoid V and Z updates
        # read
        Xc, Yc = _with_transposes(cfg, ops.X, ops.Y, V, Z)
        ops = ops._replace(X=Xc, Y=Yc)
    # the reference's choice of eval loss (_grid_aux_kind): the cols rule,
    # on the size of the whole padded X
    aux = cols_aux_kind(cfg, ops, V, solver)
    block, loss_fn = make_block(
        cfg, solver, gm, aux, mu_iter=mu_grid_iter,
        newton_iter=newton_grid_iter, loss=loss_grid,
        aux_loss=_aux_loss_grid)
    state, n_iter, losses, iters, times = run_solver_loop(
        block, (ops, None, U, V, Z), hyper,
        key_stream(solver, cfg, seed, dev), max_iter=max_iter,
        tol=tol, eval_every=eval_every,
        verbose=verbose if gm.world.rank == 0 else 0, initial_loss_fn=loss_fn,
        loop=loop, key=("grid", solver, cfg, aux, group_key(gm.world),
                        group_key(gm.row), group_key(gm.col)),
        agree=partial(all_ranks, gm.world))
    _, _, U, V, Z = state
    return (gather_rows(gm.row, U, n), gather_rows(gm.col, V, m), Z, n_iter,
            losses, iters, times)
