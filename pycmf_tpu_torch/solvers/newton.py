"""Batched row-wise Newton solver.

Counterpart of the single-device subset of ``pycmf_tpu/solvers/newton.py``.
Per row of a factor M against its coupled terms (D, B, link),
D ≈ f(M Bᵀ):

    g = Σ Bᵀ[(f(B mᵢ) − dᵢ)⊙f′] + l1·sign(mᵢ) + l2·mᵢ
    H = Σ Bᵀ diag(w) B + (l2 + hessian_pertubation)·I
        w = f′²                  (hessian_form='gauss')
        w = f′² + (f(B mᵢ) − dᵢ)⊙f″  (hessian_form='full')
    mᵢ ← proj( mᵢ − step · H⁻¹ g ), step from the backtracking line search

Sampling: with ``sg_sample_ratio`` < 1 each term's g, H and line-search
objective sum over a uniform draw of s = ⌈ratio·q⌉ of its q columns, made
anew per term and step, without rescaling (the reference's rule). Dense
data gathers the drawn columns; CSR and BlockEll data keep them all and
take the draw as a 0/1 column mask folded into B, which gives the same
sums. The draws are the reference's (``ops/random.py``): step i of a fit
splits its iteration's key into (kU, kZ, kV), term t of a factor draws
``choice(fold_in(k, t), q, s, replace=False)`` (a distributed term's key
folded again with its rank on the mesh axis), through
:func:`draw_columns`: Threefry-2x32 on the factors' device, no host sync
and a static size, so a CUDA graph of a block replays each block's own
draws.

A linear term's Hessian BᵀB is shared by every row (one k×k Cholesky); a
sigmoid term gives each row its own k×k system. U sees one term (X, V); Z
sees (Yᵀ, V); the shared V sees (Xᵀ, U) and (Y, Z). With ``use_pallas``:

- a linear X link updates U with one call of the fused U pass
  (``ops/kernels/newton_fused.py``), whose XᵀU_new and U_newᵀU_new feed
  V's X term, so V never reads X again;
- a sigmoid-linked factor takes :func:`fused_sigmoid_update`: G and the
  per-row Hessians in one pass over the data, the batched SPD solve, and
  every line-search candidate's objective in one more pass
  (``ops/kernels/sigmoid_newton.py``, ``ops/kernels/batched_solve.py``);
- every per-row Gauss-Newton system goes through the batched SPD solve
  kernel, and every per-row system of the full form (which may be
  indefinite) through its LU route (``batched_lu_solve``, as the
  reference's ``jnp.linalg.solve``), at any k: no per-row solve leaves
  the kernels, so the device loop captures every such step;
- a linear term over sparse data forms D B through its BlockEll layout or
  the CSR kernel (``solvers/common.layout_spmm``); the fused U pass and the
  fused sigmoid passes take dense data, the full batch and the
  Gauss-Newton form only.

A chunked X (``ops/chunked.py``) streams: a linear U leg in one pass that
also returns V's X-side terms (K2 per chunk under ``use_pallas``), a
sigmoid U leg row-local per chunk, and V's (and a chunked sigmoid Y's Z)
terms accumulated over the chunks (``solvers/newton_chunked.py``, the
``ChunkedT`` marker). A sampled chunked term takes its draw as a mask.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from ..ops.chunked import (ChunkedT, chunked_masked_col_sq,
                           chunked_masked_row_sq,
                           chunked_newton_linear_u_pass, is_chunked)
from ..ops.kernels import batched_solve, newton_fused, sigmoid_newton
from ..ops.linesearch import backtracking_select, backtracking_select_table
from ..ops.links import LINEAR
from ..ops.losses import (penalty, reconstruction_term, sigmoid_sq_rows,
                          total_loss)
from ..ops.matmul import contiguous_t, gram, matmul, select_columns
from ..ops.random import KeyStream, choice_without_replacement, fold_in
from ..ops.sparse import is_sparse, masked_row_sq_norms, row_sq_norms
from ..parallel.mesh import all_reduce
from .common import (Coupled, Hyper, SolverConfig, check_loop, layout_spmm,
                     run_solver_loop)
from .newton_chunked import (ChunkedSigRowCtx, ChunkedTSigCtx,
                             chunked_sigmoid_colwise_phi,
                             chunked_sigmoid_colwise_terms,
                             chunked_sigmoid_row_update,
                             chunked_sigmoid_rowwise_phi,
                             chunked_sigmoid_rowwise_terms)


class Term(NamedTuple):
    """One coupled data term of a factor update: D ≈ f(M Bᵀ) row-wise.

    D      : dense; a CsrMatrix (linear terms only); a ChunkedCoo (rows
             of the factor are X's rows), or ChunkedT of one (they are
             X's columns)
    row_sq : optional precomputed per-row ‖dᵢ‖² (fit-time constant)
    DB     : optional precomputed D @ B (p, k), e.g. the XᵀU_new the fused
             U pass returns, which saves V's update its own pass over X
    BtB    : optional precomputed gram(B) (k, k), paired with DB
    layout : optional BlockEll layout of a sparse D (ops/kernels/bell.py)
    (row_sq, DB, BtB and layout serve linear terms only.)
    """

    D: Any
    B: torch.Tensor
    row_sq: Optional[torch.Tensor] = None
    DB: Optional[torch.Tensor] = None
    BtB: Optional[torch.Tensor] = None
    layout: Any = None


class _LinearCtx(NamedTuple):
    """Candidate-independent quantities of a linear term's line search:
    φᵢ(m) = ½(‖dᵢ‖² − 2⟨(DB)ᵢ, m⟩ + mᵀ(BᵀB)m)."""

    DB: torch.Tensor
    BtB: torch.Tensor
    row_sq: torch.Tensor


class _SigmoidCtx(NamedTuple):
    """A dense sigmoid term's line search: φᵢ(m) = ½‖dᵢ − σ(B m)‖², the
    columns weighted by ``mask`` when there is one."""

    D: torch.Tensor
    B: torch.Tensor
    mask: Optional[torch.Tensor] = None


def sample_size(q: int, ratio: float) -> int:
    """Columns a term of q columns draws at ``sg_sample_ratio`` ratio:
    ⌈ratio·q⌉, at least 1, a static size (the reference's formula)."""
    return max(1, int(-(-ratio * q // 1)))


def draw_columns(key: torch.Tensor, q: int, s: int) -> torch.Tensor:
    """The s indices of range(q) the reference draws under ``key`` (a (2,)
    int64 key on the factors' device), ``jax.random.choice(key, q, (s,),
    replace=False)``, in ascending order: only the set enters the sums,
    and ascending columns gather with better locality. The reference
    gathers in the draw's order, so a gathered sum adds the same terms in
    another order (equal at float64 to rounding). No host sync, a static
    shape."""
    return torch.sort(choice_without_replacement(key, q, s)).values


def _sample_columns(key, D, B, ratio: float, mask=None):
    """(D, B, mask) restricted to a draw of their q columns (dense D:
    ``index_select``, on the byte view of fp8 data; the optional (q,)
    column mask, a shard's padding, gathered with them); unchanged when
    the draw would take every column.
    Reference: ``pycmf_tpu/solvers/newton.py:_sample_columns``."""
    q = B.shape[0]
    s = sample_size(q, ratio)
    if s >= q:
        return D, B, mask
    idx = draw_columns(key, q, s)
    return (select_columns(D, idx), B.index_select(0, idx),
            None if mask is None else mask.index_select(0, idx))


def sample_mask(key, q: int, ratio: float, dtype):
    """The same draw as :func:`_sample_columns` as a (q,) 0/1 mask, or
    None when it would take every column. Sums over the drawn columns
    equal the mask-weighted sums over all of them, which is how CSR and
    BlockEll terms, whose columns are not gathered on the device, sample.
    Reference: ``pycmf_tpu/solvers/newton.py:sample_mask``."""
    s = sample_size(q, ratio)
    if s >= q:
        return None
    # a mask needs the set only: the draw's own order, no ascending sort
    idx = choice_without_replacement(key, q, s)
    return torch.zeros(q, dtype=dtype, device=idx.device).index_fill_(
        0, idx, 1)


def _sample_term(key, term: Term, ratio: float, dtype, mask=None):
    """(term, mask) of one sampled term (the reference's per-term draw,
    ``pycmf_tpu/solvers/newton.py:360-381``). Dense D takes the gathered
    columns, and the term's own column mask (a shard's padding) the same
    gather; sparse and chunked D keep their layout and return the draw as
    a mask, multiplied into the term's own. The caches (row_sq, DB, BtB)
    describe the full term and go (for such D only when a mask is drawn,
    as in the reference)."""
    D, B = term.D, term.B
    if is_sparse(D) or is_chunked(D) or isinstance(D, ChunkedT):
        drawn = sample_mask(key, B.shape[0], ratio, dtype)
        if drawn is None:
            return term, mask
        return (Term(D, B, layout=term.layout),
                drawn if mask is None else mask * drawn)
    D, B, mask = _sample_columns(key, D, B, ratio, mask)
    return Term(D, B), mask


def term_key(key: torch.Tensor, t: int, axis_rank=None) -> torch.Tensor:
    """The key term t of a factor update draws under: fold_in(key, t), and
    for a distributed term fold_in of that with the rank's index on the
    mesh axis its columns are sharded over (``pycmf_tpu/solvers/
    newton.py:363-369``)."""
    key = fold_in(key, t)
    return key if axis_rank is None else fold_in(key, axis_rank)


def _accumulate_term(M, term: Term, link: str, use_pallas: bool = False,
                     hessian_form: str = "gauss", mask=None):
    """(G_term (p, k), H_shared (k, k) | None, H_rows (p, k, k) | None,
    line-search ctx) of one term; ``mask``: an optional (q,) 0/1 column
    mask (a sampled sparse term). Reference:
    ``pycmf_tpu/solvers/newton.py:_accumulate_term``."""
    D, B, row_sq, db, btb, layout = term
    if link != LINEAR:
        if isinstance(D, ChunkedT):
            # V's X term on a chunked X (or Z's on a chunked Y): G and H
            # accumulate over the forward chunks, φ streams them
            G, H_rows = chunked_sigmoid_colwise_terms(D.ck, M, B,
                                                      hessian_form, mask)
            return G, None, H_rows, ChunkedTSigCtx(D.ck, B, mask)
        if is_chunked(D):
            # M's rows are D's rows (V against a chunked sigmoid Y)
            G, H_rows = chunked_sigmoid_rowwise_terms(D, M, B, hessian_form,
                                                      mask)
            return G, None, H_rows, ChunkedSigRowCtx(D, B, mask)
        if is_sparse(D):
            # unreachable through the estimator, which densifies or
            # streams a sigmoid-linked sparse matrix under Newton
            raise NotImplementedError(
                "Newton sigmoid-link terms need dense D or a chunked layout "
                "(the update materializes sigmoid predictions per row "
                "block)")
        G, H_rows = sigmoid_newton.sigmoid_gh_rows(D, M, B, hessian_form,
                                                   mask)
        return G, None, H_rows, _SigmoidCtx(D, B, mask)
    if mask is not None:
        # the mask folds into B: zeroed rows drop out of BᵀB and D B as
        # gathering the drawn columns would; the row norms take the mask
        mv = mask.to(M.dtype)
        Bm = B * mask[:, None].to(B.dtype)
        BtB = gram(Bm)
        DB = layout_spmm(D, layout, Bm, use_pallas)
        if isinstance(D, ChunkedT):
            row_sq = chunked_masked_col_sq(D.ck, mv)
        elif is_chunked(D):
            row_sq = chunked_masked_row_sq(D, mv)
        elif is_sparse(D):
            row_sq = masked_row_sq_norms(D, mv, use_pallas)
        else:
            Df = D.to(M.dtype)
            row_sq = matmul(Df * Df, mv, precision="highest")
        G = matmul(M, BtB) - DB
        return G, BtB, None, _LinearCtx(DB, BtB, row_sq)
    BtB = gram(B) if btb is None else btb
    DB = layout_spmm(D, layout, B, use_pallas) if db is None else db
    G = matmul(M, BtB) - DB
    if row_sq is None:
        if is_chunked(D) or isinstance(D, ChunkedT):
            raise ValueError(
                "chunked Newton terms need their precomputed row_sq (a "
                "fit-time constant: see as_coupled)")
        if is_sparse(D):
            row_sq = row_sq_norms(D)
        else:
            Df = D.to(M.dtype)
            row_sq = torch.sum(Df * Df, dim=1)
    return G, BtB, None, _LinearCtx(DB, BtB, row_sq)


def _phi_term(Mc, ctx) -> torch.Tensor:
    """Per-row residual objective ½‖dᵢ − f(B mᵢ)‖² for a candidate factor
    (rows on the second-to-last axis, any leading candidate axes)."""
    if isinstance(ctx, _SigmoidCtx):
        return sigmoid_sq_rows(ctx.D, Mc, ctx.B, ctx.mask)
    if isinstance(ctx, ChunkedTSigCtx):
        return chunked_sigmoid_colwise_phi(ctx, Mc)
    if isinstance(ctx, ChunkedSigRowCtx):
        return chunked_sigmoid_rowwise_phi(ctx, Mc)
    quad = torch.sum(matmul(Mc, ctx.BtB) * Mc, dim=-1)
    return 0.5 * (ctx.row_sq - 2.0 * torch.sum(ctx.DB * Mc, dim=-1) + quad)


def _cholesky(H):
    """Cholesky factor of H without a host sync. A matrix that is not
    positive definite gives NaN, as jax.scipy.linalg.cho_factor does, and
    the fit loop reports the non-finite loss (torch.linalg.cholesky would
    check on the host after every call)."""
    L, info = torch.linalg.cholesky_ex(H)
    return torch.where(info > 0, torch.nan, L)


def _solve_direction(H_shared, H_rows, G, use_pallas: bool,
                     spd: bool = True):
    """d = H⁻¹ g for all rows. H_rows None: one shared k×k SPD system (all
    links linear), one Cholesky. Else per-row systems H_rows + H_shared,
    under use_pallas through the batched solve kernel, which adds H_shared
    as it reads each system: its Cholesky routes when they are SPD
    (``spd``: the Gauss-Newton form), its LU route otherwise (the full
    form's systems may be indefinite). With use_pallas off, an LU solve of
    the sum (torch.linalg.solve_ex: no host sync). Reference:
    ``pycmf_tpu/solvers/newton.py:_solve_direction``."""
    if H_rows is None:
        return torch.cholesky_solve(G.mT, _cholesky(H_shared)).mT
    if use_pallas:
        if spd:
            return batched_solve.batched_spd_solve(H_rows, G, H_shared)
        return batched_solve.batched_lu_solve(H_rows, G, H_shared)
    return torch.linalg.solve_ex(H_rows + H_shared, G[..., None])[0][..., 0]


def _project(non_negative: bool):
    if non_negative:
        return lambda Mc: torch.clamp_min(Mc, 0.0)
    return lambda Mc: Mc


def newton_update_factor(key, M, terms, links, hyper: Hyper, *,
                         non_negative: bool, trials: int,
                         hessian_form: str = "gauss",
                         sample_ratio: float = 1.0, use_pallas: bool = False,
                         distributed=(), masks=(), group=None,
                         return_phi: bool = False, term_cache=None):
    """One batched Newton update of factor M against its coupled terms
    (reference: ``pycmf_tpu/solvers/newton.py:newton_update_factor``).

    key: the step's key of this factor, a (2,) int64 tensor on M's device
    (unused unless sample_ratio < 1): term t draws under
    :func:`term_key`, a distributed term's key folded with ``group``'s
    rank, as the reference folds its axis index; a layout that folds the
    factor's key before the call (rows: U's; cols: V's; the grid: V's) does
    so itself. Ranks that hold one replica of a factor thus draw alike and
    keep it bit for bit equal. A distributed term's draw covers the rank's
    padded local columns, and its padding columns stay masked.
    distributed: one bool per term; True marks a term whose columns are
    sharded over ``group`` (a ``parallel.mesh.Mesh``): its G, H and φ
    contributions are summed over the ranks, in one all-reduce for G and
    H and one per φ evaluation. masks: one optional (q,) column mask per
    term (a sigmoid term's padding columns on a shard).
    return_phi: additionally return the per-row φ at the selected value
    (see _aux_loss_phi); needs trials >= 1.
    term_cache: a term's index: additionally return that linear term's
    (D B, BᵀB), which the update computes anyway and which do not depend on
    the selected step (the cols layout's factored eval loss; full batch
    only: a sampled term's pair describes its draw). Not with return_phi.
    """
    if return_phi and term_cache is not None:
        raise ValueError("return_phi and term_cache are exclusive")
    k = M.shape[1]
    l1, l2 = hyper.l1, hyper.l2
    distributed = distributed or (False,) * len(terms)
    masks = masks or (None,) * len(terms)
    any_dist = group is not None and any(distributed)
    parts, ctxs = [], []
    for t, (term, link, dist, mask) in enumerate(zip(terms, links,
                                                     distributed, masks)):
        term = term if isinstance(term, Term) else Term(*term)
        if sample_ratio < 1.0:
            tkey = term_key(key, t, group.rank if dist and group is not None
                            else None)
            term, mask = _sample_term(tkey, term, sample_ratio, M.dtype,
                                      mask)
        G_t, H_sh, H_rw, ctx = _accumulate_term(M, term, link, use_pallas,
                                                hessian_form, mask)
        parts.append([G_t, H_sh, H_rw])
        ctxs.append((ctx, dist and any_dist))
    if any_dist:
        # the sharded terms' G, H_shared and H_rows summed over the ranks
        # in one all-reduce; every term then joins in term order, as on one
        # device (a one-rank group's fit is the single device's bit for bit)
        slots = [(t, j) for t, (_, dist) in enumerate(ctxs) if dist
                 for j in range(3) if parts[t][j] is not None]
        for (t, j), v in zip(slots, all_reduce(
                group, *(parts[t][j] for t, j in slots))):
            parts[t][j] = v
    G = l1 * torch.sign(M) + l2 * M
    H_shared = (l2 + hyper.hessian_pertubation) * torch.eye(
        k, dtype=M.dtype, device=M.device)
    H_rows = None
    for G_t, H_sh, H_rw in parts:
        G = G + G_t
        if H_sh is not None:
            H_shared = H_shared + H_sh
        if H_rw is not None:
            H_rows = H_rw if H_rows is None else H_rows + H_rw
    d = _solve_direction(H_shared, H_rows, G, use_pallas,
                         spd=hessian_form == "gauss")

    def phi(Mc):
        terms_phi = [_phi_term(Mc, ctx) for ctx, _ in ctxs]
        dist = [t for t, (_, d) in enumerate(ctxs) if d]
        if dist:   # one all-reduce per evaluation
            for t, v in zip(dist, all_reduce(
                    group, *(terms_phi[t] for t in dist))):
                terms_phi[t] = v
        out = l1 * torch.sum(torch.abs(Mc), dim=-1) \
            + 0.5 * l2 * torch.sum(Mc * Mc, dim=-1)
        for v in terms_phi:
            out = out + v
        return out

    out = backtracking_select(phi, _project(non_negative), M, d, trials,
                              return_phi=return_phi)
    if term_cache is None:
        return out
    ctx = ctxs[term_cache][0]
    if not isinstance(ctx, _LinearCtx):
        raise ValueError("term_cache requires a linear term")
    return out, (ctx.DB, ctx.BtB)


def fused_sigmoid_allowed(cfg: SolverConfig, A, M) -> bool:
    """Whether a sigmoid-linked factor takes fused_sigmoid_update: kernels
    on, dense data A (a chunked A, or its ChunkedT, takes it chunk by
    chunk inside newton_chunked), full batch, Gauss-Newton form (SPD
    systems for the batched solve), float factors."""
    return (cfg.use_pallas and not is_sparse(A) and not is_chunked(A)
            and not isinstance(A, ChunkedT) and cfg.sg_sample_ratio >= 1.0
            and cfg.hessian_form == "gauss" and M.dtype != torch.bfloat16)


def fused_sigmoid_update(M, X, B, hyper: Hyper, *, trials: int,
                         non_negative: bool, use_pallas: bool, yterm=None,
                         y_link: str = LINEAR, row_mask=None, group=None,
                         return_phi: bool = False):
    """One Newton update of M (p, k) against X ≈ σ(M Bᵀ), optionally
    coupled with a second term evaluated in plain PyTorch (V's Y side).

    Two passes over X: sigmoid_gh_pass builds G and the per-row Gauss-
    Newton Hessians; after the batched SPD solve, sigmoid_phi_pass
    evaluates every backtracking candidate. Selection rebuilds the winning
    candidate with the same formula. X must be row-major: for V's update
    it is the contiguous Xᵀ that run_newton makes once per fit
    (Coupled.At).

    row_mask: an optional (p,) 0/1 mask of M's rows; the rows it zeroes
    (a shard's padding rows, whose σ(0) = ½ residuals give nonzero
    updates) are zeroed after selection.

    group: a ``parallel.mesh.Mesh`` when X and B hold this rank's slice of
    the q axis (M replicated): K3's G and H and K4's φ are summed over the
    ranks. The kernels then get l1 = l2 = 0 and the elastic-net terms are
    added once after the sums; ``yterm`` stays local. B's padding rows are
    zero, so the padding columns add nothing to G and H, and to every φ
    slot of a row the same σ(0) = ½ residual, which leaves the selection
    as it is (reference: ``pycmf_tpu/solvers/newton.py:482-600``).

    return_phi: additionally return the per-row φ at the selected
    candidates (see _aux_loss_phi; zero on rows ``row_mask`` zeroes);
    needs trials >= 1. Under ``group`` it includes 0.125 per padding
    column, which a caller that sums it as a loss subtracts."""
    k = M.shape[1]
    l1, l2 = hyper.l1, hyper.l2
    if group is None:
        G, H_rows = sigmoid_newton.sigmoid_gh_pass(X, M, B, l1, l2)
    else:
        G, H_rows = all_reduce(
            group, *sigmoid_newton.sigmoid_gh_pass(X, M, B, 0.0, 0.0))
        G = G + l1 * torch.sign(M) + l2 * M
    H_shared = (l2 + hyper.hessian_pertubation) * torch.eye(
        k, dtype=M.dtype, device=M.device)
    ctx_y = None
    if yterm is not None:
        t = yterm if isinstance(yterm, Term) else Term(*yterm)
        G_y, H_sh_y, H_rw_y, ctx_y = _accumulate_term(M, t, y_link,
                                                      use_pallas)
        G = G + G_y
        if H_sh_y is not None:
            H_shared = H_shared + H_sh_y
        if H_rw_y is not None:
            H_rows = H_rows + H_rw_y
    d = _solve_direction(H_shared, H_rows, G, use_pallas)
    project = _project(non_negative)
    if trials <= 0:
        if return_phi:
            raise ValueError("return_phi needs trials >= 1")
        out = project(M - d)
        return out if row_mask is None else out * row_mask[:, None]
    if group is None:
        phis = sigmoid_newton.sigmoid_phi_pass(X, M, d, B, l1, l2,
                                               trials=trials,
                                               non_negative=non_negative)
    else:
        phis = all_reduce(group, sigmoid_newton.sigmoid_phi_pass(
            X, M, d, B, 0.0, 0.0, trials=trials,
            non_negative=non_negative))[0]
    if group is not None or ctx_y is not None:
        # the φ columns the kernel does not carry, slot 0 = M unprojected:
        # the penalties (added once, after the sum) and the Y term
        cands = sigmoid_newton.candidates(M, d, trials, non_negative)
        extra = 0.0
        if group is not None:
            extra = l1 * torch.sum(torch.abs(cands), dim=-1) \
                + 0.5 * l2 * torch.sum(cands * cands, dim=-1)
        if ctx_y is not None:
            extra = extra + _phi_term(cands, ctx_y)
        phis = phis + extra.T
    out = backtracking_select_table(phis, project, M, d,
                                    return_phi=return_phi)
    if row_mask is None:
        return out
    if return_phi:
        return out[0] * row_mask[:, None], out[1] * row_mask
    return out * row_mask[:, None]


def shared_gauss_hinv(V, hyper: Hyper):
    """(BtB, Hinv, l1, l2) of the shared linear-link system
    H = VᵀV + (l2 + hessian_pertubation)·I.

    The damping is parity-critical: it is built here only, for the fused
    U pass, so the trajectories of the two branches cannot drift apart."""
    k = V.shape[1]
    BtB = gram(V)
    eye = torch.eye(k, dtype=V.dtype, device=V.device)
    H = BtB + (hyper.l2 + hyper.hessian_pertubation) * eye
    return BtB, torch.cholesky_solve(eye, _cholesky(H)), hyper.l1, hyper.l2


def fused_newton_u_allowed(cfg: SolverConfig, A, row_sq, U) -> bool:
    """Whether the U update takes the fused U pass: dense X, linear X link,
    full batch, and a V update to consume the XᵀU_new / U_newᵀU_new it
    returns."""
    return (cfg.use_pallas and cfg.update_U and cfg.update_V
            and cfg.x_link == LINEAR and cfg.sg_sample_ratio >= 1.0
            and not is_sparse(A) and not is_chunked(A)
            and U.dtype != torch.bfloat16
            and row_sq is not None)


def _transposed(C: Coupled):
    """C.A transposed: the layout of Aᵀ for sparse data; a chunked A marked
    as its transpose (ChunkedT: its forward chunks are streamed); for dense
    data the contiguous copy run_newton makes when there is one (the card's
    fused sigmoid passes need it), else a view."""
    if is_chunked(C.A):
        return ChunkedT(C.A)
    return C.A.mT if C.At is None else C.At


def _with_transposes(cfg: SolverConfig, X: Coupled, Y, V0, Z0):
    """(X, Y) with the contiguous Aᵀ (Coupled.At) that make_newton_step
    reads: Xᵀ for a fused sigmoid V update, Yᵀ for a fused sigmoid Z
    update. Made once per fit, never per iteration, at the data's own
    dtype (fp8 through its byte view)."""
    if (cfg.update_V and cfg.x_link != LINEAR
            and fused_sigmoid_allowed(cfg, X.A, V0)):
        X = X._replace(At=contiguous_t(X.A))
    if (cfg.has_Y and cfg.update_Z and cfg.y_link != LINEAR
            and fused_sigmoid_allowed(cfg, Y.A, Z0)):
        Y = Y._replace(At=contiguous_t(Y.A))
    return X, Y


def make_newton_step(cfg: SolverConfig, with_aux=None):
    """The Newton step: update U, then Z, then V (pinned order).

    with_aux: None; "factored" (or True): additionally return (XᵀU_new,
    U_newᵀU_new) from the fused U pass (see _aux_loss); "phi": return Σφ
    of V's line search at the accepted candidates (see _aux_loss_phi)."""
    phi_aux = with_aux == "phi"
    common = dict(trials=cfg.line_search_trials,
                  hessian_form=cfg.hessian_form,
                  sample_ratio=cfg.sg_sample_ratio,
                  use_pallas=cfg.use_pallas)
    fused = dict(trials=cfg.line_search_trials, use_pallas=cfg.use_pallas)

    sampled = cfg.sg_sample_ratio < 1.0

    def step(X: Coupled, Y, U, V, Z, hyper: Hyper, keys=None):
        """keys: the step's (kU, kZ, kV), (3, 2) (KeyStream.step_keys), or
        None for a full-batch step."""
        kU, kZ, kV = (None,) * 3 if keys is None else keys
        numv_x = gram_u = phi_sum = None
        x_chunked = is_chunked(X.A)
        if cfg.update_U:
            if x_chunked and cfg.x_link != LINEAR:
                # row-local streamed sigmoid update; a sampled step takes
                # the U term's draw (term 0's key) as its column mask
                col_mask = (sample_mask(term_key(kU, 0), X.A.shape[1],
                                        cfg.sg_sample_ratio, U.dtype)
                            if sampled else None)
                U = chunked_sigmoid_row_update(
                    X.A, U, V, hyper, trials=cfg.line_search_trials,
                    non_negative=cfg.U_non_negative,
                    hessian_form=cfg.hessian_form,
                    use_pallas=cfg.use_pallas, col_mask=col_mask)
            elif x_chunked and cfg.update_V and not sampled:
                # one streamed pass: U_new and V's X-side terms (the fused
                # U pass's contract); a U-only or sampled step takes the
                # generic term below
                BtB, Hinv, l1, l2 = shared_gauss_hinv(V, hyper)
                U, numv_x, gram_u = chunked_newton_linear_u_pass(
                    X.A, U, V, BtB, Hinv, X.row_sq, l1, l2,
                    trials=cfg.line_search_trials,
                    non_negative=cfg.U_non_negative,
                    use_pallas=cfg.use_pallas)
            elif fused_newton_u_allowed(cfg, X.A, X.row_sq, U):
                BtB, Hinv, l1, l2 = shared_gauss_hinv(V, hyper)
                U, numv_x, gram_u = newton_fused.fused_newton_linear_u_pass(
                    X.A, U, V, BtB, Hinv, X.row_sq, l1, l2,
                    trials=cfg.line_search_trials,
                    non_negative=cfg.U_non_negative)
            elif cfg.x_link != LINEAR and fused_sigmoid_allowed(cfg, X.A, U):
                U = fused_sigmoid_update(U, X.A, V, hyper,
                                         non_negative=cfg.U_non_negative,
                                         **fused)
            else:
                U = newton_update_factor(
                    kU, U, (Term(X.A, V, X.row_sq, layout=X.A_bell),),
                    (cfg.x_link,), hyper, non_negative=cfg.U_non_negative,
                    **common)
        if cfg.has_Y and cfg.update_Z:
            if cfg.y_link != LINEAR and fused_sigmoid_allowed(cfg, Y.A, Z):
                Z = fused_sigmoid_update(Z, _transposed(Y), V, hyper,
                                         non_negative=cfg.Z_non_negative,
                                         **fused)
            else:
                zterm = Term(_transposed(Y), V, Y.row_sq_t,
                             layout=Y.At_bell)
                Z = newton_update_factor(
                    kZ, Z, (zterm,), (cfg.y_link,),
                    hyper, non_negative=cfg.Z_non_negative, **common)
        if cfg.update_V:
            yterm = (Term(Y.A, Z, Y.row_sq, layout=Y.A_bell) if cfg.has_Y
                     else None)
            if cfg.x_link != LINEAR and fused_sigmoid_allowed(cfg, X.A, V):
                out = fused_sigmoid_update(
                    V, _transposed(X), U, hyper,
                    non_negative=cfg.V_non_negative, yterm=yterm,
                    y_link=cfg.y_link, return_phi=phi_aux, **fused)
            else:
                # With the fused U pass's XᵀU_new and U_newᵀU_new, V's X
                # term needs no second pass over X (D is then never read).
                terms = (Term(_transposed(X), U, X.row_sq_t, DB=numv_x,
                              BtB=gram_u, layout=X.At_bell),)
                links = (cfg.x_link,)
                if cfg.has_Y:
                    terms = terms + (yterm,)
                    links = links + (cfg.y_link,)
                out = newton_update_factor(
                    kV, V, terms, links, hyper,
                    non_negative=cfg.V_non_negative, return_phi=phi_aux,
                    **common)
            if phi_aux:
                V, phi_rows = out
                phi_sum = phi_rows.sum()
            else:
                V = out
        if phi_aux:
            if phi_sum is None:
                raise ValueError("the phi aux loss needs the V update "
                                 "(see _aux_kind)")
            return U, V, Z, phi_sum
        if with_aux:
            if numv_x is None:
                raise ValueError("with_aux requires the fused U pass "
                                 "(see _aux_ok)")
            return U, V, Z, (numv_x, gram_u)
        return U, V, Z

    return step


def _aux_loss(cfg: SolverConfig):
    """Loss from the fused U pass's XᵀU_new and U_newᵀU_new: no pass over X
    (the same factored identity as solvers/mu.py:_aux_loss)."""

    def loss_fn(state, aux, hyper: Hyper):
        X, Y, U, V, Z = state
        num_vx, gram_u = aux
        inner = (num_vx * V).sum()
        x_term = 0.5 * (X.a_sq - 2.0 * inner + (gram_u * gram(V)).sum())
        loss = x_term + penalty(U, hyper.alpha, hyper.l1_ratio) \
            + penalty(V, hyper.alpha, hyper.l1_ratio)
        if cfg.has_Y:
            loss = loss + reconstruction_term(
                Y.A, V, Z, cfg.y_link, a_sq=Y.a_sq, bell_t=Y.At_bell,
                use_pallas=cfg.use_pallas)
            loss = loss + penalty(Z, hyper.alpha, hyper.l1_ratio)
        return loss

    return loss_fn


def _aux_ok(cfg: SolverConfig, X: Coupled, U0) -> bool:
    """The aux loss needs a U pass that returns XᵀU_new every step (the
    fused kernel, or the chunked stream), ‖X‖², and not the small
    mixed-precision cancellation regime (mirrors solvers/mu.py)."""
    if is_chunked(X.A):
        return (cfg.update_U and cfg.update_V and cfg.x_link == LINEAR
                and cfg.sg_sample_ratio >= 1.0 and X.a_sq is not None)
    if not fused_newton_u_allowed(cfg, X.A, X.row_sq, U0):
        return False
    if X.a_sq is None:
        return False
    if X.A.dtype != U0.dtype and X.A.numel() < (1 << 22):
        return False
    return True


def _aux_loss_phi(cfg: SolverConfig):
    """Eval loss from V's accepted-candidate Σφ: no data pass at all.

    V is updated last, and its per-row objective is ½‖(Xᵀ)ⱼ − f(U vⱼ)‖² +
    ½‖yⱼ − f(Z vⱼ)‖² + l1‖vⱼ‖₁ + ½l2‖vⱼ‖², so Σⱼ φ(V_new) is L_X + L_Y + R(V)
    at the post-step iterate; only R(U) and R(Z) are added here."""

    def loss_fn(state, aux, hyper: Hyper):
        X, Y, U, V, Z = state
        loss = aux + penalty(U, hyper.alpha, hyper.l1_ratio)
        if cfg.has_Y:
            loss = loss + penalty(Z, hyper.alpha, hyper.l1_ratio)
        return loss

    return loss_fn


def _aux_kind(cfg: SolverConfig, X: Coupled, U0):
    """Which zero-extra-pass eval loss applies: "factored" (linear X link,
    the fused U pass's accumulators), "phi" (any other X link: needs the V
    update, a line search and the full batch), or None."""
    if cfg.x_link == LINEAR:
        return "factored" if _aux_ok(cfg, X, U0) else None
    if not (cfg.update_V and cfg.line_search_trials >= 1
            and cfg.sg_sample_ratio >= 1.0):
        return None
    return "phi"


def _loss_core(cfg: SolverConfig):
    def loss_fn(state, hyper: Hyper):
        X, Y, U, V, Z = state
        has_y = cfg.has_Y
        return total_loss(X.A, Y.A if has_y else None, U, V, Z,
                          cfg.x_link, cfg.y_link, hyper.alpha,
                          hyper.l1_ratio, x_a_sq=X.a_sq,
                          y_a_sq=(Y.a_sq if has_y else None),
                          x_bell_t=X.At_bell,
                          y_bell_t=(Y.At_bell if has_y else None),
                          use_pallas=cfg.use_pallas)

    return loss_fn


def _per_row_systems(cfg: SolverConfig) -> bool:
    """Whether a step solves per-row systems (a sigmoid-linked term)."""
    return ((cfg.x_link != LINEAR and (cfg.update_U or cfg.update_V))
            or (cfg.has_Y and cfg.y_link != LINEAR
                and (cfg.update_Z or cfg.update_V)))


def captures_on_card(cfg: SolverConfig) -> bool:
    """Whether the Newton step can be captured in a CUDA graph on the
    card: not when its per-row systems (a sigmoid-linked term) reach a
    library's batched solve instead of K5, which is the plain path's
    (use_pallas off) torch.linalg.solve_ex: MAGMA's batched LU, which
    allocates device memory inside the call, and a capture refuses that
    (ROADMAP C3). Under use_pallas every k and both Hessian forms take K5's
    routes."""
    return not _per_row_systems(cfg) or cfg.use_pallas


def check_device_loop(cfg: SolverConfig, on_card: bool, loop: str) -> None:
    """Raise NotImplementedError for loop='device' on the card
    (``on_card``) where the Newton step cannot be captured
    (:func:`captures_on_card`: ROADMAP C3), on one device or under
    shards."""
    if on_card and loop == "device" and not captures_on_card(cfg):
        raise NotImplementedError(
            "loop='device' cannot capture this Newton fit on the card: its "
            "per-row systems (a sigmoid link) take a library's batched "
            "solve (use_pallas=False solves them by torch.linalg.solve_ex), "
            "which allocates device memory inside the call (ROADMAP C3); "
            "use loop='host' or 'auto'")


def _make_block(cfg: SolverConfig, aux):
    step = make_newton_step(cfg, with_aux=aux)
    loss_fn = _loss_core(cfg)
    aux_loss = None
    if aux is not None:
        aux_loss = (_aux_loss_phi if aux == "phi" else _aux_loss)(cfg)

    def block(state, hyper: Hyper, rng, n_steps: int):
        """``rng``: the fit's KeyStream (sampled), advanced past the block
        on the device, or None."""
        X, Y, U, V, Z = state
        a = None
        for i in range(n_steps):
            keys = None if rng is None else rng.step_keys(i)
            out = step(X, Y, U, V, Z, hyper, keys)
            if aux is None:
                U, V, Z = out
            else:
                U, V, Z, a = out
        if rng is not None:
            rng.advance(n_steps)
        state = (X, Y, U, V, Z)
        if aux is None:
            return state, loss_fn(state, hyper), rng
        return state, aux_loss(state, a, hyper), rng

    return block


def run_newton(X: Coupled, Y, U0, V0, Z0, cfg: SolverConfig, hyper: Hyper,
               rng: Optional[torch.Tensor] = None, *, max_iter: int = 200,
               tol: float = 1e-4, eval_every: int = 10, verbose: int = 0,
               loop: str = "host"):
    """Run the Newton solver (loop semantics as in run_mu). ``rng``: the
    reference's key, a (2,) int64 tensor of uint32 words
    (``ops/random.prng_key``) on the factors' device, under which a
    sampled step (sg_sample_ratio < 1) draws its columns: iteration j
    (from 0) under fold_in(rng, j), on both loops (the device loop reads j
    from a device counter), so the two draw the same bits."""
    check_loop(loop)
    check_device_loop(cfg, U0.is_cuda, loop)
    aux = _aux_kind(cfg, X, U0)
    block = _make_block(cfg, aux)
    X, Y = _with_transposes(cfg, X, Y, V0, Z0)
    state = (X, Y, U0, V0, Z0)
    if cfg.sg_sample_ratio >= 1.0:
        rng = None  # nothing draws: no key stream for the graphs to carry
    elif rng is None:
        raise ValueError("a sampled Newton fit (sg_sample_ratio < 1) draws "
                         "under a key: pass rng (ops/random.prng_key)")
    else:
        rng = KeyStream.start(rng.to(U0.device))
    state, n_iter, losses, iters, times = run_solver_loop(
        block, state, hyper, rng, max_iter=max_iter, tol=tol,
        eval_every=eval_every, verbose=verbose,
        initial_loss_fn=_loss_core(cfg), loop=loop, key=("newton", cfg, aux))
    _, _, U, V, Z = state
    return U, V, Z, n_iter, losses, iters, times
