"""Batched row-wise Newton solver (linear links, full batch).

Counterpart of the linear dense subset of ``pycmf_tpu/solvers/newton.py``.
Per row of a factor M against its coupled terms (D, B), D ≈ M Bᵀ:

    g = Σ (M BᵀB − D B) + l1·sign(M) + l2·M
    H = Σ BᵀB + (l2 + hessian_pertubation)·I     (shared by every row)
    M ← proj( M − step · g H⁻¹ ), step from the backtracking line search

U sees one term (X, V); Z sees (Yᵀ, V); the shared V sees (Xᵀ, U) and
(Y, Z). With ``use_pallas`` the U update is one call of the fused U pass
(``ops/kernels/newton_fused.py``: the CUDA kernel on the card), whose
XᵀU_new and U_newᵀU_new feed V's X term, so V never reads X again.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..ops.kernels import newton_fused
from ..ops.linesearch import backtracking_select
from ..ops.links import LINEAR
from ..ops.losses import penalty, reconstruction_term, total_loss
from ..ops.matmul import gram, matmul
from .common import Coupled, Hyper, SolverConfig, check_loop, run_solver_loop


class Term(NamedTuple):
    """One coupled data term of a factor update: D ≈ M Bᵀ row-wise.

    row_sq : optional precomputed per-row ‖dᵢ‖² (fit-time constant)
    DB     : optional precomputed D @ B (p, k), e.g. the XᵀU_new the fused
             U pass returns, which saves V's update its own pass over X
    BtB    : optional precomputed gram(B) (k, k), paired with DB
    """

    D: torch.Tensor
    B: torch.Tensor
    row_sq: Optional[torch.Tensor] = None
    DB: Optional[torch.Tensor] = None
    BtB: Optional[torch.Tensor] = None


class _LinearCtx(NamedTuple):
    """Candidate-independent quantities of a linear term's line search:
    φᵢ(m) = ½(‖dᵢ‖² − 2⟨(DB)ᵢ, m⟩ + mᵀ(BᵀB)m)."""

    DB: torch.Tensor
    BtB: torch.Tensor
    row_sq: torch.Tensor


def _accumulate_term(M, term: Term, link: str):
    """(G_term (p, k), H_shared term (k, k), line-search ctx) of one term."""
    if link != LINEAR:
        raise NotImplementedError(
            "sigmoid links are not ported yet (ROADMAP A3: sigmoid Newton "
            "with kernels K3-K5)")
    D, B, row_sq, db, btb = term
    BtB = gram(B) if btb is None else btb
    DB = matmul(D, B) if db is None else db
    G = matmul(M, BtB) - DB
    if row_sq is None:
        Df = D.to(M.dtype)
        row_sq = torch.sum(Df * Df, dim=1)
    return G, BtB, _LinearCtx(DB, BtB, row_sq)


def _phi_term(Mc, ctx: _LinearCtx) -> torch.Tensor:
    """Per-row residual objective ½‖dᵢ − B mᵢ‖² for a candidate factor
    (rows on the second-to-last axis, any leading candidate axes)."""
    quad = torch.sum(matmul(Mc, ctx.BtB) * Mc, dim=-1)
    return 0.5 * (ctx.row_sq - 2.0 * torch.sum(ctx.DB * Mc, dim=-1) + quad)


def _cholesky(H):
    """Cholesky factor of H without a host sync. A matrix that is not
    positive definite gives NaN, as jax.scipy.linalg.cho_factor does, and
    the fit loop reports the non-finite loss (torch.linalg.cholesky would
    check on the host after every call)."""
    L, info = torch.linalg.cholesky_ex(H)
    return torch.where(info > 0, torch.nan, L)


def _solve_direction(H_shared, G):
    """d = G H⁻¹ for all rows: one k×k Cholesky (H is SPD)."""
    return torch.cholesky_solve(G.mT, _cholesky(H_shared)).mT


def newton_update_factor(rng, M, terms, links, hyper: Hyper, *,
                         non_negative: bool, trials: int,
                         hessian_form: str = "gauss",
                         sample_ratio: float = 1.0):
    """One batched Newton update of factor M against its coupled terms.

    rng: a torch.Generator or None; unused at sample_ratio = 1 (column
    sampling, which would draw from it, is ROADMAP A3).
    """
    if sample_ratio < 1.0:
        raise NotImplementedError(
            "sg_sample_ratio < 1 is not ported yet (ROADMAP A3: Newton "
            "column sampling)")
    if hessian_form != "gauss":
        raise NotImplementedError(
            "hessian_form='full' is not ported yet (ROADMAP A3)")
    k = M.shape[1]
    l1, l2 = hyper.l1, hyper.l2
    G = l1 * torch.sign(M) + l2 * M
    H = (l2 + hyper.hessian_pertubation) * torch.eye(
        k, dtype=M.dtype, device=M.device)
    ctxs = []
    for term, link in zip(terms, links):
        term = term if isinstance(term, Term) else Term(*term)
        G_t, BtB, ctx = _accumulate_term(M, term, link)
        G = G + G_t
        H = H + BtB
        ctxs.append(ctx)
    d = _solve_direction(H, G)

    def project(Mc):
        return torch.clamp_min(Mc, 0.0) if non_negative else Mc

    def phi(Mc):
        out = l1 * torch.sum(torch.abs(Mc), dim=-1) \
            + 0.5 * l2 * torch.sum(Mc * Mc, dim=-1)
        for ctx in ctxs:
            out = out + _phi_term(Mc, ctx)
        return out

    return backtracking_select(phi, project, M, d, trials)


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
    """Whether the U update takes the fused U pass: linear X link, full
    batch, and a V update to consume the XᵀU_new / U_newᵀU_new it returns."""
    return (cfg.use_pallas and cfg.update_U and cfg.update_V
            and cfg.x_link == LINEAR and cfg.sg_sample_ratio >= 1.0
            and U.dtype != torch.bfloat16 and row_sq is not None)


def make_newton_step(cfg: SolverConfig, with_aux: bool = False):
    """The Newton step: update U, then Z, then V (pinned order).

    with_aux: additionally return (XᵀU_new, U_newᵀU_new) from the fused U
    pass (see _aux_loss)."""
    common = dict(trials=cfg.line_search_trials,
                  hessian_form=cfg.hessian_form,
                  sample_ratio=cfg.sg_sample_ratio)

    def step(X: Coupled, Y, U, V, Z, hyper: Hyper, rng=None):
        numv_x = gram_u = None
        if cfg.update_U:
            if fused_newton_u_allowed(cfg, X.A, X.row_sq, U):
                BtB, Hinv, l1, l2 = shared_gauss_hinv(V, hyper)
                U, numv_x, gram_u = newton_fused.fused_newton_linear_u_pass(
                    X.A, U, V, BtB, Hinv, X.row_sq, l1, l2,
                    trials=cfg.line_search_trials,
                    non_negative=cfg.U_non_negative)
            else:
                U = newton_update_factor(
                    rng, U, (Term(X.A, V, X.row_sq),), (cfg.x_link,), hyper,
                    non_negative=cfg.U_non_negative, **common)
        if cfg.has_Y and cfg.update_Z:
            Z = newton_update_factor(
                rng, Z, (Term(Y.A.mT, V, Y.row_sq_t),), (cfg.y_link,), hyper,
                non_negative=cfg.Z_non_negative, **common)
        if cfg.update_V:
            # With the fused U pass's XᵀU_new and U_newᵀU_new, V's X term
            # needs no second pass over X (D is then never read).
            terms = (Term(X.A.mT, U, X.row_sq_t, DB=numv_x, BtB=gram_u),)
            links = (cfg.x_link,)
            if cfg.has_Y:
                terms = terms + (Term(Y.A, Z, Y.row_sq),)
                links = links + (cfg.y_link,)
            V = newton_update_factor(
                rng, V, terms, links, hyper,
                non_negative=cfg.V_non_negative, **common)
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
            loss = loss + reconstruction_term(Y.A, V, Z, cfg.y_link,
                                              a_sq=Y.a_sq)
            loss = loss + penalty(Z, hyper.alpha, hyper.l1_ratio)
        return loss

    return loss_fn


def _aux_ok(cfg: SolverConfig, X: Coupled, U0) -> bool:
    """The aux loss needs the fused U pass every step, ‖X‖², and not the
    small mixed-precision cancellation regime (mirrors solvers/mu.py)."""
    if not fused_newton_u_allowed(cfg, X.A, X.row_sq, U0):
        return False
    if X.a_sq is None:
        return False
    if X.A.dtype != U0.dtype and X.A.numel() < (1 << 22):
        return False
    return True


def _loss_core(cfg: SolverConfig):
    def loss_fn(state, hyper: Hyper):
        X, Y, U, V, Z = state
        return total_loss(X.A, Y.A if cfg.has_Y else None, U, V, Z,
                          cfg.x_link, cfg.y_link, hyper.alpha,
                          hyper.l1_ratio, x_a_sq=X.a_sq,
                          y_a_sq=(Y.a_sq if cfg.has_Y else None))

    return loss_fn


def _make_block(cfg: SolverConfig, aux: bool):
    step = make_newton_step(cfg, with_aux=aux)
    loss_fn = _aux_loss(cfg) if aux else _loss_core(cfg)

    def block(state, hyper: Hyper, rng, n_steps: int):
        X, Y, U, V, Z = state
        a = None
        for _ in range(n_steps):
            out = step(X, Y, U, V, Z, hyper, rng)
            if aux:
                U, V, Z, a = out
            else:
                U, V, Z = out
        state = (X, Y, U, V, Z)
        loss = loss_fn(state, a, hyper) if aux else loss_fn(state, hyper)
        return state, loss, rng

    return block


def run_newton(X: Coupled, Y, U0, V0, Z0, cfg: SolverConfig, hyper: Hyper,
               rng: Optional[torch.Generator] = None, *, max_iter: int = 200,
               tol: float = 1e-4, eval_every: int = 10, verbose: int = 0,
               loop: str = "host"):
    """Run the Newton solver (loop semantics as in run_mu)."""
    check_loop(loop)
    block = _make_block(cfg, _aux_ok(cfg, X, U0))
    state = (X, Y, U0, V0, Z0)
    state, n_iter, losses, iters, times = run_solver_loop(
        block, state, hyper, rng, max_iter=max_iter, tol=tol,
        eval_every=eval_every, verbose=verbose,
        initial_loss_fn=_loss_core(cfg))
    _, _, U, V, Z = state
    return U, V, Z, n_iter, losses, iters, times
