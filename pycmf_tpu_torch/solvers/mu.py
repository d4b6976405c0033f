"""Multiplicative-update (MU) solver.

Counterpart of ``pycmf_tpu/solvers/mu.py``. Lee–Seung updates with a
shared V, in the pinned order U → Z → V:

    U ← U ⊙ (X V)        ⊘ (U (VᵀV)        + l1 + l2·U + ε)
    Z ← Z ⊙ (Yᵀ V)       ⊘ (Z (VᵀV)        + l1 + l2·Z + ε)
    V ← V ⊙ (Xᵀ U + Y Z) ⊘ (V (UᵀU + ZᵀZ) + l1 + l2·V + ε)

With ``use_pallas`` on dense X the X-dependent part of an iteration is one
call of the fused U pass (``ops/kernels/mu_fused.py``: the CUDA kernel on
the card), which also returns V's X-side terms XᵀU_new and U_newᵀU_new;
those make the eval-point loss free of extra passes over X
(``_aux_loss``). CSR X takes the unfused order, its products through the
BlockEll or CSR kernels (``solvers/common.coupled_mm``), and the same aux
loss. Every ratio tail is the fused MU update kernel under ``use_pallas``
(``ops/kernels/mu_update.py``). A chunked X (``ops/chunked.py``) takes the
single-pass order on any setting: one streamed pass returns U_new and V's
X-side terms (through K1 per chunk under ``use_pallas``), and the aux loss
reads the layout's Σ data².
"""
from __future__ import annotations

import torch

from ..ops.chunked import chunked_mu_u_pass, is_chunked
from ..ops.kernels import mu_fused, mu_update
from ..ops.losses import penalty, reconstruction_term, total_loss
from ..ops.matmul import gram, matmul
from ..ops.sparse import is_sparse
from .common import (Coupled, Hyper, SolverConfig, check_loop, coupled_mm,
                     run_solver_loop)


def mu_ratio_update(M, S, num, l1, l2, eps, use_pallas: bool = False):
    """M ⊙ num ⊘ (M S + l1 + l2·M + ε), the MU tail of every factor; one
    launch of the fused MU update kernel under ``use_pallas``."""
    if use_pallas:
        return mu_update.fused_mu_update(M, S, num, l1, l2, eps)
    return M * num / (matmul(M, S) + l1 + l2 * M + eps)


def _fused(cfg: SolverConfig, X: Coupled, U) -> bool:
    return cfg.use_pallas and cfg.update_U and cfg.update_V \
        and not is_sparse(X.A) and not is_chunked(X.A) \
        and U.dtype != torch.bfloat16


def _chunked(cfg: SolverConfig, X: Coupled) -> bool:
    return is_chunked(X.A) and cfg.update_U and cfg.update_V


def make_mu_step(cfg: SolverConfig, with_aux: bool = False):
    """The MU step for a config.

    with_aux: additionally return (numV_x, gramU) = (XᵀU_new, U_newᵀU_new),
    which the step computes anyway; requires update_U and update_V.
    """
    if with_aux and not (cfg.update_U and cfg.update_V):
        raise ValueError("with_aux requires update_U and update_V")

    up = cfg.use_pallas

    def step(X: Coupled, Y, U, V, Z, hyper: Hyper):
        l1, l2, eps = hyper.l1, hyper.l2, hyper.eps
        if _fused(cfg, X, U) or _chunked(cfg, X):
            # Single U pass (fused kernel, or the chunked stream): U_new
            # plus the X side of V's numerator and Gram, the same values
            # as the U → Z → V order.
            VtV = gram(V)
            if is_chunked(X.A):
                U, num_vx, gram_u = chunked_mu_u_pass(X.A, U, V, VtV, l1,
                                                      l2, eps, up)
            else:
                U, num_vx, gram_u = mu_fused.fused_mu_u_pass(
                    X.A, U, V, VtV, l1, l2, eps)
            if cfg.has_Y and cfg.update_Z:
                num = coupled_mm(Y, V, transpose=True, use_pallas=up)
                Z = mu_ratio_update(Z, VtV, num, l1, l2, eps, up)
            num_v, S = num_vx, gram_u
            if cfg.has_Y:
                num_v = num_v + coupled_mm(Y, Z, use_pallas=up)
                S = S + gram(Z)
            V = mu_ratio_update(V, S, num_v, l1, l2, eps, up)
            if with_aux:
                return U, V, Z, (num_vx, gram_u)
            return U, V, Z

        # V is unchanged between the U and Z updates, so one Gram serves both.
        VtV = gram(V) if (cfg.update_U or (cfg.has_Y and cfg.update_Z)) \
            else None
        if cfg.update_U:
            num = coupled_mm(X, V, use_pallas=up)
            U = mu_ratio_update(U, VtV, num, l1, l2, eps, up)
        if cfg.has_Y and cfg.update_Z:
            num = coupled_mm(Y, V, transpose=True, use_pallas=up)
            Z = mu_ratio_update(Z, VtV, num, l1, l2, eps, up)
        if cfg.update_V:
            num_vx = coupled_mm(X, U, transpose=True, use_pallas=up)
            gram_u = gram(U)
            num, S = num_vx, gram_u
            if cfg.has_Y:
                num = num + coupled_mm(Y, Z, use_pallas=up)
                S = S + gram(Z)
            V = mu_ratio_update(V, S, num, l1, l2, eps, up)
        if with_aux:
            return U, V, Z, (num_vx, gram_u)
        return U, V, Z

    return step


def _aux_loss(cfg: SolverConfig):
    """Loss from the step's aux terms, with no pass over X:
    L_x = ½(‖X‖² − 2·Σ(numV_x ⊙ V) + Σ(gramU ⊙ VᵀV)), numV_x = XᵀU_new
    contracted against V_new; the small Y term is evaluated directly."""

    def loss_fn(state, aux, hyper: Hyper):
        X, Y, U, V, Z = state
        num_vx, gram_u = aux
        # a CSR or chunked X carries its own Σ data²
        a_sq = X.A.sq_norm if is_sparse(X.A) or is_chunked(X.A) else X.a_sq
        inner = (num_vx * V).sum()
        x_term = 0.5 * (a_sq - 2.0 * inner + (gram_u * gram(V)).sum())
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
    """Whether the zero-extra-pass aux loss applies: the kernel branch
    runs with both U and V updated (fresh aux every step), ‖X‖² is known,
    and not the small dense mixed-precision regime where the factored
    identity suffers cancellation (ops/losses.py takes the direct residual
    there). A chunked X computes the aux pair on any setting, and is far
    past that regime by construction."""
    if _chunked(cfg, X):
        return True
    if not (cfg.use_pallas and cfg.update_U and cfg.update_V):
        return False
    if is_sparse(X.A):
        return True
    if X.a_sq is None:
        return False
    if X.A.dtype != U0.dtype and X.A.numel() < (1 << 22):
        return False
    return True


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


def _make_block(cfg: SolverConfig, aux: bool):
    step = make_mu_step(cfg, with_aux=aux)
    loss_fn = _aux_loss(cfg) if aux else _loss_core(cfg)

    def block(state, hyper: Hyper, rng, n_steps: int):
        X, Y, U, V, Z = state
        a = None
        for _ in range(n_steps):
            out = step(X, Y, U, V, Z, hyper)
            if aux:
                U, V, Z, a = out
            else:
                U, V, Z = out
        state = (X, Y, U, V, Z)
        loss = loss_fn(state, a, hyper) if aux else loss_fn(state, hyper)
        return state, loss, rng

    return block


def run_mu(X: Coupled, Y, U0, V0, Z0, cfg: SolverConfig, hyper: Hyper, *,
           max_iter: int = 200, tol: float = 1e-4, eval_every: int = 10,
           verbose: int = 0, loop: str = "host"):
    """Run the MU solver. Returns (U, V, Z, n_iter, loss_history,
    loss_iters, step_times). loop: 'host' runs every block eagerly,
    'device' the device loop (on the card one launch of a cached fit
    graph; see solvers/common.run_device_fit)."""
    check_loop(loop)
    aux = _aux_ok(cfg, X, U0)
    block = _make_block(cfg, aux)
    state = (X, Y, U0, V0, Z0)
    state, n_iter, losses, iters, times = run_solver_loop(
        block, state, hyper, rng=None, max_iter=max_iter, tol=tol,
        eval_every=eval_every, verbose=verbose,
        initial_loss_fn=_loss_core(cfg), loop=loop, key=("mu", cfg, aux))
    _, _, U, V, Z = state
    return U, V, Z, n_iter, losses, iters, times
