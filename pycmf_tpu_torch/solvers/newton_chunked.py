"""Streamed chunked-COO sigmoid-link Newton (the layout of ops/chunked.py).

Counterpart of ``pycmf_tpu/solvers/newton_chunked.py`` (all of it): a
sigmoid-linked sparse X too big to densify gets a Newton path, because the
update materializes dense sigmoid predictions only one row chunk at a time.
Two shapes of work, both streaming the same row chunks in chunk order:

- **Row-local update** (U, and the fold-in of ``transform``): a row's
  Newton update needs only that row of X. Per chunk: densify once, build
  g and the per-row H, solve, line search. Under ``use_pallas``, in the
  Gauss-Newton form with no column mask, the chunk goes through the dense
  path's :func:`~pycmf_tpu_torch.solvers.newton.fused_sigmoid_update`
  (K3, K5, K4 and the selection), whose contract is the plain chunk
  body's; otherwise the plain body, with the solve through
  ``_solve_direction`` (K5 or the LU route under ``use_pallas``).
- **Column-side terms** (V's X term, Z's term on a chunked sigmoid Y):
  the per-row G and H of the factor whose rows index X's columns
  accumulate over the chunks, and the line-search objective of every
  candidate accumulates in one more pass; ``newton_update_factor``
  consumes them through the ``ChunkedT`` marker.

The per-row Hessians of a chunk are ``W @ BB`` (``BB_j = vec(b_j b_jᵀ)``),
as ``sigmoid_newton.sigmoid_gh_rows`` builds them, never a (p, q, k)
intermediate, and each chunk is taken in row blocks of
``losses.rows_per_block`` so that no (rows, m) float32 intermediate
outgrows the dense sigmoid path's. Factor math is in the factors' dtype
(true float32 on the card, no TF32).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..ops import losses
from ..ops.chunked import (ChunkedCoo, _chunk_rows, _pad_rows,
                           densify_chunk, valid_rows)
from ..ops.kernels.sigmoid_newton import sigmoid_gh_rows
from ..ops.linesearch import backtracking_select
from ..ops.matmul import matmul


def _sigmoid_parts(Xc, Mc, B, hessian_form: str):
    """Per-row-block R⊙f′ and W of the term Xc ≈ σ(Mc Bᵀ), at the factors'
    precision (the dense path's formulas)."""
    P = torch.sigmoid(Mc @ B.to(Mc.dtype).mT)
    R = P - Xc.to(P.dtype)
    fp = P * (1.0 - P)
    W = fp * fp
    if hessian_form == "full":
        W = W + R * (fp * (1.0 - 2.0 * P))
    return R * fp, W


def _blocks(rows: int, width: int):
    """Row blocks of a (rows, width) chunk that fit losses._BLOCK_ELEMS."""
    bs = losses.rows_per_block(width)
    return [(i, min(i + bs, rows)) for i in range(0, rows, bs)]


def chunked_sigmoid_row_update(X: ChunkedCoo, M, B, hyper, *, trials: int,
                               non_negative: bool, hessian_form: str,
                               use_pallas: bool, row_mask=None,
                               col_mask=None):
    """Row-local streamed Newton update of M (n, k) against X ≈ σ(M Bᵀ):
    each chunk densified once and updated as dense rows (module
    docstring). Tail rows of the last chunk are dropped. row_mask: an
    optional (n,) 0/1 mask of M's rows (a rows shard's zero padding,
    whose σ(0) = ½ residuals give nonzero steps): the rows it zeroes come
    out exact zeros. col_mask: an optional (m,) 0/1 column mask, the
    sampled term's draw, applied to g, H and φ as the dense masked sigmoid
    term applies it. Reference: ``pycmf_tpu/solvers/newton_chunked.py:
    55-114``."""
    from .newton import _solve_direction, fused_sigmoid_update

    n = X.shape[0]
    k = M.shape[1]
    l1, l2 = hyper.l1, hyper.l2
    H_shared = (l2 + hyper.hessian_pertubation) * torch.eye(
        k, dtype=M.dtype, device=M.device)
    Mp = _pad_rows(M, X.n_pad)
    rm = (None if row_mask is None
          else _pad_rows(row_mask[:, None].to(M.dtype), X.n_pad)[:, 0])
    out = torch.empty((n, k), dtype=M.dtype, device=M.device)
    fused = use_pallas and hessian_form == "gauss" and col_mask is None

    def project(Mc):
        return torch.clamp_min(Mc, 0.0) if non_negative else Mc

    for c in range(X.n_chunks):
        Xc, mc = densify_chunk(X, c), _chunk_rows(Mp, X, c)
        nv = X.chunk_valid(c)
        rc = None if rm is None else _chunk_rows(rm, X, c)
        if fused:
            m_new = fused_sigmoid_update(mc, Xc, B, hyper, trials=trials,
                                         non_negative=non_negative,
                                         use_pallas=True, row_mask=rc)
        else:
            G, H_rows = sigmoid_gh_rows(Xc, mc, B, hessian_form, col_mask)
            G = G + l1 * torch.sign(mc) + l2 * mc
            d = _solve_direction(H_shared, H_rows, G, use_pallas,
                                 spd=hessian_form == "gauss")

            def phi(Mc, Xc=Xc):
                return (l1 * torch.sum(torch.abs(Mc), dim=-1)
                        + 0.5 * l2 * torch.sum(Mc * Mc, dim=-1)
                        + losses.sigmoid_sq_rows(Xc, Mc, B, col_mask))

            m_new = backtracking_select(phi, project, mc, d, trials)
            if rc is not None:
                m_new = torch.where(rc[:, None] > 0.5, m_new, 0.0)
        out[c * X.chunk_rows:c * X.chunk_rows + nv] = m_new[:nv]
    return out


class ChunkedTSigCtx(NamedTuple):
    """Line-search context of a ChunkedT sigmoid term (φ streams the
    chunks; see newton._phi_term). B: the (n, k) row-side factor, chunked
    with X; mask: an optional (n,) 0/1 mask on the term's q axis (X's
    rows), the sampled draw."""
    ck: ChunkedCoo
    B: torch.Tensor
    mask: Optional[torch.Tensor] = None


class ChunkedSigRowCtx(NamedTuple):
    """Line-search context of a forward chunked sigmoid term (M's rows are
    X's rows: V against a chunked sigmoid Y); φ streams the chunks. B: the
    (m, k) column-side factor; mask: an optional (m,) column mask."""
    ck: ChunkedCoo
    B: torch.Tensor
    mask: Optional[torch.Tensor] = None


def chunked_sigmoid_rowwise_terms(X: ChunkedCoo, M, B, hessian_form: str,
                                  mask=None):
    """(G (p, k), H_rows (p, k, k)) of M (p, k) for the term X ≈ σ(M Bᵀ)
    with X chunked along M's rows, without penalties: per chunk the dense
    formulas (``sigmoid_gh_rows``), stacked back. mask: an optional (q,)
    column mask. Reference: ``pycmf_tpu/solvers/newton_chunked.py:
    136-168``."""
    p = X.shape[0]
    k = M.shape[1]
    Mp = _pad_rows(M, X.n_pad)
    G = torch.empty((p, k), dtype=M.dtype, device=M.device)
    H = torch.empty((p, k, k), dtype=M.dtype, device=M.device)
    for c in range(X.n_chunks):
        Gc, Hc = sigmoid_gh_rows(densify_chunk(X, c), _chunk_rows(Mp, X, c),
                                 B, hessian_form, mask)
        lo, nv = c * X.chunk_rows, X.chunk_valid(c)
        G[lo:lo + nv], H[lo:lo + nv] = Gc[:nv], Hc[:nv]
    return G, H


def chunked_sigmoid_rowwise_phi(ctx: ChunkedSigRowCtx, Mc) -> torch.Tensor:
    """Per-row ½‖xᵢ − σ(B mᵢ)‖² (column-masked) of candidates Mc (..., p,
    k), streamed over X's row chunks, every candidate per chunk."""
    X = ctx.ck
    lead, (p, k) = Mc.shape[:-2], Mc.shape[-2:]
    Mp = _pad_rows(Mc, X.n_pad)
    out = Mc.new_empty(lead + (p,))
    for c in range(X.n_chunks):
        Xc = densify_chunk(X, c)
        lo, nv = c * X.chunk_rows, X.chunk_valid(c)
        rows = losses.sigmoid_sq_rows(
            Xc, Mp[..., lo:lo + X.chunk_rows, :], ctx.B, ctx.mask)
        out[..., lo:lo + nv] = rows[..., :nv]
    return out


def chunked_sigmoid_colwise_terms(X: ChunkedCoo, M, B, hessian_form: str,
                                  col_mask=None):
    """(G (m, k), H_rows (m, k, k)) of M (m, k) for the term Xᵀ ≈ σ(M Bᵀ),
    accumulated over X's row chunks in chunk order (X's rows are the
    term's q axis; B, (n, k), is chunked with X). Padding rows are masked
    out of both sums (σ(0) = ½ there), and so are the rows ``col_mask``
    (an optional (n,) 0/1 draw) leaves out. Reference:
    ``pycmf_tpu/solvers/newton_chunked.py:191-223``."""
    m = X.shape[1]
    k = M.shape[1]
    Bp = _pad_rows(B.to(M.dtype), X.n_pad)
    vp = valid_rows(X, M.dtype).reshape(-1)
    if col_mask is not None:
        vp = vp * _pad_rows(col_mask[:, None].to(M.dtype), X.n_pad)[:, 0]
    G = torch.zeros((m, k), dtype=M.dtype, device=M.device)
    H = torch.zeros((m, k * k), dtype=M.dtype, device=M.device)
    for c in range(X.n_chunks):
        Xc = densify_chunk(X, c)
        bc, vc = _chunk_rows(Bp, X, c), _chunk_rows(vp, X, c)
        for i, j in _blocks(X.chunk_rows, m):
            # the (rows, m) block of σ(B Mᵀ) = σ(M Bᵀ)ᵀ
            Rfp, W = _sigmoid_parts(Xc[i:j], bc[i:j], M, hessian_form)
            w = vc[i:j, None]
            BB = (bc[i:j, :, None] * bc[i:j, None, :]).reshape(j - i, k * k)
            G = G + (Rfp * w).mT @ bc[i:j]
            H = H + matmul((W * w).mT, BB, precision="highest")
    return G, H.reshape(m, k, k)


def chunked_sigmoid_colwise_phi(ctx: ChunkedTSigCtx, Mc) -> torch.Tensor:
    """Per-row ½‖(Xᵀ)ⱼ − σ(B mⱼ)‖² of candidates Mc (..., m, k), summed
    over X's row chunks in chunk order, every candidate per row block at
    once (one densify per chunk; the candidates' residuals are T times a
    block's); padding rows and the rows the draw leaves out are
    masked."""
    X = ctx.ck
    lead, (m, k) = Mc.shape[:-2], Mc.shape[-2:]
    C = Mc.reshape(-1, m, k)
    Bp = _pad_rows(ctx.B.to(Mc.dtype), X.n_pad)
    vp = valid_rows(X, Mc.dtype).reshape(-1)
    if ctx.mask is not None:
        vp = vp * _pad_rows(ctx.mask[:, None].to(Mc.dtype), X.n_pad)[:, 0]
    acc = Mc.new_zeros((C.shape[0], m))
    for c in range(X.n_chunks):
        Xc = densify_chunk(X, c)
        bc, vc = _chunk_rows(Bp, X, c), _chunk_rows(vp, X, c)
        for i, j in _blocks(X.chunk_rows, m):
            # every candidate of the row block at once: (T, rows, m)
            r = Xc[i:j].to(Mc.dtype) - torch.sigmoid(bc[i:j] @ C.mT)
            acc = acc + 0.5 * (vc[i:j, None] * r * r).sum(dim=1)
    return acc.reshape(lead + (m,))
