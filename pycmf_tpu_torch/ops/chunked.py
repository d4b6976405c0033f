"""Streamed chunked-COO layout: a sparse X too big to densify, streamed
through one dense chunk buffer per pass.

Counterpart of ``pycmf_tpu/ops/chunked.py:41-310`` and ``:378-466``. The
reference's sharded stacks (``stack_chunked_blocks``, ``stack_chunked_grid``)
have no counterpart: a sharded fit runs one process per shard, and each
rank builds this layout of its own zero-padded block or cell, with
``chunk_rows`` from the local shape, so every rank has the same chunk
geometry; a shard's padding rows enter the passes as ``n_valid`` or a row
mask (``parallel/sharded.py``, ``parallel/grid.py``). At fit time the
COO nonzeros are sorted by row and split into C chunks of R rows (R chosen
so the R×m chunk fits ``DEFAULT_BUFFER_BYTES``), each padded to a common
count L. Every pass over X is a Python loop over the chunks in chunk
order: scatter the chunk's nonzeros into the layout's one zeroed (R+1, m)
buffer, then run the dense math on its first R rows. X's dense form never
exists on the device: peak memory is the COO arrays (~10 bytes per padded
nonzero) plus one chunk.

The padding differs from the reference's (row 0, col 0, value 0, which
its scatter-add makes a no-op): here a padding entry points at the
buffer's sink row R, which nothing reads, and the scatter overwrites
(``index_put_`` without accumulate). Duplicates are summed on the host, so
every real position is written once: exact values, the same bits on every
run, no host sync, and a CUDA graph captures the scatter.

With ``use_pallas``, :func:`chunked_mu_u_pass` and
:func:`chunked_newton_linear_u_pass` hand each dense chunk to the fused U
passes (K1, K2 of ``ops/kernels``), which return the chunk's U_new and its
share of V's X-side terms; the shares are summed in chunk order. Without
it the chunk body is the reference's formula in plain PyTorch.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Tuple

import numpy as np
import torch

from .kernels import mu_fused, newton_fused
from .kernels.policy import check_device
from .linesearch import backtracking_select
from .matmul import FP8_DTYPES, matmul

# Target size of the dense chunk buffer at the storage dtype. The value is
# the reference's, chosen for a TPU; choosing it for an 80 GB card is
# ROADMAP A7.
DEFAULT_BUFFER_BYTES = 256 << 20


@dataclasses.dataclass(frozen=True)
class ChunkedCoo:
    """Row-chunked COO matrix on one device.

    data    : (C, L) values at the storage dtype
    cols    : (C, L) int32 column indices (padding: column 0)
    rows    : (C, L) int32 row within the chunk, 0..R-1 (padding: R, the
              chunk buffer's sink row)
    sq_norm : () Σ data² of the unrounded values, float32 under bf16 or
              float32 data, else the data's dtype
    shape   : (n, m)
    chunk_rows : R, rows per chunk; C·R ≥ n
    true_nnz   : the true nonzero count
    buffer  : (R+1, m) at the storage dtype, the one chunk buffer every
              pass reuses (made with the layout, before any capture)
    """

    data: torch.Tensor
    cols: torch.Tensor
    rows: torch.Tensor
    sq_norm: torch.Tensor
    shape: Tuple[int, int]
    chunk_rows: int
    true_nnz: int
    buffer: torch.Tensor = dataclasses.field(repr=False, compare=False)

    @property
    def n_chunks(self) -> int:
        return int(self.data.shape[0])

    @property
    def nnz(self) -> int:
        return self.true_nnz

    @property
    def capacity(self) -> int:
        """Stored entries including the per-chunk padding (C·L)."""
        return int(self.data.shape[0] * self.data.shape[1])

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def n_pad(self) -> int:
        return self.n_chunks * self.chunk_rows

    def chunk_valid(self, c: int) -> int:
        """True rows of chunk c (the last chunk's tail rows are padding)."""
        return min(self.chunk_rows, self.shape[0] - c * self.chunk_rows)


@dataclasses.dataclass(frozen=True)
class ChunkedT:
    """A chunked layout consumed as its transpose: a Newton term whose D is
    Xᵀ (the factor's rows see X's columns). No transposed payload exists;
    consumers stream the forward chunks (solvers/newton_chunked.py)."""

    ck: ChunkedCoo


def is_chunked(A) -> bool:
    return isinstance(A, ChunkedCoo)


def pick_chunk_rows(n: int, m: int, itemsize: int = 4) -> int:
    """Rows per chunk: the largest multiple of 128 whose (R, m) buffer at
    ``itemsize`` bytes per entry fits ``DEFAULT_BUFFER_BYTES``, at most n
    rounded up to 128; below 128 rows a multiple of 8, at least 8 (the
    reference's rule)."""
    r = DEFAULT_BUFFER_BYTES // max(1, m * itemsize)
    if r >= 128:
        r = (r // 128) * 128
        n_up = -(-n // 128) * 128
    else:
        r = max(8, (r // 8) * 8)
        n_up = -(-n // 8) * 8
    return int(min(r, n_up))


def chunked_from_scipy(A, dtype=torch.float32, device="cuda", *,
                       chunk_rows: int | None = None) -> ChunkedCoo:
    """A ChunkedCoo of a scipy.sparse matrix on ``device`` (built on the
    host, once per fit; the card by default, as the reference's lands on
    its default device; 'cuda' without a card raises). Duplicates are
    summed; the nonzeros are sorted stably by row and each chunk padded to
    the largest chunk's count L. Warns when the padding makes C·L more
    than 4× the true count (heavily skewed rows)."""
    import scipy.sparse as sp

    if dtype in FP8_DTYPES:
        raise ValueError(
            "fp8 data storage requires dense device form; the chunked "
            "streaming layout stores COO + a transient dense chunk — "
            "use data_dtype='bfloat16' for beyond-threshold X")
    device = check_device(device)
    A = sp.coo_matrix(A)
    A.sum_duplicates()
    n, m = A.shape
    itemsize = torch.empty((), dtype=dtype).element_size()
    R = chunk_rows if chunk_rows is not None else pick_chunk_rows(
        n, m, itemsize)
    C = max(1, -(-n // R))
    order = np.argsort(A.row, kind="stable")
    rows = A.row[order].astype(np.int64)
    cols = A.col[order].astype(np.int32)
    vals = A.data[order]
    chunk = rows // R
    counts = np.bincount(chunk, minlength=C)
    L = max(1, int(counts.max()))
    nnz = int(vals.size)
    if nnz and C * L > 4 * nnz:
        warnings.warn(
            f"chunked-COO padding is {C * L / nnz:.1f}x the true nnz "
            f"({nnz} nonzeros, {C} chunks padded to {L} each): the row "
            "distribution is heavily skewed, and storage AND per-"
            "iteration work scale with the padded count. Consider "
            "shuffling the rows or a different chunk_rows.",
            UserWarning, stacklevel=2)
    start = np.zeros(C + 1, dtype=np.int64)
    np.cumsum(counts, out=start[1:])
    pos = np.arange(nnz, dtype=np.int64) - start[chunk]
    d = np.zeros((C, L), dtype=np.float64)
    cc = np.zeros((C, L), dtype=np.int32)
    rl = np.full((C, L), R, dtype=np.int32)   # padding: the sink row
    d[chunk, pos] = vals
    cc[chunk, pos] = cols
    rl[chunk, pos] = (rows - chunk * R).astype(np.int32)
    sq_dt = torch.float32 if itemsize <= 4 else dtype
    sq64 = np.sum(vals.astype(np.float64) ** 2)
    return ChunkedCoo(
        torch.from_numpy(d).to(dtype).to(device),
        torch.from_numpy(cc).to(device), torch.from_numpy(rl).to(device),
        torch.tensor(sq64, dtype=torch.float64).to(sq_dt).to(device),
        (n, m), R, nnz,
        torch.zeros((R + 1, m), dtype=dtype, device=device))


def _pad_rows(M: torch.Tensor, n_pad: int) -> torch.Tensor:
    n = M.shape[-2]
    if n == n_pad:
        return M
    out = M.new_zeros(M.shape[:-2] + (n_pad, M.shape[-1]))
    out[..., :n, :] = M
    return out


def valid_rows(X: ChunkedCoo, dtype, row_mask=None) -> torch.Tensor:
    """(C, R) 1.0 on true rows, 0.0 on the last chunk's tail rows
    (consumers whose per-row results are not exactly zero there, such as
    σ(0) = ½, mask them out of updates and sums). row_mask: an optional
    (n,) mask of X's rows (a shard's zero-padding rows lie inside its
    layout's n), multiplied in. Reference: ``pycmf_tpu/ops/chunked.py:
    valid_rows``."""
    valid = (torch.arange(X.n_pad, device=X.device) < X.shape[0]).to(dtype)
    if row_mask is not None:
        valid = valid * _pad_rows(row_mask[:, None].to(dtype), X.n_pad)[:, 0]
    return valid.reshape(X.n_chunks, X.chunk_rows)


def _rows_to_update(X: ChunkedCoo, c: int, n_valid=None) -> int:
    """Rows of chunk c that a U pass updates: its true rows, cut at
    ``n_valid`` (a shard's real rows; the rows past it are the shard's
    zero padding) when given."""
    nv = X.chunk_valid(c)
    if n_valid is None:
        return nv
    return max(0, min(nv, int(n_valid) - c * X.chunk_rows))


def densify_chunk(X: ChunkedCoo, c: int) -> torch.Tensor:
    """Chunk c as a dense (R, m) view of the layout's buffer: zeroed, then
    the chunk's nonzeros written in (padding lands on the sink row R). The
    view is valid until the next densify_chunk of the same layout."""
    buf = X.buffer
    buf.zero_()
    buf.index_put_((X.rows[c].long(), X.cols[c].long()), X.data[c])
    return buf[:X.chunk_rows]


def _chunk_rows(M: torch.Tensor, X: ChunkedCoo, c: int) -> torch.Tensor:
    """Rows of chunk c of an (n_pad, ...) tensor."""
    R = X.chunk_rows
    return M[c * R:(c + 1) * R]


def chunked_spmm(X: ChunkedCoo, B: torch.Tensor) -> torch.Tensor:
    """X @ B → (n, k): one streamed pass, a dense product per chunk."""
    k = B.shape[1]
    dt = torch.promote_types(torch.float32 if X.dtype == torch.bfloat16
                             else X.dtype, B.dtype)
    out = torch.empty((X.n_pad, k), dtype=dt, device=B.device)
    for c in range(X.n_chunks):
        _chunk_rows(out, X, c).copy_(matmul(densify_chunk(X, c), B))
    return out[:X.shape[0]]


def chunked_spmm_t(X: ChunkedCoo, M: torch.Tensor) -> torch.Tensor:
    """Xᵀ @ M → (m, k): the chunks' products summed in chunk order."""
    Mp = _pad_rows(M, X.n_pad)
    acc = torch.zeros((X.shape[1], M.shape[1]), dtype=M.dtype,
                      device=M.device)
    for c in range(X.n_chunks):
        acc = acc + matmul(densify_chunk(X, c).mT, _chunk_rows(Mp, X, c))
    return acc


def chunked_masked_row_sq(X: ChunkedCoo, col_mask: torch.Tensor
                          ) -> torch.Tensor:
    """Per-row Σⱼ maskⱼ·xᵢⱼ² → (n,): the sampled Newton term's row norms.
    Squares at the mask's (factor) precision (a bf16 value squares exactly
    in float32), each chunk's as one dense product with the mask: a fixed
    summation order (a scatter-add's atomics would not repeat)."""
    out = torch.empty(X.n_pad, dtype=col_mask.dtype, device=col_mask.device)
    for c in range(X.n_chunks):
        Xc = densify_chunk(X, c).to(col_mask.dtype)
        _chunk_rows(out, X, c).copy_((Xc * Xc) @ col_mask)
    return out[:X.shape[0]]


def chunked_masked_col_sq(X: ChunkedCoo, row_mask: torch.Tensor
                          ) -> torch.Tensor:
    """Per-column Σᵢ maskᵢ·xᵢⱼ² → (m,) for an (n,) row mask (the V side's
    sampled term, whose q axis is X's row axis); summed in chunk order."""
    rm = _pad_rows(row_mask[:, None], X.n_pad)[:, 0]
    acc = torch.zeros(X.shape[1], dtype=row_mask.dtype,
                      device=row_mask.device)
    for c in range(X.n_chunks):
        Xc = densify_chunk(X, c).to(row_mask.dtype)
        acc = acc + (Xc * Xc).mT @ _chunk_rows(rm, X, c)
    return acc


def chunked_inner(X: ChunkedCoo, M: torch.Tensor, B: torch.Tensor
                  ) -> torch.Tensor:
    """⟨X, M Bᵀ⟩ = Σ((X @ B) ⊙ M): streamed, summed in chunk order."""
    Mp = _pad_rows(M, X.n_pad)
    acc = torch.zeros((), dtype=M.dtype, device=M.device)
    for c in range(X.n_chunks):
        acc = acc + torch.sum(matmul(densify_chunk(X, c), B)
                              * _chunk_rows(Mp, X, c))
    return acc


def chunked_mu_u_pass(X: ChunkedCoo, U, V, VtV, l1, l2, eps,
                      use_pallas: bool = False, n_valid=None):
    """One streamed MU leg: U_new and V's X-side terms in one pass over X
    (the fused U pass's contract, solvers/mu.py):

        U_c   ← U_c ⊙ (X_c V) ⊘ (U_c VᵀV + l1 + l2·U_c + ε)   per chunk
        numV  = Σ_c X_cᵀ U_c_new,   gramU = Σ_c U_c_newᵀ U_c_new

    Padding rows are exact zeros (the ratio alone gives 0/0 = NaN when
    l1 = ε = 0): the last chunk's tail rows, and with ``n_valid`` every
    row from it on (a rows shard's zero padding, the reference's
    ``row_mask``). With ``use_pallas`` each chunk is one call of
    ``fused_mu_u_pass`` (K1), its padding rows cut by K1's ``n_valid``;
    a chunk with no row to update launches nothing. Returns (U_new (n,
    k), numV, gramU); reference ``pycmf_tpu/ops/chunked.py:427-466``."""
    n, m = X.shape
    k = U.shape[1]
    Up = _pad_rows(U, X.n_pad)
    out = torch.empty((X.n_pad, k), dtype=U.dtype, device=U.device)
    numV = torch.zeros((m, k), dtype=U.dtype, device=U.device)
    gramU = torch.zeros((k, k), dtype=U.dtype, device=U.device)
    for c in range(X.n_chunks):
        nv = _rows_to_update(X, c, n_valid)
        if nv == 0:
            _chunk_rows(out, X, c).zero_()
            continue
        Xc, uc = densify_chunk(X, c), _chunk_rows(Up, X, c)
        if use_pallas:
            u_new, nv_c, g_c = mu_fused.fused_mu_u_pass(Xc, uc, V, VtV, l1,
                                                        l2, eps, n_valid=nv)
        else:
            u_new = uc * matmul(Xc, V) / (matmul(uc, VtV) + l1 + l2 * uc
                                          + eps)
            if nv < X.chunk_rows:
                u_new[nv:] = 0.0
            nv_c, g_c = matmul(Xc.mT, u_new), u_new.mT @ u_new
        _chunk_rows(out, X, c).copy_(u_new)
        numV = numV + nv_c
        gramU = gramU + g_c
    return out[:n], numV, gramU


def chunked_newton_linear_u_pass(X: ChunkedCoo, U, V, BtB, Hinv, row_sq, l1,
                                 l2, *, trials: int, non_negative: bool,
                                 use_pallas: bool = False, n_valid=None):
    """One streamed Newton U leg (linear link, full batch, Gauss-Newton):
    per chunk the fused Newton U pass's contract (shared H = BtB +
    (l2 + pert)·I with Hinv precomputed, per-row backtracking on φ,
    projection before φ), and V's X-side XᵀU_new and U_newᵀU_new summed
    in chunk order. With ``use_pallas`` each chunk is one call of
    ``fused_newton_linear_u_pass`` (K2); a padding row (zero data, zero U,
    zero norm) takes a zero step there and stays zero. ``n_valid``: a rows
    shard's real rows; the rows from it on are set to exact zeros after
    each chunk's update (they are zero already: the shard's padding), and
    a chunk with no row to update launches nothing. Returns (U_new (n,
    k), numV, gramU); reference ``pycmf_tpu/ops/chunked.py:378-424``."""
    n, m = X.shape
    k = U.shape[1]
    Up = _pad_rows(U, X.n_pad)
    rs = _pad_rows(row_sq[:, None].to(U.dtype), X.n_pad)[:, 0]
    out = torch.empty((X.n_pad, k), dtype=U.dtype, device=U.device)
    numV = torch.zeros((m, k), dtype=U.dtype, device=U.device)
    gramU = torch.zeros((k, k), dtype=U.dtype, device=U.device)

    def project(Mc):
        return torch.clamp_min(Mc, 0.0) if non_negative else Mc

    for c in range(X.n_chunks):
        nv = _rows_to_update(X, c, n_valid)
        if nv == 0:
            _chunk_rows(out, X, c).zero_()
            continue
        Xc, uc, rsc = (densify_chunk(X, c), _chunk_rows(Up, X, c),
                       _chunk_rows(rs, X, c))
        if use_pallas:
            u_new, nv_c, g_c = newton_fused.fused_newton_linear_u_pass(
                Xc, uc, V, BtB, Hinv, rsc, l1, l2, trials=trials,
                non_negative=non_negative)
        else:
            DB = matmul(Xc, V)
            G = matmul(uc, BtB) - DB + l1 * torch.sign(uc) + l2 * uc
            d = matmul(G, Hinv)   # Hinv symmetric: (H⁻¹ Gᵀ)ᵀ = G H⁻¹

            def phi(Mc, DB=DB, rsc=rsc):
                quad = torch.sum(matmul(Mc, BtB) * Mc, dim=-1)
                res = 0.5 * (rsc - 2.0 * torch.sum(DB * Mc, dim=-1) + quad)
                return res + l1 * torch.sum(torch.abs(Mc), dim=-1) \
                    + 0.5 * l2 * torch.sum(Mc * Mc, dim=-1)

            u_new = backtracking_select(phi, project, uc, d, trials)
            nv_c, g_c = matmul(Xc.mT, u_new), u_new.mT @ u_new
        if n_valid is not None and nv < X.chunk_rows:
            u_new[nv:] = 0.0   # the shard's padding: zero rows already
        _chunk_rows(out, X, c).copy_(u_new)
        numV = numV + nv_c
        gramU = gramU + g_c
    return out[:n], numV, gramU
