"""CMF objective evaluation (dense, CSR and chunked-COO data).

Counterpart of ``pycmf_tpu/ops/losses.py``:

    L(U,V,Z) = ½‖X − f_x(U Vᵀ)‖²_F + ½‖Y − f_y(V Zᵀ)‖²_F + R(U)+R(V)+R(Z)
    R(M)     = alpha · (l1_ratio·‖M‖₁ + ½(1−l1_ratio)·‖M‖²_F)

Linear terms use the factored identity
‖A − M Bᵀ‖² = ‖A‖² − 2⟨A, M Bᵀ⟩ + tr((MᵀM)(BᵀB)), except for small
mixed-precision dense problems, which take the direct residual (see
``_linear_term``); for CSR A the inner product is taken at the nonzeros
only, and for a chunked A by one streamed pass. Sigmoid terms need the
elementwise link, so they stream over row blocks of the product when it is
large (dense A), over the chunks (chunked A, padding rows masked), or take
Σσ² in row blocks plus a sum over the nonzeros (CSR A).
"""
from __future__ import annotations

import torch

from .chunked import _chunk_rows, _pad_rows, chunked_inner, densify_chunk, \
    is_chunked
from .kernels import bell as kbell
from .kernels import spmm as kspmm
from .links import LINEAR
from .matmul import gram, matmul
from .sparse import is_sparse, sddmm_dot

# Above this many elements, direct residuals, sigmoid terms and the plain
# sigmoid Newton passes (ops/kernels/sigmoid_newton.py) stream over row
# blocks.
_BLOCK_ELEMS = 1 << 24


def penalty(M: torch.Tensor, alpha, l1_ratio) -> torch.Tensor:
    """R(M), the sklearn-NMF-style elastic-net penalty."""
    l1 = alpha * l1_ratio
    l2 = alpha * (1.0 - l1_ratio)
    return l1 * torch.sum(torch.abs(M)) + 0.5 * l2 * torch.sum(M * M)


def _linear_term(A, M: torch.Tensor, B: torch.Tensor, a_sq=None,
                 bell_t=None, use_pallas: bool = False) -> torch.Tensor:
    """½‖A − M Bᵀ‖² via the factored identity, A dense or CSR.

    For CSR A, ‖A‖² is A.sq_norm and ⟨A, M Bᵀ⟩ is taken at the nonzeros:
    under ``use_pallas`` as Σ((AᵀM)⊙B) over ``bell_t`` (the BlockEll
    layout of Aᵀ) when there is one, else by the CSR row-dot kernel; without
    it by the plain gather."""
    cross = torch.sum(gram(M) * gram(B))
    if is_chunked(A):
        # ‖A‖² cached at ingest; the inner product is one streamed pass
        return 0.5 * (A.sq_norm.to(M.dtype) - 2.0 * chunked_inner(A, M, B)
                      + cross)
    if is_sparse(A):
        if use_pallas and bell_t is not None:
            inner = kbell.bell_inner(bell_t, M, B)
        elif use_pallas:
            inner = torch.sum(kspmm.csr_rowdots(A, M, B))
        else:
            inner = sddmm_dot(A, M, B)
        return 0.5 * (A.sq_norm - 2.0 * inner + cross)
    if A.dtype != M.dtype and A.numel() < (1 << 22):
        # Mixed precision (bf16- or fp8-stored data), small problem: the
        # factored identity suffers cancellation (‖A‖², ⟨A, MBᵀ⟩ and the
        # cross term are each ≫ the residual near convergence, and with
        # few products the quantization noise does not average out), so
        # evaluate the residual directly. At large sizes the identity is
        # safe: a_sq is precomputed exactly and the bf16 inner product's
        # random error averages down as 1/√(n·m).
        return _linear_term_direct(A, M, B)
    if a_sq is None:
        a_sq = _row_blocks_sum(A, M, lambda Ab, Mb: torch.sum(
            Ab.to(M.dtype) ** 2))
    # the product at the data's precision (B rounded to bf16 under bf16 or
    # fp8 data), as the reference's single-device term takes it
    inner = _row_blocks_sum(A, M, lambda Ab, Mb: torch.sum(
        matmul(Ab, B) * Mb))
    return 0.5 * (a_sq - 2.0 * inner + cross)


def streamed_inner(A: torch.Tensor, M: torch.Tensor,
                   B: torch.Tensor) -> torch.Tensor:
    """⟨A, M Bᵀ⟩ = Σ((A B) ⊙ M) at M's precision for dense A: a block of A
    stored below it (bf16 or fp8) is upcast to M's dtype before the
    product, so B is not rounded. The sharded losses' inner (the
    reference's ``streamed_inner``): the factored identity cancels large
    terms, and a bf16 product's rounding of B would bias it at any size.
    Over row blocks when A is stored below M's dtype."""
    return _row_blocks_sum(A, M, lambda Ab, Mb: torch.sum(
        matmul(Ab.to(Mb.dtype), B) * Mb))


def _row_blocks_sum(A, M: torch.Tensor, fn) -> torch.Tensor:
    """Σ fn(A_b, M_b) over row blocks b of _BLOCK_ELEMS when A is stored
    below M's dtype (bf16 or fp8 data), else fn(A, M): what fn upcasts is
    one block of A, never a whole-matrix float32 copy (the reference's
    streamed_inner)."""
    p, q = A.shape
    if A.dtype == M.dtype or p * q <= _BLOCK_ELEMS:
        return fn(A, M)
    bs = rows_per_block(q)
    total = torch.zeros((), dtype=M.dtype, device=M.device)
    for i in range(0, p, bs):
        total = total + fn(A[i:i + bs], M[i:i + bs])
    return total


def _linear_term_direct(A: torch.Tensor, M: torch.Tensor,
                        B: torch.Tensor) -> torch.Tensor:
    """½‖A − M Bᵀ‖² by direct residual, over row blocks of _BLOCK_ELEMS."""
    p, q = A.shape
    bs = max(1, _BLOCK_ELEMS // q) if p * q > _BLOCK_ELEMS else p
    total = torch.zeros((), dtype=M.dtype, device=M.device)
    for i in range(0, p, bs):
        r = A[i:i + bs].to(M.dtype) - matmul(M[i:i + bs], B.mT)
        total = total + 0.5 * torch.sum(r * r)
    return total


def rows_per_block(width: int) -> int:
    """Rows of a (rows, width) intermediate that fit _BLOCK_ELEMS."""
    return max(1, _BLOCK_ELEMS // max(1, width))


def sigmoid_sq_rows(D, Mc, B, mask=None):
    """½‖dᵢ − σ(B cᵢ)‖² for every row of Mc (..., p, k): (..., p); with a
    (q,) column ``mask``, ½Σⱼ maskⱼ (dᵢⱼ − σ(bⱼ·cᵢ))².

    Leading (candidate) axes are evaluated in one batched product while
    the residual fits ``_BLOCK_ELEMS``; past that, candidate by candidate
    over row blocks."""
    lead, (p, k) = Mc.shape[:-2], Mc.shape[-2:]
    q = B.shape[0]
    C = Mc.reshape(-1, p, k)
    Bf = B.to(Mc.dtype)

    def half_sq(R):
        return 0.5 * torch.sum(R * R if mask is None else R * R * mask,
                               dim=-1)

    if C.shape[0] * p * q <= _BLOCK_ELEMS:
        R = D.to(Mc.dtype) - torch.sigmoid(C @ Bf.mT)
        return half_sq(R).reshape(*lead, p)
    out = Mc.new_empty((C.shape[0], p))
    bs = rows_per_block(q)
    for c in range(C.shape[0]):
        for i in range(0, p, bs):
            R = D[i:i + bs].to(Mc.dtype) - torch.sigmoid(C[c, i:i + bs] @ Bf.mT)
            out[c, i:i + bs] = half_sq(R)
    return out.reshape(*lead, p)


def _sigmoid_sq_sum(M: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Σᵢⱼ σ(M Bᵀ)ᵢⱼ², over row blocks of _BLOCK_ELEMS."""
    bs = rows_per_block(B.shape[0])
    total = torch.zeros((), dtype=M.dtype, device=M.device)
    Bf = B.to(M.dtype)
    for i in range(0, M.shape[0], bs):
        s = torch.sigmoid(M[i:i + bs] @ Bf.mT)
        total = total + torch.sum(s * s)
    return total


def _sigmoid_term(A, M: torch.Tensor, B: torch.Tensor, row_mask=None,
                  col_mask=None) -> torch.Tensor:
    """½‖A − σ(M Bᵀ)‖² for dense, chunked or CSR A.

    Chunked A: one streamed pass, the sum of :func:`sigmoid_sq_rows` over
    each chunk's true rows (a padding row's σ(0) = ½ is not data), each
    row weighted by ``row_mask`` and each column by ``col_mask`` when
    given (a shard's or cell's zero-padding rows and columns; chunked A
    only, as in the reference). CSR A: ‖A − S‖² = ΣS² + Σ_nnz (a² − 2a·S)
    with S = σ(M Bᵀ); only ΣS² needs the dense product, in row blocks (the
    reference's form, ``pycmf_tpu/ops/losses.py:178-231``)."""
    if is_chunked(A):
        Mp = _pad_rows(M, A.n_pad)
        rm = (None if row_mask is None
              else _pad_rows(row_mask[:, None].to(M.dtype), A.n_pad)[:, 0])
        total = torch.zeros((), dtype=M.dtype, device=M.device)
        for c in range(A.n_chunks):
            rows = sigmoid_sq_rows(densify_chunk(A, c), _chunk_rows(Mp, A, c),
                                   B, col_mask)
            if rm is not None:
                rows = rows * _chunk_rows(rm, A, c)
            total = total + torch.sum(rows[:A.chunk_valid(c)])
        return total
    if row_mask is not None or col_mask is not None:
        raise ValueError("row_mask and col_mask are for chunked A only")
    if isinstance(A, kbell.BlockEll):
        raise NotImplementedError(
            "sigmoid-link terms need dense data, CSR or a chunked layout, "
            "not a BlockEll layout")
    if is_sparse(A):
        e = torch.sum(M[A.row_ids.long()] * B.to(M.dtype)[A.indices.long()],
                      dim=1)
        nnz_part = A.sq_norm.to(M.dtype) - 2.0 * torch.dot(
            A.data.to(M.dtype), torch.sigmoid(e))
        return 0.5 * (_sigmoid_sq_sum(M, B) + nnz_part)
    return torch.sum(sigmoid_sq_rows(A, M, B))


def reconstruction_term(A, M: torch.Tensor, B: torch.Tensor, link: str,
                        a_sq=None, bell_t=None, use_pallas: bool = False,
                        row_mask=None, col_mask=None) -> torch.Tensor:
    """½‖A − f(M Bᵀ)‖²_F for one coupled matrix (dense, CSR or chunked;
    see :func:`_linear_term` for ``bell_t`` and ``use_pallas``, and
    :func:`_sigmoid_term` for the masks of a chunked sigmoid term)."""
    if link == LINEAR:
        return _linear_term(A, M, B, a_sq, bell_t, use_pallas)
    return _sigmoid_term(A, M, B, row_mask, col_mask)


def total_loss(X, Y, U, V, Z, x_link: str, y_link: str, alpha, l1_ratio,
               x_a_sq=None, y_a_sq=None, x_bell_t=None, y_bell_t=None,
               use_pallas: bool = False) -> torch.Tensor:
    """Full CMF objective L(U, V, Z). Y may be None (single matrix / NMF).
    x_bell_t / y_bell_t: BlockEll layouts of Xᵀ / Yᵀ, used under
    ``use_pallas``."""
    loss = reconstruction_term(X, U, V, x_link, x_a_sq, x_bell_t, use_pallas)
    loss = loss + penalty(U, alpha, l1_ratio) + penalty(V, alpha, l1_ratio)
    if Y is not None:
        loss = loss + reconstruction_term(Y, V, Z, y_link, y_a_sq, y_bell_t,
                                          use_pallas)
        loss = loss + penalty(Z, alpha, l1_ratio)
    return loss


def reconstruction_rmse(A, M: torch.Tensor, B: torch.Tensor, link: str,
                        use_pallas=None) -> torch.Tensor:
    """RMSE of A − f(M Bᵀ) over all p·q entries, √(2·reconstruction_term
    / (p·q)): the reference's benchmark parity metric
    (``pycmf_tpu/ops/losses.py:reconstruction_rmse``), for dense, CSR,
    chunked or (linear link) BlockEll A at any storage dtype.

    ``use_pallas`` None resolves by device, as the estimator does: CUDA
    factors take the kernels (a linear-link CSR A ``csr_rowdots``), CPU
    factors the plain route. A BlockEll A, a layout of the kernel route
    only, takes ``bell_inner`` (``bell_spmm``) on either device."""
    p, q = A.shape
    if use_pallas is None:
        use_pallas = M.is_cuda
    if isinstance(A, kbell.BlockEll) and link == LINEAR:
        # A is the transposed layout of the term Aᵀ ≈ B Mᵀ:
        # ⟨A, M Bᵀ⟩ = Σ((A B) ⊙ M) = bell_inner(A, B, M)
        term = _linear_term(A, B, M, bell_t=A, use_pallas=True)
    else:
        term = reconstruction_term(A, M, B, link, use_pallas=use_pallas)
    return torch.sqrt(2.0 * term / (p * q))
