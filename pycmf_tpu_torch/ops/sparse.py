"""CSR matrices on the device and their plain PyTorch products.

Counterpart of ``pycmf_tpu/ops/sparse.py``. ``CsrMatrix`` holds the CSR
arrays of a host ``scipy.sparse`` matrix on the device, plus the COO row id
of every nonzero (``row_ids``) and Σ data², cached for the factored losses.
The sparsity pattern is fixed for a fit, so Aᵀ is built once on the host
(:func:`csr_transpose_host`) and Aᵀ B is a forward product over it.

The products here are the plain path (``use_pallas=False``) and the plain
versions the CUDA kernels are held to (``ops/kernels/spmm.py``): a gather of
B's rows, scaled by the values, and a segment sum over each row's nonzeros
(``index_add_``). A bf16 value times a float32 factor widens exactly.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import scipy.sparse as sp
import torch

from .kernels.bell import BlockEll
from .kernels.policy import check_device
from .matmul import matmul


@dataclasses.dataclass(frozen=True)
class CsrMatrix:
    """CSR (+ COO row ids) matrix on one device.

    data    : (nnz,) values at the storage dtype
    indices : (nnz,) int32 column indices, sorted within each row
    indptr  : (p+1,) int32 row pointers
    row_ids : (nnz,) int32 row of each nonzero
    sq_norm : () Σ data², float32 under bf16 data, else the data's dtype
    shape   : (p, q)
    """

    data: torch.Tensor
    indices: torch.Tensor
    indptr: torch.Tensor
    row_ids: torch.Tensor
    sq_norm: torch.Tensor
    shape: Tuple[int, int]

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0])

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    def astype(self, dtype: torch.dtype) -> "CsrMatrix":
        """The same matrix with its values cast to ``dtype``; the index
        arrays are kept as they are. ``sq_norm`` is cast, never summed
        again (a half-precision sum would bias the factored loss): float32
        for a dtype of fewer than 4 bytes, else ``dtype`` (the reference's
        rule, ``pycmf_tpu/ops/sparse.py:CsrMatrix.astype``, which differs
        from :func:`csr_from_scipy`'s bf16-only rule)."""
        sq_dt = torch.float32 if dtype.itemsize < 4 else dtype
        return dataclasses.replace(self, data=self.data.to(dtype),
                                   sq_norm=self.sq_norm.to(sq_dt))


def is_sparse(A) -> bool:
    """Whether A is a sparse layout (CSR or BlockEll), not a dense tensor."""
    return isinstance(A, (CsrMatrix, BlockEll))


def _sq_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float32 if dtype == torch.bfloat16 else dtype


def csr_from_scipy(A, dtype=torch.float32, device="cuda") -> CsrMatrix:
    """A scipy.sparse matrix as a CsrMatrix on ``device`` (built on the
    host, at fit time; the card by default, as the reference's lands on
    its default device). Duplicates are summed first. ``sq_norm`` sums the
    squares of the values as stored (rounded to ``dtype``) in float64,
    then casts."""
    device = check_device(device)
    A = sp.csr_matrix(A)
    A.sum_duplicates()
    data = torch.from_numpy(np.ascontiguousarray(A.data)).to(dtype)
    indptr = np.asarray(A.indptr, dtype=np.int32)
    row_ids = np.repeat(np.arange(A.shape[0], dtype=np.int32),
                        np.diff(indptr))
    sq = torch.sum(data.to(torch.float64) ** 2).to(_sq_dtype(dtype))

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return CsrMatrix(data.to(device), up(A.indices.astype(np.int32)),
                     up(indptr), up(row_ids), sq.to(device),
                     tuple(int(s) for s in A.shape))


def csr_from_dense(A, dtype=torch.float32, device="cuda") -> CsrMatrix:
    """A dense host array as a CsrMatrix, through :func:`csr_from_scipy`."""
    return csr_from_scipy(sp.csr_matrix(np.asarray(A)), dtype, device)


def csr_transpose_host(A, dtype=torch.float32,
                       device="cuda") -> Tuple[CsrMatrix, CsrMatrix]:
    """(csr(A), csr(Aᵀ)) at the same dtype, both built on the host and
    placed on ``device`` (the card by default)."""
    A = sp.csr_matrix(A)
    return (csr_from_scipy(A, dtype, device),
            csr_from_scipy(A.T.tocsr(), dtype, device))


def to_dense(A: CsrMatrix) -> torch.Tensor:
    """The dense (p, q) matrix at the storage dtype (tests, small inputs)."""
    out = torch.zeros(A.shape, dtype=A.dtype, device=A.device)
    return out.index_put_((A.row_ids.long(), A.indices.long()), A.data,
                          accumulate=True)


def _segment_sum(vals: torch.Tensor, A: CsrMatrix) -> torch.Tensor:
    """Per-row sums of per-nonzero ``vals`` ((nnz,) or (nnz, k))."""
    out = vals.new_zeros((A.shape[0],) + tuple(vals.shape[1:]))
    return out.index_add_(0, A.row_ids, vals)


def spmm(A: CsrMatrix, B: torch.Tensor) -> torch.Tensor:
    """A @ B for CSR A (p, q) and dense B (q, k) → (p, k), by gather and
    segment sum; no densification."""
    return _segment_sum(B[A.indices] * A.data[:, None], A)


def nnz_dots(A: CsrMatrix, M: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Mᵢ·Bⱼ at every nonzero (i, j): (nnz,)."""
    return torch.sum(M[A.row_ids] * B[A.indices], dim=1)


def sddmm_rowdots(A: CsrMatrix, M: torch.Tensor,
                  B: torch.Tensor) -> torch.Tensor:
    """Per row Σⱼ aᵢⱼ (Mᵢ·Bⱼ) for CSR A (p, q), M (p, k), B (q, k) → (p,):
    ⟨aᵢ, (M Bᵀ)ᵢ⟩ evaluated at the nonzeros only."""
    return _segment_sum(A.data * nnz_dots(A, M, B), A)


def sddmm_dot(A: CsrMatrix, M: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """⟨A, M Bᵀ⟩ (scalar) without densifying."""
    e = nnz_dots(A, M, B)
    return torch.dot(A.data.to(e.dtype), e)


def row_sq_norms(A: CsrMatrix) -> torch.Tensor:
    """Per-row ‖aᵢ‖² → (p,)."""
    return _segment_sum(A.data * A.data, A)


def masked_row_sq_norms(A, col_mask: torch.Tensor,
                        use_pallas: bool = False) -> torch.Tensor:
    """Per-row Σⱼ maskⱼ·aᵢⱼ² → (p,), squared at the mask's (factor) dtype
    even for bf16 data: a column subsample of stochastic Newton enters
    the line search's row norms as a mask (``solvers/newton.py``).

    Counterpart of ``pycmf_tpu/ops/sparse.py:masked_row_sq_norms``. It is
    the product of A's squared values with the mask, so under
    ``use_pallas`` the CSR kernel (or, for a BlockEll A, ``bell_spmm``)
    takes it: their fixed-order sums repeat bit for bit, where the plain
    segment sum's ``index_add_`` on a card adds in no fixed order."""
    sq = col_mask[:, None]
    if isinstance(A, BlockEll):
        from .kernels import bell as kbell

        A2 = dataclasses.replace(A, blocks=A.blocks.to(col_mask.dtype) ** 2)
        fn = kbell.bell_spmm if use_pallas else kbell.bell_spmm_ref
        return fn(A2, sq)[:, 0]
    A2 = dataclasses.replace(A, data=A.data.to(col_mask.dtype) ** 2)
    return generic_matmul(A2, sq, use_pallas)[:, 0]


def generic_matmul(A, B: torch.Tensor,
                   use_pallas: bool = False) -> torch.Tensor:
    """A @ B for dense or CSR A. Under ``use_pallas`` a CSR A goes through
    the CSR kernel (``ops/kernels/spmm.py``), else the segment sum."""
    if is_sparse(A):
        if use_pallas:
            from .kernels import spmm as kspmm

            return kspmm.csr_spmm(A, B)
        return spmm(A, B)
    return matmul(A, B)
