"""CMF objective evaluation (dense, linear links).

Counterpart of the dense linear parts of ``pycmf_tpu/ops/losses.py``:

    L(U,V,Z) = ½‖X − U Vᵀ‖²_F + ½‖Y − V Zᵀ‖²_F + R(U) + R(V) + R(Z)
    R(M)     = alpha · (l1_ratio·‖M‖₁ + ½(1−l1_ratio)·‖M‖²_F)

Linear terms use the factored identity
‖A − M Bᵀ‖² = ‖A‖² − 2⟨A, M Bᵀ⟩ + tr((MᵀM)(BᵀB)), except for small
mixed-precision problems, which take the direct residual (see
``_linear_term``). Sigmoid links are the next slice (ROADMAP A3).
"""
from __future__ import annotations

import torch

from .links import LINEAR
from .matmul import gram, matmul

# Above this many elements, the direct residual streams over row blocks.
_BLOCK_ELEMS = 1 << 24


def penalty(M: torch.Tensor, alpha, l1_ratio) -> torch.Tensor:
    """R(M), the sklearn-NMF-style elastic-net penalty."""
    l1 = alpha * l1_ratio
    l2 = alpha * (1.0 - l1_ratio)
    return l1 * torch.sum(torch.abs(M)) + 0.5 * l2 * torch.sum(M * M)


def _linear_term(A: torch.Tensor, M: torch.Tensor, B: torch.Tensor,
                 a_sq=None) -> torch.Tensor:
    """½‖A − M Bᵀ‖² for dense A via the factored identity."""
    cross = torch.sum(gram(M) * gram(B))
    if A.dtype != M.dtype and A.numel() < (1 << 22):
        # Mixed precision (bf16-stored data), small problem: the factored
        # identity suffers cancellation (‖A‖², ⟨A, MBᵀ⟩ and the cross term
        # are each ≫ the residual near convergence, and with few products
        # the quantization noise does not average out), so evaluate the
        # residual directly. At large sizes the identity is safe: a_sq is
        # precomputed exactly and the bf16 inner product's random error
        # averages down as 1/√(n·m).
        return _linear_term_direct(A, M, B)
    if a_sq is None:
        Af = A.to(M.dtype)
        a_sq = torch.sum(Af * Af)
    inner = torch.sum(matmul(A, B) * M)
    return 0.5 * (a_sq - 2.0 * inner + cross)


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


def reconstruction_term(A, M: torch.Tensor, B: torch.Tensor, link: str,
                        a_sq=None) -> torch.Tensor:
    """½‖A − f(M Bᵀ)‖²_F for one coupled dense matrix."""
    if link != LINEAR:
        raise NotImplementedError(
            "sigmoid links are not ported yet (ROADMAP A3: sigmoid Newton "
            "with kernels K3-K5)")
    return _linear_term(A, M, B, a_sq)


def total_loss(X, Y, U, V, Z, x_link: str, y_link: str, alpha, l1_ratio,
               x_a_sq=None, y_a_sq=None) -> torch.Tensor:
    """Full CMF objective L(U, V, Z). Y may be None (single matrix / NMF)."""
    loss = reconstruction_term(X, U, V, x_link, x_a_sq)
    loss = loss + penalty(U, alpha, l1_ratio) + penalty(V, alpha, l1_ratio)
    if Y is not None:
        loss = loss + reconstruction_term(Y, V, Z, y_link, y_a_sq)
        loss = loss + penalty(Z, alpha, l1_ratio)
    return loss
