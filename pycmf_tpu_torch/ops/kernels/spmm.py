"""CSR products: the CUDA kernels' wrappers and their plain PyTorch versions.

One row-gather kernel (``csrc/csr_spmm.cu``) serves the contracts of four
TPU kernels of ``pycmf_tpu/ops/pallas/``:

- ``csr_spmm(A, B)`` = A @ B: ``onehot.py:onehot_spmm`` and
  ``spmm.py:spmm_tiled``; on the CSR of Aᵀ (``Coupled.At``, built once per
  fit) it is Aᵀ @ B, the contract of ``onehot.py:onehot_spmm_t``;
- ``csr_rowdots(A, M, B)`` = per row Σⱼ aᵢⱼ (Mᵢ·Bⱼ):
  ``spmm.py:sddmm_rowdots_tiled``.

The reference's one-hot strips and row-block-padded tiles exist because a
TPU has no fast gather; Hopper gathers B's rows natively, so the kernels
read the CSR arrays as they are. Values are float32 or bf16 (widened
exactly), factors float32, k <= 32; the output is float32.
"""
from __future__ import annotations

import ctypes

import torch

from .. import sparse
from ..sparse import CsrMatrix
from . import _build
from .policy import launch_count, on_card

SPMM_LAUNCHES = launch_count("csr_spmm")
ROWDOTS_LAUNCHES = launch_count("csr_rowdots")
MAX_K = 32  # one lane of a warp per output column


def csr_spmm_ref(A: CsrMatrix, B: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`csr_spmm`: gather and segment sum."""
    return sparse.spmm(A, B)


def csr_rowdots_ref(A: CsrMatrix, M: torch.Tensor,
                    B: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`csr_rowdots`."""
    return sparse.sddmm_rowdots(A, M, B)


def _check_card_operands(A: CsrMatrix, factors) -> int:
    """Raise on what the CUDA CSR kernels do not take; return k."""
    if A.dtype not in (torch.float32, torch.bfloat16):
        raise NotImplementedError(
            f"the CUDA CSR kernels take float32 or bfloat16 values, got "
            f"{A.dtype} (float64 on the card: ROADMAP B1/B2 follow-up; use "
            "use_pallas=False for the plain path)")
    k = factors[0][0].shape[1]
    if not 1 <= k <= MAX_K:
        raise NotImplementedError(
            f"the CUDA CSR kernels take 1 <= k <= {MAX_K}, got k={k} "
            "(use use_pallas=False)")
    for t, rows in factors:
        if t.dtype != torch.float32 or tuple(t.shape) != (rows, k):
            raise NotImplementedError(
                f"the CUDA CSR kernels take float32 factors of shape "
                f"({rows}, {k}), got {t.dtype} {tuple(t.shape)}")
    return k


def _launch(symbol: str, A: CsrMatrix, factors, out: torch.Tensor,
            kw: int) -> None:
    """Run ``symbol`` of the csr_spmm library over A with the factor
    pointers ``factors`` into the zeroed ``out``."""
    fn = _build.function(
        "csr_spmm", symbol,
        [ctypes.c_int] + [ctypes.c_void_p] * 4
        + [ctypes.c_longlong, ctypes.c_int]
        + [ctypes.c_void_p] * (len(factors) + 3))
    floats = _build.function("csr_spmm", "pycmf_csr_workspace_floats",
                             [ctypes.c_longlong, ctypes.c_int],
                             ctypes.c_longlong)(A.nnz, kw)
    with torch.cuda.device(out.device):
        work = torch.empty(floats, dtype=torch.float32, device=out.device)
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(int(A.dtype == torch.bfloat16), A.data.data_ptr(),
                A.indices.data_ptr(), A.indptr.data_ptr(),
                A.row_ids.data_ptr(), A.nnz, factors[0].shape[1],
                *[t.data_ptr() for t in factors], out.data_ptr(),
                work.data_ptr(), stream)
    _build.check(_build.load("csr_spmm"), rc, symbol)


def csr_spmm(A: CsrMatrix, B: torch.Tensor) -> torch.Tensor:
    """A @ B for CSR A (p, q) and dense B (q, k) → (p, k) float32.

    CUDA tensors launch ``csrc/csr_spmm.cu``; CPU tensors take
    :func:`csr_spmm_ref`."""
    if not on_card(A.data, B):
        return csr_spmm_ref(A, B)
    p, q = A.shape
    k = _check_card_operands(A, ((B, q),))
    out = torch.zeros((p, k), dtype=torch.float32, device=B.device)
    if A.nnz:
        _launch("pycmf_csr_spmm", A, (B.contiguous(),), out, k)
        SPMM_LAUNCHES.n += 1
    return out


def csr_rowdots(A: CsrMatrix, M: torch.Tensor,
                B: torch.Tensor) -> torch.Tensor:
    """Per row Σⱼ aᵢⱼ (Mᵢ·Bⱼ) for CSR A (p, q), M (p, k), B (q, k) → (p,)
    float32.

    CUDA tensors launch ``csrc/csr_spmm.cu``; CPU tensors take
    :func:`csr_rowdots_ref`."""
    if not on_card(A.data, M, B):
        return csr_rowdots_ref(A, M, B)
    p, q = A.shape
    _check_card_operands(A, ((M, p), (B, q)))
    out = torch.zeros((p,), dtype=torch.float32, device=B.device)
    if A.nnz:
        _launch("pycmf_csr_rowdots", A, (M.contiguous(), B.contiguous()), out,
                1)
        ROWDOTS_LAUNCHES.n += 1
    return out
