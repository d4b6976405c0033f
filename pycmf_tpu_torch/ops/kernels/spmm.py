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
exactly), factors float32, any k (k > 32 in 32-column slices, ``SLICE``);
the output is float32.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import sparse
from ..sparse import CsrMatrix
from . import _build
from .policy import launch_count, on_card

SPMM_LAUNCHES = launch_count("csr_spmm")
ROWDOTS_LAUNCHES = launch_count("csr_rowdots")
SLICE = 32  # factor columns per slice: 8 lanes of four columns per nonzero
# Chunk sizes of the CSR walk (``chunk_size``): small enough that the 20NG
# surrogate's 873651 nonzeros fill the card, large enough that a long row
# leaves few partials.
CHUNK_MIN, CHUNK_MAX = 16, 1024
CHUNKS_PER_SM = 512
# leading C arguments of both entry points: bf16, data, indices, indptr,
# row_ids, nnz, p, k, ld, ch
_ARGTYPES = ((ctypes.c_int,) + (ctypes.c_void_p,) * 4 + (ctypes.c_longlong,)
             + (ctypes.c_int,) * 4)


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
            f"{A.dtype} (float64 on the card: ROADMAP C1; use "
            "use_pallas=False for the plain path)")
    k = factors[0][0].shape[1]
    if k < 1:
        raise NotImplementedError(
            f"the CUDA CSR kernels take k >= 1, got k={k}")
    for t, rows in factors:
        if t.dtype != torch.float32 or tuple(t.shape) != (rows, k):
            raise NotImplementedError(
                f"the CUDA CSR kernels take float32 factors of shape "
                f"({rows}, {k}), got {t.dtype} {tuple(t.shape)}")
    return k


def chunk_size(nnz: int, n_sm: int) -> int:
    """Nonzeros per chunk of the CSR walk (one lane group each): a power
    of two in [CHUNK_MIN, CHUNK_MAX], about CHUNKS_PER_SM chunks per SM.
    The kernel takes it as an argument, so this is the only copy of the
    rule."""
    want = nnz // (CHUNKS_PER_SM * n_sm)
    ch = CHUNK_MIN
    while ch < CHUNK_MAX and ch < want:
        ch *= 2
    return ch


def workspace_floats(nnz: int, kw: int, ch: int) -> int:
    """Floats of partials one call writes at most: two slots of kw floats
    per chunk (the chunk's first row and its last row, where they cross a
    chunk boundary); csr_spmm has kw = k, one slot column per output
    column, its slices side by side."""
    return 2 * (-(-nnz // ch)) * kw


def rowdots_workspace_floats(nnz: int, k: int, ch: int, p: int) -> int:
    """Scratch of one csr_rowdots call: one partial column per slice of
    k, and with more than one slice each slice's (p,) row dots."""
    n_slices = -(-k // SLICE)
    return workspace_floats(nnz, n_slices, ch) \
        + (n_slices * p if n_slices > 1 else 0)


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _padded(t: torch.Tensor, ld: int) -> torch.Tensor:
    """t (n, k) float32, contiguous and 16-byte aligned, with its rows
    padded with zeros to ld columns (the kernel reads 16-byte vectors)."""
    t = t.contiguous()
    if t.shape[1] == ld and t.data_ptr() % 16 == 0:
        return t
    out = t.new_zeros((t.shape[0], ld))
    out[:, :t.shape[1]] = t
    return out


def _launch(symbol: str, A: CsrMatrix, factors, out: torch.Tensor,
            work_floats) -> None:
    """Run ``symbol`` of the csr_spmm library over A with the factors
    ``factors`` ((rows, k) float32 each) into ``out``, which it writes
    whole; work_floats(nnz, k, ch): its scratch."""
    k = factors[0].shape[1]
    ld = -(-k // 4) * 4
    fn = _build.function("csr_spmm", symbol,
                         _ARGTYPES + (ctypes.c_void_p,) * (len(factors) + 2)
                         + (ctypes.c_int, ctypes.c_void_p))
    factors = [_padded(t, ld) for t in factors]
    dev = out.device.index
    nnz = A.nnz
    ch = chunk_size(nnz, _sm_count(dev))
    work = torch.empty(work_floats(nnz, k, ch), dtype=torch.float32,
                       device=out.device)
    # the C side makes `dev` current for its launches (paths C and D are
    # bound by the host's time per call)
    rc = fn(int(A.dtype == torch.bfloat16), A.data.data_ptr(),
            A.indices.data_ptr(), A.indptr.data_ptr(), A.row_ids.data_ptr(),
            nnz, A.shape[0], k, ld, ch, *[t.data_ptr() for t in factors],
            out.data_ptr(), work.data_ptr(), dev,
            torch._C._cuda_getCurrentRawStream(dev))
    if rc:
        _build.check(_build.load("csr_spmm"), rc, symbol)


def csr_spmm(A: CsrMatrix, B: torch.Tensor) -> torch.Tensor:
    """A @ B for CSR A (p, q) and dense B (q, k) → (p, k), at the
    promotion of B's and the values' dtypes (``ops.spmm``).

    CUDA tensors launch ``csrc/csr_spmm.cu`` (float32 or bf16 values,
    float32 B, so float32 out; float64 raises naming ROADMAP C1); CPU
    tensors take :func:`csr_spmm_ref`."""
    if not on_card(A.data, B):
        return csr_spmm_ref(A, B)
    p, q = A.shape
    k = _check_card_operands(A, ((B, q),))
    if not A.nnz:
        return torch.zeros((p, k), dtype=torch.float32, device=B.device)
    out = torch.empty((p, k), dtype=torch.float32, device=B.device)
    _launch("pycmf_csr_spmm", A, (B,), out, workspace_floats)
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
    if not A.nnz:
        return torch.zeros((p,), dtype=torch.float32, device=B.device)
    out = torch.empty((p,), dtype=torch.float32, device=B.device)
    _launch("pycmf_csr_rowdots", A, (M, B), out,
            lambda nnz, k, ch: rowdots_workspace_floats(nnz, k, ch, p))
    ROWDOTS_LAUNCHES.n += 1
    return out
