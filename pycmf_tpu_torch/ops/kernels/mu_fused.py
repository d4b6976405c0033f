"""Fused MU U-pass: the CUDA kernel's wrapper and its plain PyTorch version.

Counterpart of ``pycmf_tpu/ops/pallas/mu_fused.py``. One call computes

    U_new = U ⊙ (X V) ⊘ (U VᵀV + l1 + l2·U + ε)     rows ≥ n_valid zeroed
    numV  = Xᵀ U_new                                 (V's X-side numerator)
    gramU = U_newᵀ U_new                             (V's X-side Gram)

with the reference's rounding points: V is cast to X's dtype before X V,
U_new is cast to X's dtype before Xᵀ U_new, and all accumulation is in the
factor dtype (float32 on the card). The kernel is ``csrc/mu_fused.cu``.
"""
from __future__ import annotations

import ctypes

import torch

from ..matmul import FP8_DTYPES
from . import _build
from .policy import launch_count, on_card

LAUNCHES = launch_count("fused_mu_u_pass")


def check_data_dtype(X: torch.Tensor) -> None:
    """fp8 storage is not ported: it raises on every device."""
    if X.dtype in FP8_DTYPES:
        raise NotImplementedError(
            "fp8 data storage is not ported yet (ROADMAP A9)")


def check_card_operands(X: torch.Tensor, U, V, k_by_k) -> None:
    """Raise on what the CUDA U-pass kernels do not take."""
    if X.dim() != 2 or X.dtype not in (torch.float32, torch.bfloat16):
        raise NotImplementedError(
            f"the CUDA U-pass kernels take 2-D float32 or bfloat16 X, got "
            f"{X.dtype} {tuple(X.shape)} (float64 on the card: ROADMAP B1/B2 "
            "follow-up; use use_pallas=False for the plain path)")
    n, m = X.shape
    k = U.shape[1]
    if not 1 <= k <= 32:
        raise NotImplementedError(
            f"the CUDA U-pass kernels take 1 <= k <= 32, got k={k} "
            "(ROADMAP B1/B2 follow-up; use use_pallas=False)")
    for t, rows in ((U, n), (V, m)):
        if t.dtype != torch.float32 or t.shape != (rows, k):
            raise NotImplementedError(
                f"the CUDA U-pass kernels take float32 factors of shape "
                f"({rows}, {k}), got {t.dtype} {tuple(t.shape)}")
    for t in k_by_k:
        if t.dtype != torch.float32 or t.shape != (k, k):
            raise NotImplementedError(
                f"the CUDA U-pass kernels take float32 ({k}, {k}) matrices, "
                f"got {t.dtype} {tuple(t.shape)}")


def _acc_matmul(a: torch.Tensor, b: torch.Tensor, acc) -> torch.Tensor:
    """a @ b with both operands (already in X's dtype) widened to acc."""
    return torch.matmul(a.to(acc), b.to(acc))


def fused_mu_u_pass_ref(X, U, V, VtV, l1, l2, eps, n_valid=None):
    """Plain PyTorch version of :func:`fused_mu_u_pass` (same contract)."""
    check_data_dtype(X)
    n = X.shape[0]
    acc = U.dtype
    num_u = _acc_matmul(X, V.to(X.dtype), acc)
    unew = U * num_u / (U @ VtV + l1 + l2 * U + eps)
    nv = n if n_valid is None else int(n_valid)
    if nv < n:
        unew[nv:] = 0.0
    numv = _acc_matmul(X.mT, unew.to(X.dtype), acc)
    return unew, numv, unew.mT @ unew


def fused_mu_u_pass(X, U, V, VtV, l1, l2, eps, n_valid=None):
    """Single-call MU U-update plus V's X-side terms.

    X: (n, m) dense, float32 or bfloat16 on the card; U: (n, k), V: (m, k),
    VtV: (k, k) float32. Returns (U_new (n, k), numV (m, k), gramU (k, k)).
    CUDA tensors launch ``csrc/mu_fused.cu``; CPU tensors take
    :func:`fused_mu_u_pass_ref`.
    """
    check_data_dtype(X)
    if not on_card(X, U, V, VtV):
        return fused_mu_u_pass_ref(X, U, V, VtV, l1, l2, eps, n_valid)
    check_card_operands(X, U, V, (VtV,))
    n, m = X.shape
    k = U.shape[1]
    lib = _build.load("mu_fused")
    fn = lib.pycmf_mu_fused_u_pass
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                   + [ctypes.c_float] * 3 + [ctypes.c_void_p] * 5)
    fn.restype = ctypes.c_int
    X = X.contiguous()
    U = U.contiguous()
    Vx = V.to(X.dtype).contiguous()
    VtV = VtV.contiguous()
    opts = dict(dtype=torch.float32, device=X.device)
    unew = torch.empty((n, k), **opts)
    numv = torch.empty((m, k), **opts)
    gramu = torch.empty((k, k), **opts)
    work = torch.empty(lib.pycmf_workspace_floats(n, m, k), **opts)
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(int(X.dtype == torch.bfloat16), X.data_ptr(), U.data_ptr(),
                Vx.data_ptr(), VtV.data_ptr(), n, m, k,
                n if n_valid is None else int(n_valid),
                float(l1), float(l2), float(eps), unew.data_ptr(),
                numv.data_ptr(), gramu.data_ptr(), work.data_ptr(), stream)
    _build.check(lib, rc, "fused_mu_u_pass")
    LAUNCHES.n += 1
    return unew, numv, gramu
