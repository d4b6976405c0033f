"""Fused Newton U-pass (linear link, shared Hessian): the CUDA kernel's
wrapper and its plain PyTorch version.

Counterpart of ``pycmf_tpu/ops/pallas/newton_fused.py``. Per row, with
DB = X V:

    g     = U BtB − DB + l1·sign(U) + l2·U
    d     = g Hinv
    U_new = backtracking over proj(U − 0.5ʲ d), j < trials: the first
            candidate whose φ is strictly below φ(U) (slot 0 unprojected),
            the row kept if none is, with
            φ(M) = l1‖M‖₁ + ½l2‖M‖² + ½(‖x‖² − 2⟨DB, M⟩ + M BtB Mᵀ)

plus numV = Xᵀ U_new and gramU = U_newᵀ U_new as in ``mu_fused``, with the
same rounding points (fp8 X contracts in bf16). The kernel is
``csrc/newton_fused.cu``, or ``csrc/u_pass_wide.cu`` at k > 32.
"""
from __future__ import annotations

import ctypes

import torch

from ..linesearch import backtracking_select
from ..matmul import operand_dtype
from . import _build
from .mu_fused import (_acc_matmul, check_card_operands, check_data_dtype,
                       launch_u_pass, launches)
from .policy import launch_count, on_card

LAUNCHES = launch_count("fused_newton_linear_u_pass")
LAUNCHES_FP8 = launch_count("fused_newton_linear_u_pass_fp8")
LAUNCHES_WIDE = launch_count("fused_newton_linear_u_pass_wide")


def fused_newton_linear_u_pass_ref(X, U, V, BtB, Hinv, row_sq, l1, l2, *,
                                   trials: int, non_negative: bool):
    """Plain PyTorch version of :func:`fused_newton_linear_u_pass`."""
    check_data_dtype(X)
    acc = U.dtype
    op = operand_dtype(X.dtype)
    db = _acc_matmul(X, V.to(op), acc)
    g = U @ BtB - db + l1 * torch.sign(U) + l2 * U
    d = g @ Hinv
    rs = row_sq.to(acc)

    def project(mc):
        return torch.clamp_min(mc, 0.0) if non_negative else mc

    def phi(mc):
        quad = torch.sum((mc @ BtB) * mc, dim=-1)
        lin = torch.sum(db * mc, dim=-1)
        pen = l1 * torch.sum(torch.abs(mc), dim=-1) \
            + 0.5 * l2 * torch.sum(mc * mc, dim=-1)
        return pen + 0.5 * (rs - 2.0 * lin + quad)

    unew = backtracking_select(phi, project, U, d, trials)
    numv = _acc_matmul(X.mT, unew.to(op), acc)
    return unew, numv, unew.mT @ unew


def fused_newton_linear_u_pass(X, U, V, BtB, Hinv, row_sq, l1, l2, *,
                               trials: int, non_negative: bool):
    """One-call Newton update of U (linear link, shared Hessian).

    X: (n, m) dense, float32, bfloat16 or float8_e4m3fn on the card; U:
    (n, k), V: (m, k);
    BtB = VᵀV and Hinv = (BtB + (l2 + pert)·I)⁻¹: (k, k); row_sq: (n,)
    per-row ‖xᵢ‖², all float32. Returns (U_new, numV = XᵀU_new,
    gramU = U_newᵀU_new). CUDA tensors launch ``csrc/newton_fused.cu``
    (``csrc/u_pass_wide.cu`` at k > 32); CPU tensors take
    :func:`fused_newton_linear_u_pass_ref`.
    """
    check_data_dtype(X)
    if not on_card(X, U, V, BtB, Hinv, row_sq):
        return fused_newton_linear_u_pass_ref(
            X, U, V, BtB, Hinv, row_sq, l1, l2, trials=trials,
            non_negative=non_negative)
    check_card_operands(X, U, V, (BtB, Hinv))
    n, m = X.shape
    if row_sq.shape != (n,):
        raise ValueError(f"row_sq must have shape ({n},), got "
                         f"{tuple(row_sq.shape)}")
    out = launch_u_pass(
        "newton_fused", "pycmf_newton_fused_u_pass",
        (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 3 + (ctypes.c_float,) * 2
        + (ctypes.c_int,) * 2,
        X.contiguous(), U.contiguous(), V.contiguous(),
        (BtB.contiguous(), Hinv.contiguous(),
         row_sq.to(torch.float32).contiguous(), n, m, U.shape[1], float(l1),
         float(l2), int(trials), int(bool(non_negative))))
    launches(X, LAUNCHES, LAUNCHES_FP8, LAUNCHES_WIDE, U.shape[1]).n += 1
    return out
