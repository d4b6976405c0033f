"""Fused MU factor update: the CUDA kernel's wrapper and its plain PyTorch
version.

Counterpart of ``pycmf_tpu/ops/pallas/mu_update.py``: the ratio tail of
every MU factor update,

    M ⊙ num ⊘ (M S + l1 + l2·M + ε),   M, num (p, k), S (k, k),

in one pass over row tiles, without writing M S to device memory. The
kernel is ``csrc/mu_update.cu`` (float32, any k).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .policy import launch_count, on_card

LAUNCHES = launch_count("fused_mu_update")


def fused_mu_update_ref(M, S, num, l1, l2, eps):
    """Plain PyTorch version of :func:`fused_mu_update`."""
    return M * num / (M @ S + l1 + l2 * M + eps)


def check_card_operands(M, S, num) -> None:
    """Raise on what the CUDA MU update does not take: float32 M, num
    (p, k) and S (k, k), any k >= 1."""
    p, k = M.shape
    for t, shape in ((M, (p, k)), (num, (p, k)), (S, (k, k))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape or k < 1:
            raise NotImplementedError(
                f"the CUDA MU update takes float32 M, num (p, k) and S (k, k) "
                f"with k >= 1, got {t.dtype} {tuple(t.shape)} for shape "
                f"{shape} (float64 factors on the card: ROADMAP C1; use "
                "use_pallas=False)")


def fused_mu_update(M, S, num, l1, l2, eps):
    """M ⊙ num ⊘ (M S + l1 + l2·M + ε) for M, num (p, k) and S (k, k).

    CUDA tensors (float32) launch ``csrc/mu_update.cu``; CPU
    tensors take :func:`fused_mu_update_ref`."""
    if not on_card(M, S, num):
        return fused_mu_update_ref(M, S, num, l1, l2, eps)
    check_card_operands(M, S, num)
    p, k = M.shape
    out = torch.empty((p, k), dtype=torch.float32, device=M.device)
    if p == 0:
        return out
    fn = _build.function("mu_update", "pycmf_mu_update",
                         [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                         + [ctypes.c_float] * 3 + [ctypes.c_void_p] * 2)
    M, S, num = M.contiguous(), S.contiguous(), num.contiguous()
    with torch.cuda.device(M.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(M.data_ptr(), S.data_ptr(), num.data_ptr(), p, k, float(l1),
                float(l2), float(eps), out.data_ptr(), stream)
    _build.check(_build.load("mu_update"), rc, "fused_mu_update")
    LAUNCHES.n += 1
    return out
