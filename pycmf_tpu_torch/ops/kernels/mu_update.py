"""Fused MU factor update: the CUDA kernel's wrapper and its plain PyTorch
version.

Counterpart of ``pycmf_tpu/ops/pallas/mu_update.py``: the ratio tail of
every MU factor update,

    M ⊙ num ⊘ (M S + l1 + l2·M + ε),   M, num (p, k), S (k, k),

in one pass over row tiles, without writing M S to device memory. The
kernel is ``csrc/mu_update.cu`` (float32, k <= 32).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .policy import launch_count, on_card

LAUNCHES = launch_count("fused_mu_update")
MAX_K = 32  # S lives in a 32×32 shared-memory tile


def fused_mu_update_ref(M, S, num, l1, l2, eps):
    """Plain PyTorch version of :func:`fused_mu_update`."""
    return M * num / (M @ S + l1 + l2 * M + eps)


def fused_mu_update(M, S, num, l1, l2, eps):
    """M ⊙ num ⊘ (M S + l1 + l2·M + ε) for M, num (p, k) and S (k, k).

    CUDA tensors (float32, k <= 32) launch ``csrc/mu_update.cu``; CPU
    tensors take :func:`fused_mu_update_ref`."""
    if not on_card(M, S, num):
        return fused_mu_update_ref(M, S, num, l1, l2, eps)
    p, k = M.shape
    for t, shape in ((M, (p, k)), (num, (p, k)), (S, (k, k))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape \
                or not 1 <= k <= MAX_K:
            raise NotImplementedError(
                f"the CUDA MU update takes float32 M, num (p, k) and S (k, k) "
                f"with 1 <= k <= {MAX_K}, got {t.dtype} {tuple(t.shape)} for "
                f"shape {shape} (float64 on the card: ROADMAP B1/B2 "
                "follow-up; use use_pallas=False)")
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
