"""Fused MU factor update: the CUDA kernel's wrapper and its plain PyTorch
version.

Counterpart of ``pycmf_tpu/ops/pallas/mu_update.py``: the ratio tail of
every MU factor update,

    M ⊙ num ⊘ (M S + l1 + l2·M + ε),   M, num (p, k), S (k, k),

in one pass over row tiles, without writing M S to device memory. The
kernel is ``csrc/mu_update.cu`` (float32, any k); its tile plan
(:func:`tile_rows`) is computed here and checked by the C entry point.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .mu_fused import _sm_count
from .policy import launch_count, on_card

LAUNCHES = launch_count("fused_mu_update")


def fused_mu_update_ref(M, S, num, l1, l2, eps):
    """Plain PyTorch version of :func:`fused_mu_update`."""
    return M * num / (M @ S + l1 + l2 * M + eps)


def check_card_operands(M, S, num) -> None:
    """Raise on what the CUDA MU update does not take: float32 M, num
    (p, k) and S (k, k), any k >= 1."""
    p, k = M.shape
    f32 = torch.float32
    if not (M.dtype is f32 and S.dtype is f32 and num.dtype is f32
            and k >= 1 and num.shape == M.shape and S.shape == (k, k)):
        raise NotImplementedError(
            f"the CUDA MU update takes float32 M, num (p, k) and S (k, k) "
            f"with k >= 1, got M {M.dtype} {tuple(M.shape)}, num "
            f"{num.dtype} {tuple(num.shape)}, S {S.dtype} {tuple(S.shape)} "
            "(float64 factors on the card: ROADMAP C1; use "
            "use_pallas=False)")


# Geometry of the k <= 32 route (csrc/mu_update.cu checks the plan it is
# given against the same rules)
TILE_FLOATS = 2560   # floats of M (and of num) per tile stage
MAX_K = 32           # wider k: one thread per element, S through L1
_ARGTYPES = ((ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 3
             + (ctypes.c_float,) * 3
             + (ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p))


@functools.lru_cache(maxsize=256)
def tile_rows(p: int, k: int, n_sm: int) -> int:
    """Rows per tile of the k <= 32 route: a multiple of 4 (so every tile
    starts 16-byte aligned), at most TILE_FLOATS floats, and small enough
    that a short M still gives about two tiles per SM (0 above MAX_K)."""
    if k > MAX_K:
        return 0
    most = TILE_FLOATS // k // 4 * 4
    two_per_sm = -(-p // (2 * n_sm))
    return max(4, min(most, -(-two_per_sm // 4) * 4))


def fused_mu_update(M, S, num, l1, l2, eps):
    """M ⊙ num ⊘ (M S + l1 + l2·M + ε) for M, num (p, k) and S (k, k).

    CUDA tensors (float32) launch ``csrc/mu_update.cu``; CPU
    tensors take :func:`fused_mu_update_ref`."""
    if not on_card(M, S, num):
        return fused_mu_update_ref(M, S, num, l1, l2, eps)
    check_card_operands(M, S, num)
    p, k = M.shape
    M, S, num = M.contiguous(), S.contiguous(), num.contiguous()
    out = torch.empty_like(M)
    if p == 0:
        return out
    fn = _build.function("mu_update", "pycmf_mu_update", _ARGTYPES)
    dev = M.get_device()
    # the C side makes `dev` current for its launch
    rc = fn(M.data_ptr(), S.data_ptr(), num.data_ptr(), p, k,
            tile_rows(p, k, _sm_count(dev)), float(l1), float(l2), float(eps),
            out.data_ptr(), dev,
            torch._C._cuda_getCurrentRawStream(dev))
    if rc:
        _build.check(_build.load("mu_update"), rc, "fused_mu_update")
    LAUNCHES.n += 1
    return out
