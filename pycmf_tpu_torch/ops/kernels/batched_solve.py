"""Batched k×k SPD solve: the CUDA kernel's wrapper and its plain PyTorch
version.

Counterpart of ``pycmf_tpu/ops/pallas/batched_solve.py``: H[i] d[i] = G[i]
for every i, by an unpivoted Cholesky factorization and two triangular
solves. H must be symmetric positive definite (the Gauss-Newton Hessians
are, by construction: H ⪰ (l2 + hessian_pertubation)·I); a system that is
not gives NaN, with no host sync. The kernel is ``csrc/batched_solve.cu``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .policy import launch_count, on_card

LAUNCHES = launch_count("batched_spd_solve")
MAX_K = 32  # the kernel holds a row of H per lane of one warp


def batched_spd_solve_ref(H, G):
    """Plain PyTorch version of :func:`batched_spd_solve` (k <= MAX_K)."""
    L, info = torch.linalg.cholesky_ex(H)
    L = torch.where((info > 0)[:, None, None], torch.nan, L)
    return torch.cholesky_solve(G[..., None], L)[..., 0]


def batched_spd_solve(H, G):
    """Solve H[i] d[i] = G[i] for all i. H: (p, k, k) SPD, G: (p, k) → (p, k).

    For k > MAX_K both devices call ``torch.linalg.solve`` (the reference's
    own rule for large k, ``jnp.linalg.solve``), which is not a launch of
    the kernel. Otherwise CUDA tensors (float32) launch
    ``csrc/batched_solve.cu`` and CPU tensors take
    :func:`batched_spd_solve_ref`."""
    p, k, _ = H.shape
    if k > MAX_K:
        return torch.linalg.solve(H, G[..., None])[..., 0]
    if p == 0:
        return G.new_empty((0, k))
    if not on_card(H, G):
        return batched_spd_solve_ref(H, G)
    for t, shape in ((H, (p, k, k)), (G, (p, k))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise NotImplementedError(
                f"the CUDA batched solve takes float32 H (p, k, k) and G "
                f"(p, k), got {t.dtype} {tuple(t.shape)} for shape {shape} "
                "(float64 on the card: ROADMAP C1)")
    H = H.contiguous()
    G = G.contiguous()
    out = torch.empty((p, k), dtype=torch.float32, device=H.device)
    fn = _build.function("batched_solve", "pycmf_batched_spd_solve",
                         [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
                         + [ctypes.c_void_p] * 2)
    with torch.cuda.device(H.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(H.data_ptr(), G.data_ptr(), p, k, out.data_ptr(), stream)
    _build.check(_build.load("batched_solve"), rc, "batched_spd_solve")
    LAUNCHES.n += 1
    return out
