"""Batched k×k SPD solve: the CUDA kernel's wrapper and its plain PyTorch
version.

Counterpart of ``pycmf_tpu/ops/pallas/batched_solve.py``: H[i] d[i] = G[i]
for every i, by an unpivoted Cholesky factorization and two triangular
solves, with an optional k×k H_shared added to every system (the Newton
solver's per-row Hessians plus their shared part). Each system must be
symmetric positive definite (the Gauss-Newton Hessians are, by
construction: H ⪰ (l2 + hessian_pertubation)·I); a system that is not
gives NaN in its own row, with no host sync. The kernel is
``csrc/batched_solve.cu``: one row of a system per lane up to k = 32, and
above that, up to MAX_K = 64, a wide route that holds each system in
shared memory, two rows per lane (counted apart, as
``batched_spd_solve_wide``).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .policy import launch_count, on_card

LAUNCHES = launch_count("batched_spd_solve")
WIDE_LAUNCHES = launch_count("batched_spd_solve_wide")
NARROW_K = 32  # a row of H per lane of one warp, in registers
MAX_K = 64     # above NARROW_K: two rows per lane, the system in shared memory
_ARGTYPES = ((ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 2
             + (ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p))


def batched_spd_solve_ref(H, G, H_shared=None):
    """Plain PyTorch version of :func:`batched_spd_solve` (k <= MAX_K)."""
    if H_shared is not None:
        H = H + H_shared
    L, info = torch.linalg.cholesky_ex(H)
    L = torch.where((info > 0)[:, None, None], torch.nan, L)
    return torch.cholesky_solve(G[..., None], L)[..., 0]


def _check_card_operands(ops, p: int, k: int) -> None:
    """Raise on what the CUDA batched solve does not take: float32 H
    (p, k, k), G (p, k) and, if given, H_shared (k, k)."""
    f32 = torch.float32
    if not (all(t.dtype is f32 for t in ops) and ops[1].shape == (p, k)
            and (len(ops) == 2 or ops[2].shape == (k, k))):
        raise NotImplementedError(
            "the CUDA batched solve takes float32 H (p, k, k), G (p, k) and "
            "H_shared (k, k), got "
            + ", ".join(f"{t.dtype} {tuple(t.shape)}" for t in ops)
            + " (float64 on the card: ROADMAP C1)")


def batched_spd_solve(H, G, H_shared=None):
    """Solve (H[i] + H_shared) d[i] = G[i] for all i. H: (p, k, k), G: (p, k)
    → (p, k); H_shared: (k, k), or None for H[i] d[i] = G[i]. Each sum must
    be SPD.

    The card's kernel adds H_shared to each system as it reads it, so the
    (p, k, k) sum is never written. For k > MAX_K both devices call
    ``torch.linalg.solve_ex`` on the sum (the reference's own rule for
    large k, ``jnp.linalg.solve``), which is not a launch of the kernel; it
    checks nothing on the host, and a singular system gives a non-finite
    row that the fit loop reports. A CUDA graph capture refuses that call.
    Otherwise CUDA tensors (float32) launch ``csrc/batched_solve.cu`` (its
    wide route above NARROW_K) and CPU tensors take
    :func:`batched_spd_solve_ref`."""
    p, k, _ = H.shape
    if k > MAX_K:
        Hs = H if H_shared is None else H + H_shared
        return torch.linalg.solve_ex(Hs, G[..., None])[0][..., 0]
    if p == 0:
        return G.new_empty((0, k))
    ops = (H, G) if H_shared is None else (H, G, H_shared)
    if not on_card(*ops):
        return batched_spd_solve_ref(H, G, H_shared)
    _check_card_operands(ops, p, k)
    H, G = H.contiguous(), G.contiguous()
    hs = None if H_shared is None else H_shared.contiguous()
    out = torch.empty_like(G)
    fn = _build.function("batched_solve", "pycmf_batched_spd_solve",
                         _ARGTYPES)
    dev = H.get_device()
    # the C side makes `dev` current for its launch
    rc = fn(H.data_ptr(), None if hs is None else hs.data_ptr(),
            G.data_ptr(), p, k, out.data_ptr(), dev,
            torch._C._cuda_getCurrentRawStream(dev))
    if rc:
        _build.check(_build.load("batched_solve"), rc, "batched_spd_solve")
    (LAUNCHES if k <= NARROW_K else WIDE_LAUNCHES).n += 1
    return out
