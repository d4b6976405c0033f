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
``batched_spd_solve_wide``). Above MAX_K the block route takes one CTA
per system (``batched_spd_solve_block``), and :func:`batched_lu_solve`,
the full Hessian form's solve, is the same kernel with partial pivoting
(LU, as the reference's ``jnp.linalg.solve``) at every k. Both keep the
system in shared memory up to the card's ``block_max_k`` (239 on an H100)
and above that in a global scratch slot per CTA, allocated here before the
launch, so that every route is capturable in a CUDA graph.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .mu_fused import _sm_count
from .policy import launch_count, on_card

LAUNCHES = launch_count("batched_spd_solve")
WIDE_LAUNCHES = launch_count("batched_spd_solve_wide")
BLOCK_LAUNCHES = launch_count("batched_spd_solve_block")
LU_LAUNCHES = launch_count("batched_lu_solve")
NARROW_K = 32  # a row of H per lane of one warp, in registers
MAX_K = 64     # above NARROW_K: two rows per lane, the system in shared memory
SCRATCH_CTAS_PER_SM = 4  # global scratch slots (CTAs) per SM above block_max_k
_ARGTYPES = ((ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 2
             + (ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p))
_BLOCK_ARGTYPES = ((ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 3
                   + (ctypes.c_void_p,) * 2 + (ctypes.c_int,) * 2
                   + (ctypes.c_void_p,))


def batched_spd_solve_ref(H, G, H_shared=None):
    """Plain PyTorch version of :func:`batched_spd_solve`."""
    if H_shared is not None:
        H = H + H_shared
    L, info = torch.linalg.cholesky_ex(H)
    L = torch.where((info > 0)[:, None, None], torch.nan, L)
    return torch.cholesky_solve(G[..., None], L)[..., 0]


def batched_lu_solve_ref(H, G, H_shared=None):
    """Plain PyTorch version of :func:`batched_lu_solve`: the LU solve of
    the sum (``torch.linalg.solve_ex``: no host sync; a singular system
    gives a non-finite row)."""
    if H_shared is not None:
        H = H + H_shared
    return torch.linalg.solve_ex(H, G[..., None])[0][..., 0]


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
    be SPD; one that is not gives NaN in its own row.

    The card's kernel adds H_shared to each system as it reads it, so the
    (p, k, k) sum is never written. CUDA tensors (float32) launch
    ``csrc/batched_solve.cu``: one row per lane up to NARROW_K, the wide
    route up to MAX_K, the block route above; CPU tensors take
    :func:`batched_spd_solve_ref`."""
    p, k, _ = H.shape
    if p == 0:
        return G.new_empty((0, k))
    ops = (H, G) if H_shared is None else (H, G, H_shared)
    if not on_card(*ops):
        return batched_spd_solve_ref(H, G, H_shared)
    _check_card_operands(ops, p, k)
    if k > MAX_K:
        out = _block_solve(H, G, H_shared, lu=False)
        BLOCK_LAUNCHES.n += 1
        return out
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


def batched_lu_solve(H, G, H_shared=None):
    """Solve (H[i] + H_shared) d[i] = G[i] for all i by LU with partial
    pivoting (the systems may be indefinite: the full Hessian form). A
    singular system gives NaN in its own row. CUDA tensors (float32)
    launch the LU route of ``csrc/batched_solve.cu``; CPU tensors take
    :func:`batched_lu_solve_ref`."""
    p, k, _ = H.shape
    if p == 0:
        return G.new_empty((0, k))
    ops = (H, G) if H_shared is None else (H, G, H_shared)
    if not on_card(*ops):
        return batched_lu_solve_ref(H, G, H_shared)
    _check_card_operands(ops, p, k)
    out = _block_solve(H, G, H_shared, lu=True)
    LU_LAUNCHES.n += 1
    return out


@functools.lru_cache(maxsize=None)
def block_max_k(device_index: int) -> int:
    """Largest k whose system the block and LU routes keep in one CTA's
    shared memory on this card (above it: a global scratch slot)."""
    fn = _build.function("batched_solve", "pycmf_block_solve_max_k",
                         (ctypes.c_int,))
    return int(fn(device_index))


def _block_solve(H, G, H_shared, lu: bool):
    """One launch of the block (SPD) or LU route on card operands."""
    p, k, _ = H.shape
    H, G = H.contiguous(), G.contiguous()
    hs = None if H_shared is None else H_shared.contiguous()
    out = torch.empty(G.shape, dtype=G.dtype, device=G.device)
    dev = H.get_device()
    scratch, slots = None, 0
    if k > block_max_k(dev):
        slots = min(p, SCRATCH_CTAS_PER_SM * _sm_count(dev))
        scratch = torch.empty(slots * k * (k | 1), dtype=torch.float32,
                              device=H.device)
    fn = _build.function("batched_solve", "pycmf_batched_block_solve",
                         _BLOCK_ARGTYPES)
    rc = fn(H.data_ptr(), None if hs is None else hs.data_ptr(),
            G.data_ptr(), p, k, int(lu), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(), slots, dev,
            torch._C._cuda_getCurrentRawStream(dev))
    if rc:
        _build.check(_build.load("batched_solve"), rc,
                     "batched_lu_solve" if lu else "batched_spd_solve")
    return out
