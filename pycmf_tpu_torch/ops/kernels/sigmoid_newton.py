"""Sigmoid-link Newton passes: the CUDA kernels' wrappers and their plain
PyTorch versions.

Counterpart of ``pycmf_tpu/ops/pallas/sigmoid_newton.py``. With
P = σ(M Bᵀ) and f′ = P(1 − P):

- ``sigmoid_gh_pass``: G = ((P − X)⊙f′)B + l1·sign(M) + l2·M and the
  Gauss-Newton Hessians H[i] = Bᵀ diag(f′ᵢ²) B, (n, k, k), in one pass
  over X (the caller adds (l2 + pert)·I before solving);
- ``sigmoid_phi_pass``: the per-row line-search objectives of every
  backtracking candidate in one pass over X, (n, trials+1): slot 0 =
  φ(M), slot t = φ(proj(M − 0.5^(t−1) d)), with
  φ(c) = l1‖c‖₁ + ½l2‖c‖² + ½‖x − σ(c Bᵀ)‖².

The kernels are ``csrc/sigmoid_newton.cu``. The plain versions, and the
plain sigmoid terms of the generic Newton update (solvers/newton.py), go
through :func:`sigmoid_gh_rows` and ``ops.losses.sigmoid_sq_rows``, which
stream over row blocks (and candidates) so that no (n, q) float32
intermediate is larger than ``ops.losses._BLOCK_ELEMS`` elements.
"""
from __future__ import annotations

import ctypes

import torch

from .. import losses
from . import _build
from .mu_fused import check_card_operands, check_data_dtype
from .policy import launch_count, on_card

GH_LAUNCHES = launch_count("sigmoid_gh_pass")
PHI_LAUNCHES = launch_count("sigmoid_phi_pass")
MAX_SLOTS = 256  # trials + 1: one thread per (row, slot) in a 256-thread block


def sigmoid_gh_rows(D, M, B):
    """(G (p, k), H (p, k, k)) of the data term ½‖D − σ(M Bᵀ)‖² in Gauss-
    Newton form, without penalties: G = ((P − D)⊙f′)B and
    H[i] = Bᵀ diag(f′ᵢ²) B = (f′² @ BB)[i], BB_j = vec(b_j b_jᵀ)."""
    p, k = M.shape
    q = B.shape[0]
    Bf = B.to(M.dtype)
    BB = (Bf[:, :, None] * Bf[:, None, :]).reshape(q, k * k)
    bs = losses.rows_per_block(q)
    if bs >= p:
        P = torch.sigmoid(M @ Bf.mT)
        fp = P * (1.0 - P)
        G = ((P - D.to(M.dtype)) * fp) @ Bf
        return G, ((fp * fp) @ BB).reshape(p, k, k)
    G = M.new_empty((p, k))
    H = M.new_empty((p, k * k))
    for i in range(0, p, bs):
        P = torch.sigmoid(M[i:i + bs] @ Bf.mT)
        fp = P * (1.0 - P)
        G[i:i + bs] = ((P - D[i:i + bs].to(M.dtype)) * fp) @ Bf
        H[i:i + bs] = (fp * fp) @ BB
    return G, H.reshape(p, k, k)


def sigmoid_gh_pass_ref(X, M, B, l1, l2):
    """Plain PyTorch version of :func:`sigmoid_gh_pass`."""
    check_data_dtype(X)
    G, H = sigmoid_gh_rows(X, M, B)
    return G + l1 * torch.sign(M) + l2 * M, H


def candidates(M, d, trials: int, non_negative: bool):
    """(trials+1, n, k): M, then proj(M − 0.5ᵗ d) for t < trials (0.5ᵗ d
    is exact, so the kernel's candidates are bit-identical)."""
    out = [M]
    for t in range(trials):
        c = M - (0.5 ** t) * d
        out.append(torch.clamp_min(c, 0.0) if non_negative else c)
    return torch.stack(out)


def sigmoid_phi_pass_ref(X, M, d, B, l1, l2, *, trials: int,
                         non_negative: bool):
    """Plain PyTorch version of :func:`sigmoid_phi_pass`."""
    check_data_dtype(X)
    C = candidates(M, d, trials, non_negative)
    pen = l1 * torch.sum(torch.abs(C), dim=-1) \
        + 0.5 * l2 * torch.sum(C * C, dim=-1)
    return (pen + losses.sigmoid_sq_rows(X, C, B)).T


def _card_operands(X, M, B, *extra):
    check_card_operands(X, M, B, ())
    if not X.is_contiguous():
        raise ValueError(
            "the CUDA sigmoid passes read X row-major and contiguous; a "
            "transposed view would need a copy in every call (make Xᵀ once "
            "per fit: Coupled.At)")
    return [t.contiguous() for t in (M, B) + extra]


def sigmoid_gh_pass(X, M, B, l1, l2):
    """One-pass sigmoid G and Gauss-Newton H build.

    X: (n, q) dense, float32 or bfloat16 (contiguous on the card); M:
    (n, k), B: (q, k) float32. Returns (G (n, k) including the elastic-net
    gradient, H (n, k, k) the data Hessians). CUDA tensors launch
    ``csrc/sigmoid_newton.cu``; CPU tensors take :func:`sigmoid_gh_pass_ref`.
    """
    check_data_dtype(X)
    if not on_card(X, M, B):
        return sigmoid_gh_pass_ref(X, M, B, l1, l2)
    M, B = _card_operands(X, M, B)
    n, q = X.shape
    k = M.shape[1]
    G = torch.empty((n, k), dtype=torch.float32, device=X.device)
    H = torch.empty((n, k, k), dtype=torch.float32, device=X.device)
    with torch.cuda.device(X.device):
        work = torch.empty(
            _build.function("sigmoid_newton", "pycmf_gh_workspace_floats",
                            [ctypes.c_int] * 3, ctypes.c_longlong)(n, q, k),
            dtype=torch.float32, device=X.device)
        fn = _build.function(
            "sigmoid_newton", "pycmf_sigmoid_gh_pass",
            [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
            + [ctypes.c_float] * 2 + [ctypes.c_void_p] * 4)
        rc = fn(int(X.dtype == torch.bfloat16), X.data_ptr(), M.data_ptr(),
                B.data_ptr(), n, q, k, float(l1), float(l2), G.data_ptr(),
                H.data_ptr(), work.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
    _build.check(_build.load("sigmoid_newton"), rc, "sigmoid_gh_pass")
    GH_LAUNCHES.n += 1
    return G, H


def sigmoid_phi_pass(X, M, d, B, l1, l2, *, trials: int, non_negative: bool):
    """One-pass evaluation of every backtracking objective.

    Returns φ (n, trials+1): slot 0 = φ(M), slot t = φ of
    proj(M − 0.5^(t−1) d); the caller selects the first slot strictly
    below slot 0 and rebuilds that candidate with the same formula. CUDA
    tensors launch ``csrc/sigmoid_newton.cu`` (trials + 1 <= 256); CPU
    tensors take :func:`sigmoid_phi_pass_ref`."""
    check_data_dtype(X)
    if not on_card(X, M, d, B):
        return sigmoid_phi_pass_ref(X, M, d, B, l1, l2, trials=trials,
                                    non_negative=non_negative)
    M, B, d = _card_operands(X, M, B, d)
    if d.shape != M.shape or d.dtype != torch.float32:
        raise NotImplementedError(
            f"d must be float32 of shape {tuple(M.shape)}, got {d.dtype} "
            f"{tuple(d.shape)}")
    slots = int(trials) + 1
    if not 1 <= slots <= MAX_SLOTS:
        raise NotImplementedError(
            f"the CUDA phi pass takes 0 <= trials <= {MAX_SLOTS - 1}, got "
            f"{trials}")
    n, q = X.shape
    k = M.shape[1]
    phi = torch.empty((n, slots), dtype=torch.float32, device=X.device)
    with torch.cuda.device(X.device):
        work = torch.empty(
            _build.function("sigmoid_newton", "pycmf_phi_workspace_floats",
                            [ctypes.c_int] * 3, ctypes.c_longlong)(n, q, slots),
            dtype=torch.float32, device=X.device)
        fn = _build.function(
            "sigmoid_newton", "pycmf_sigmoid_phi_pass",
            [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
            + [ctypes.c_float] * 2 + [ctypes.c_void_p] * 3)
        rc = fn(int(X.dtype == torch.bfloat16), X.data_ptr(), M.data_ptr(),
                d.data_ptr(), B.data_ptr(), n, q, k, slots,
                int(bool(non_negative)), float(l1), float(l2), phi.data_ptr(),
                work.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _build.check(_build.load("sigmoid_newton"), rc, "sigmoid_phi_pass")
    PHI_LAUNCHES.n += 1
    return phi
