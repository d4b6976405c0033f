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

The kernels are ``csrc/sigmoid_newton.cu`` (tensor cores, any k); their
launch plans (q segments, the width of K3's product table, whether the
small operands fit in shared memory) and workspace layouts are computed here
only (:func:`gh_plan`, :func:`phi_plan`) and checked by the C entry
points. The plain versions, and the
plain sigmoid terms of the generic Newton update (solvers/newton.py), go
through :func:`sigmoid_gh_rows` and ``ops.losses.sigmoid_sq_rows``, which
stream over row blocks (and candidates) so that no (n, q) float32
intermediate is larger than ``ops.losses._BLOCK_ELEMS`` elements.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from .. import losses
from ..matmul import matmul
from . import _build
from .mu_fused import (X_CODES, _sm_count, check_card_operands,
                       check_data_dtype, launches)
from .policy import launch_count, on_card

# the fp8 forms (e4m3 X) are counted apart from the f32 and bf16 forms
GH_LAUNCHES = launch_count("sigmoid_gh_pass")
GH_LAUNCHES_FP8 = launch_count("sigmoid_gh_pass_fp8")
PHI_LAUNCHES = launch_count("sigmoid_phi_pass")
PHI_LAUNCHES_FP8 = launch_count("sigmoid_phi_pass_fp8")
MAX_SLOTS = 256  # trials + 1: K4's per-(row, slot) sums in shared memory

# Geometry of the CUDA passes (csrc/sigmoid_newton.cu; the C side checks
# the plan it is given against the same rules).
ROWS = 64            # rows per CTA
CHUNK = 32           # q columns per chunk (and per segment unit)
COLS = 128           # columns of K3's product table per CTA
STAGES = 2           # cp.async ring depth (K3: of B and its pair tile)
X_STAGES = 3         # K3's X ring: X two chunks ahead
W_LD, P2 = CHUNK + 4, CHUNK // 2 + 4  # shared row strides (words)
SMEM_MAX = 232448    # dynamic shared memory of one CTA on an H100
CTAS_PER_SM = 2      # resident CTAs per SM (the kernels' launch bounds)
WORK_ALIGN = 64      # workspace parts start on 256-byte boundaries (floats)


class SigmoidPlan(NamedTuple):
    """One call's launch plan and workspace layout (counts in elements,
    ``offsets`` and ``floats`` in float32 words of one workspace)."""
    kg: int              # k rounded up to 8 (the mma depth)
    ldp: int             # K3: its partials' row width, the product table
    #                      T = [pairs (padded to 8) | B]'s width in whole
    #                      COLS tiles; K4: 0
    col_tiles: int       # K3: CTAs across T's columns (COLS each); K4: 1
    row_tiles: int       # CTAs across the rows (ROWS each)
    n_seg: int           # q segments, one partial per (segment, row) each
    seg_len: int         # q columns per segment, a multiple of CHUNK
    ops_smem: int        # 1: M (d) and B's chunk columns in shared memory
    smem: int            # dynamic shared memory of one CTA, bytes
    offsets: Tuple[int, ...]  # padded B, then K3: padded M in TF32 parts
    #                           (high, low), T's pair columns (bf16 parts);
    #                           K4: padded M and d; then the partials
    floats: int          # workspace size


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def smem_bytes(x_bytes: int, kg: int, gh: bool, ops_smem: bool,
               slots: int) -> int:
    """Dynamic shared memory of one CTA (csrc/sigmoid_newton.cu:
    SLayout): K3's X ring, then per stage its pair tile (bf16 high and low
    parts) and (ops_smem) the chunk's B rows, M (TF32 parts) when ops_smem,
    its W tile (bf16 parts) and RF tile (f32); K4: per stage the X tile and
    (ops_smem) the chunk's B rows, M and d when ops_smem, its per-(row,
    slot) sums."""
    ops_ld = kg + 4
    x_tile = ROWS * (CHUNK + 16 // x_bytes) * x_bytes
    stage = ((2 * COLS * P2 * 4 if gh else x_tile)
             + (CHUNK * ops_ld * 4 if ops_smem else 0))
    ops = 2 * ROWS * ops_ld * 4 if ops_smem else 0
    tail = ((2 * ROWS * P2 + ROWS * W_LD) * 4 if gh
            else 2 * slots * ROWS * 4)
    return (X_STAGES * x_tile if gh else 0) + STAGES * stage + ops + tail


def g_offset(k: int) -> int:
    """K3: the column of G's first component in T, after the k(k+1)/2
    pair columns rounded up to 8 (csrc/sigmoid_newton.cu: g_offset)."""
    return 8 * _ceil(k * (k + 1) // 2, 8)


def _plan(n, q, k, x_bytes, n_sm, gh, slots) -> SigmoidPlan:
    kg = 8 * _ceil(k, 8)
    ldp = COLS * _ceil(g_offset(k) + kg, COLS) if gh else 0
    col_tiles = ldp // COLS if gh else 1
    row_tiles = _ceil(n, ROWS)
    chunks = _ceil(q, CHUNK)
    n_seg = min(max(1, _ceil(CTAS_PER_SM * n_sm, row_tiles * col_tiles)),
                chunks)
    per = _ceil(chunks, n_seg)
    n_seg = _ceil(chunks, per)
    ops_smem = int(smem_bytes(x_bytes, kg, gh, True, slots) <= SMEM_MAX)
    rows = ROWS * row_tiles * kg
    sizes = ((CHUNK * chunks * kg, rows, rows)
             + ((CHUNK * chunks * ldp,) if gh else ())
             + (n_seg * n * (ldp if gh else slots),))
    offsets, at = [], 0
    for size in sizes:
        offsets.append(at)
        at += _ceil(size, WORK_ALIGN) * WORK_ALIGN
    return SigmoidPlan(kg, ldp, col_tiles, row_tiles, n_seg, per * CHUNK,
                       ops_smem, smem_bytes(x_bytes, kg, gh, ops_smem, slots),
                       tuple(offsets), at)


@functools.lru_cache(maxsize=64)
def gh_plan(n: int, q: int, k: int, x_bytes: int, n_sm: int) -> SigmoidPlan:
    """Plan of one K3 call on a card with ``n_sm`` SMs: row tiles x T's
    column tiles x q segments make about CTAS_PER_SM CTAs per SM (at least
    one segment, segments whole chunks)."""
    return _plan(n, q, k, x_bytes, n_sm, True, 1)


@functools.lru_cache(maxsize=64)
def phi_plan(n: int, q: int, k: int, slots: int, x_bytes: int,
             n_sm: int) -> SigmoidPlan:
    """Plan of one K4 call: row tiles x q segments as for K3."""
    return _plan(n, q, k, x_bytes, n_sm, False, slots)


def sigmoid_gh_rows(D, M, B, hessian_form: str = "gauss", mask=None):
    """(G (p, k), H (p, k, k)) of the data term ½‖D − σ(M Bᵀ)‖², without
    penalties: G = (R⊙f′)B with R = P − D, and H[i] = Bᵀ diag(Wᵢ) B =
    (W @ BB)[i], BB_j = vec(b_j b_jᵀ), where W = f′² (``'gauss'``) or
    f′² + R⊙f′⊙(1 − 2P) (``'full'``, the exact Hessian: f″ = f′(1 − 2P)).
    With a (q,) column ``mask``, R⊙f′ and W are masked by column
    (the reference's ``_accumulate_term``, pycmf_tpu/solvers/newton.py:
    242-262)."""
    p, k = M.shape
    q = B.shape[0]
    Bf = B.to(M.dtype)
    BB = (Bf[:, :, None] * Bf[:, None, :]).reshape(q, k * k)

    def rows(Mi, Di):
        P = torch.sigmoid(Mi @ Bf.mT)
        fp = P * (1.0 - P)
        R = P - Di.to(M.dtype)
        Rfp, W = R * fp, fp * fp
        if hessian_form == "full":
            W = W + R * (fp * (1.0 - 2.0 * P))
        if mask is not None:
            Rfp, W = Rfp * mask, W * mask
        # H pinned to true float32, as the reference pins its einsum
        return Rfp @ Bf, matmul(W, BB, precision="highest")

    bs = losses.rows_per_block(q)
    if bs >= p:
        G, H = rows(M, D)
        return G, H.reshape(p, k, k)
    G = M.new_empty((p, k))
    H = M.new_empty((p, k * k))
    for i in range(0, p, bs):
        G[i:i + bs], H[i:i + bs] = rows(M[i:i + bs], D[i:i + bs])
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


_GH_ARGS = ((ctypes.c_int,) + (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 3
            + (ctypes.c_float,) * 2 + (ctypes.c_void_p,) * 7
            + (ctypes.c_int,) * 5 + (ctypes.c_void_p,))
_PHI_ARGS = ((ctypes.c_int,) + (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 5
             + (ctypes.c_float,) * 2 + (ctypes.c_void_p,) * 5
             + (ctypes.c_int,) * 4 + (ctypes.c_void_p,))


def sigmoid_gh_pass(X, M, B, l1, l2):
    """One-pass sigmoid G and Gauss-Newton H build.

    X: (n, q) dense, float32, bfloat16 or float8_e4m3fn (contiguous on the
    card; widened to float32 elementwise, exactly); M:
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
    dev = X.device.index
    plan = gh_plan(n, q, k, X.element_size(), _sm_count(dev))
    work = torch.empty(plan.floats, dtype=torch.float32, device=X.device)
    out = torch.empty(n * k * (k + 1), dtype=torch.float32, device=X.device)
    G, H = out[:n * k].view(n, k), out[n * k:].view(n, k, k)
    base = work.data_ptr()
    fn = _build.function("sigmoid_newton", "pycmf_sigmoid_gh_pass", _GH_ARGS)
    # the C side makes `dev` current for its launches
    rc = fn(X_CODES[X.dtype], X.data_ptr(), M.data_ptr(),
            B.data_ptr(), n, q, k, float(l1), float(l2), G.data_ptr(),
            H.data_ptr(), *(base + 4 * o for o in plan.offsets), plan.ldp,
            plan.n_seg, plan.seg_len, plan.ops_smem, dev,
            torch._C._cuda_getCurrentRawStream(dev))
    if rc:
        _build.check(_build.load("sigmoid_newton"), rc, "sigmoid_gh_pass")
    launches(X, GH_LAUNCHES, GH_LAUNCHES_FP8).n += 1
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
    dev = X.device.index
    plan = phi_plan(n, q, k, slots, X.element_size(), _sm_count(dev))
    work = torch.empty(plan.floats, dtype=torch.float32, device=X.device)
    phi = torch.empty((n, slots), dtype=torch.float32, device=X.device)
    base = work.data_ptr()
    fn = _build.function("sigmoid_newton", "pycmf_sigmoid_phi_pass",
                         _PHI_ARGS)
    rc = fn(X_CODES[X.dtype], X.data_ptr(), M.data_ptr(),
            d.data_ptr(), B.data_ptr(), n, q, k, slots,
            int(bool(non_negative)), float(l1), float(l2), phi.data_ptr(),
            *(base + 4 * o for o in plan.offsets), plan.n_seg,
            plan.seg_len, plan.ops_smem, dev,
            torch._C._cuda_getCurrentRawStream(dev))
    if rc:
        _build.check(_build.load("sigmoid_newton"), rc, "sigmoid_phi_pass")
    launches(X, PHI_LAUNCHES, PHI_LAUNCHES_FP8).n += 1
    return phi
