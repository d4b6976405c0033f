"""Fused MU U-pass: the CUDA kernel's wrapper and its plain PyTorch version.

Counterpart of ``pycmf_tpu/ops/pallas/mu_fused.py``. One call computes

    U_new = U ⊙ (X V) ⊘ (U VᵀV + l1 + l2·U + ε)     rows ≥ n_valid zeroed
    numV  = Xᵀ U_new                                 (V's X-side numerator)
    gramU = U_newᵀ U_new                             (V's X-side Gram)

with the reference's rounding points: V is cast to X's operand dtype before
X V, U_new is cast to it before Xᵀ U_new, and all accumulation is in the
factor dtype (float32 on the card). The operand dtype is X's own, or bf16
for fp8 X (float8_e4m3fn, widened to bf16 exactly:
``matmul.operand_dtype``). The kernel is ``csrc/mu_fused.cu`` on the
skeleton ``csrc/u_pass_common.cuh`` (two sweeps over X), or for f32 X at
k <= 32 ``csrc/u_pass_cluster.cuh`` (clusters of 16 CTAs, one read of X),
and at k > 32 ``csrc/u_pass_wide.cu`` (two sweeps, each reading X once at
any k <= 128), shared with ``newton_fused``; this module holds the Python
side of all three: :func:`u_pass_plan` (the route, tiles, row segments and
workspace layout, computed here only) and :func:`launch_u_pass`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from ..matmul import FP8_DTYPES, operand_dtype
from . import _build
from .policy import launch_count, on_card

# the fp8 form (e4m3 X) is counted apart from the f32 and bf16 forms, and
# the wide route (k > K_NARROW, any X dtype) apart from both
LAUNCHES = launch_count("fused_mu_u_pass")
LAUNCHES_FP8 = launch_count("fused_mu_u_pass_fp8")
LAUNCHES_WIDE = launch_count("fused_mu_u_pass_wide")

# Geometry of the CUDA U-pass (csrc/u_pass_common.cuh; the C side checks
# the plan it is given against the same rules).
A_ROWS = 64          # rows per CTA of the row sweep (X V and the epilogue)
B_COLS = 128         # columns per CTA of the column sweep (X^T U_new)
VT_ALIGN = 128       # Vᵀ's leading dimension: whole 256-byte bf16 stages
B_CTAS_PER_SM = 2    # column-sweep CTAs resident per SM (its launch bounds)
WORK_ALIGN = 64      # workspace parts start on 256-byte boundaries (floats)
K_NARROW = 32        # k > K_NARROW: the wide route (csrc/u_pass_wide.cu)
WIDE_SLICE = 128     # the wide route's components per slice above this k
# The cluster route of f32 X at k <= K_NARROW (csrc/u_pass_cluster.cuh): one
# read of X per call
C_CTAS = 16          # CTAs per cluster, each a slice of m's columns
C_ROWS = 16          # rows per band (one row of each band per CTA)
C_WARPS = 12         # warps per CTA
C_SLOTS = 6          # slots of the warps' X V partials
C_BUFS = 3           # bands of X held in shared memory
C_MTILES = 4         # numV's 16-column tiles per warp, held in registers
C_MAX_COLS = 16 * C_WARPS * C_MTILES   # 768 columns per CTA at most
SMEM_OPTIN = 232448  # shared bytes a CTA may use on an H100 (227 KB)


class UPassPlan(NamedTuple):
    """One call's launch plan and workspace layout (all counts in elements;
    ``offsets`` and ``floats`` in float32 words of one workspace)."""
    nt: int              # n8 tiles of the factor dimension: ceil(k / 8),
    #                      or on the wide route wide_nt(k) a slice, times
    #                      k_slices
    k_slices: int        # component slices: 1, or wide_slices(k) for k > 32
    ld_vt: int           # row stride of Vᵀ in the operand dtype (NP rows)
    ld_ux: int           # row stride of U_newᵀ in the operand dtype
    row_blocks: int      # row-sweep CTAs, each A_ROWS rows
    col_slices: int      # column-sweep CTAs per row segment, B_COLS columns
    seg_rows: int        # rows per row segment of the column sweep
    n_seg: int           # row segments (numV partials when > 1)
    offsets: Tuple[int, int, int, int]  # vt, uxt, Gram and numV partials
    #                      (the last also the wide route's X V and its
    #                      epilogue's scratch, 2 n k floats, which the column
    #                      sweep overwrites)
    floats: int          # workspace size
    clusters: int = 0    # the cluster route's clusters of C_CTAS CTAs (f32
    #                      X, k <= 32, m <= cluster_max_m(k)); 0: two sweeps
    slice_cols: int = 0  # its columns per CTA: a multiple of 16


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def wide_nt(k: int) -> int:
    """n8 tiles per slice of the wide route at k > K_NARROW: ceil(k / 8) up
    to 8, then the next even count, up to 16 (one slice of 128 components);
    16 above. The C entry takes it from the plan and instantiates these
    counts alone (csrc/u_pass_wide.cuh: with_wide_nt)."""
    if k > WIDE_SLICE:
        return WIDE_SLICE // 8
    t = _ceil(k, 8)
    return t if t <= 8 else _ceil(t, 2) * 2


def wide_slices(k: int) -> int:
    """Component slices of the wide route: one at k <= WIDE_SLICE, so each
    sweep reads X once; above, slices of WIDE_SLICE components."""
    return 1 if k <= WIDE_SLICE else _ceil(k, WIDE_SLICE)


def cluster_smem(w: int, np_: int, mats: int = 2) -> int:
    """Shared bytes of one cluster-route CTA at slices of w columns
    (csrc/u_pass_cluster.cuh: CSmem): Vᵀ (np_ rows) and C_BUFS bands of
    X, rows of w + 4 floats; the epilogue's ``mats`` np_ x np_ matrices (2
    for K2); the warps' X V partials in C_SLOTS slots; the X V rows and
    U_new rows pushed by the cluster's CTAs, for two bands each; four
    barriers (8 bytes each)."""
    return 4 * ((np_ + C_BUFS * C_ROWS) * (w + 4) + mats * np_ * np_
                + (C_SLOTS + 4) * C_ROWS * np_ + 8)


@functools.lru_cache(maxsize=None)
def cluster_max_m(k: int) -> int:
    """The widest m the cluster route takes at k <= K_NARROW: C_CTAS slices
    of the most columns (a multiple of 16, at most C_MAX_COLS) whose CTA
    fits SMEM_OPTIN; wider X takes the two sweeps. 12288 to k = 16,
    11520 to 24, 9984 to 32."""
    np_ = 8 * _ceil(k, 8)
    w = C_MAX_COLS
    while w > 16 and cluster_smem(w, np_) > SMEM_OPTIN:
        w -= 16
    return C_CTAS * w


@functools.lru_cache(maxsize=64)
def u_pass_plan(n: int, m: int, k: int, op_bytes: int, n_sm: int,
                max_clusters: int | None = None) -> UPassPlan:
    """Plan of one U-pass call on a card with ``n_sm`` SMs; ``op_bytes``:
    the size of X's operand dtype (2 for bf16 and fp8 X, 4 for f32), in
    which Vᵀ and U_newᵀ are stored. The plan does not depend on X's own
    size, so an fp8 call runs the bf16 call's plan. The column sweep
    takes as many row segments as keep its CTAs within one resident wave
    (B_CTAS_PER_SM per SM), at least one; segments are whole row-sweep
    blocks, so each starts on a row where X's 16-byte alignment repeats.
    For k > K_NARROW the wide route (csrc/u_pass_wide.cu) keeps these row
    segments and takes one slice of wide_nt(k) n8 tiles at k <= WIDE_SLICE,
    else wide_slices(k) slices of 16; its X V and the epilogue's scratch
    (2 n k floats) share the last workspace part, and for f32 X it keeps
    Vᵀ as three planes (its TF32 parts hi, mid, lo) and U_newᵀ as two
    (hi, lo), each of the same rows.

    f32 X at k <= K_NARROW and m <= cluster_max_m(k) takes the cluster route
    (csrc/u_pass_cluster.cuh: one read of X): n_sm // C_CTAS clusters, or
    ``max_clusters`` (the card's count of clusters resident at once) if
    fewer, at least one, walk bands of C_ROWS rows, band b on cluster
    b % clusters, and CTA s of a cluster holds columns s·slice_cols ... of
    every band; the Gram partials are one per CTA, the numV partials one
    per cluster. Its plan keeps the two-sweep fields, and the workspace
    holds either route's parts."""
    wide = k > K_NARROW
    k_slices = wide_slices(k) if wide else 1
    np_ = 8 * (wide_nt(k) * k_slices if wide else _ceil(k, 8))
    row_blocks = _ceil(n, A_ROWS)
    ld_ux = row_blocks * A_ROWS
    ld_vt = _ceil(m, VT_ALIGN) * VT_ALIGN
    col_slices = _ceil(m, B_COLS)
    n_seg = min(max(1, B_CTAS_PER_SM * n_sm // col_slices), row_blocks)
    seg_rows = _ceil(row_blocks, n_seg) * A_ROWS
    n_seg = _ceil(n, seg_rows)
    clusters = slice_cols = 0
    if op_bytes == 4 and not wide and m <= cluster_max_m(k):
        clusters = n_sm // C_CTAS
        if max_clusters is not None:
            clusters = min(clusters, max_clusters)
        clusters = max(1, clusters)
        slice_cols = 16 * _ceil(m, 16 * C_CTAS)
    planes = 1 + (op_bytes == 4 and wide)   # U_newᵀ's; Vᵀ's one more
    sizes = ((planes + (planes > 1)) * _ceil(np_ * ld_vt * op_bytes, 4),
             planes * _ceil(np_ * ld_ux * op_bytes, 4),
             max(row_blocks, C_CTAS * clusters) * k * k,
             max(n_seg * m * k if n_seg > 1 else 0,
                 2 * n * k if wide else 0,
                 clusters * m * k if clusters > 1 else 0))
    offsets, at = [], 0
    for size in sizes:
        offsets.append(at)
        at += _ceil(size, WORK_ALIGN) * WORK_ALIGN
    return UPassPlan(np_ // 8, k_slices, ld_vt, ld_ux, row_blocks,
                     col_slices, seg_rows, n_seg, tuple(offsets),
                     max(at, WORK_ALIGN), clusters, slice_cols)


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


@functools.lru_cache(maxsize=None)
def cluster_limit(device_index: int, k: int, slice_cols: int) -> int:
    """Clusters of the f32 cluster route at k, slices of ``slice_cols``
    columns, that the card holds at once (cudaOccupancyMaxActiveClusters:
    7 on an H100 SXM, whose 132 SMs hold no eighth group of 16)."""
    fn = _build.function("mu_fused", "pycmf_u_pass_cluster_occupancy",
                         (ctypes.c_int,) * 3 + (ctypes.c_void_p,))
    out = ctypes.c_int(0)
    rc = fn(k, slice_cols, device_index, ctypes.byref(out))
    if rc:
        _build.check(_build.load("mu_fused"), rc, "cluster occupancy")
    return out.value


_PLANS: dict = {}


def plan_for(X: torch.Tensor, k: int) -> UPassPlan:
    """The plan of a U-pass call on the card's X (n, m) at k (one lookup
    per call after the first of its shape: the host's time is part of a
    call's)."""
    key = (X.shape, X.dtype, X.device.index, k)
    plan = _PLANS.get(key)
    if plan is None:
        n, m = X.shape
        dev = X.device.index
        op = operand_dtype(X.dtype).itemsize
        plan = u_pass_plan(n, m, k, op, _sm_count(dev))
        if plan.clusters:
            plan = u_pass_plan(n, m, k, op, _sm_count(dev),
                               cluster_limit(dev, k, plan.slice_cols))
        _PLANS[key] = plan
    return plan


# X's dtype as the C entry points take it (csrc/common.cuh: XDtype)
X_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e4m3fn: 2}


def launches(X: torch.Tensor, plain, fp8, wide=None, k: int = 0):
    """The launch counter of a data-pass kernel's form for X: the U passes'
    wide route (k > K_NARROW, ``wide``) apart, then the fp8 form (e4m3 X)
    apart."""
    if wide is not None and k > K_NARROW:
        return wide
    return fp8 if X.dtype in FP8_DTYPES else plain


# leading C arguments of both entry points: X's code, X, U, V; trailing:
# clusters and slice_cols (the wide route's entries: nt and k_slices), Unew,
# numV, gramU, the four workspace parts, ld_vt, ld_ux, seg_rows, n_seg,
# device, stream
_HEAD = (ctypes.c_int,) + (ctypes.c_void_p,) * 3
_TAIL = ((ctypes.c_int,) * 2 + (ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 5
         + (ctypes.c_void_p,))


def entry(library: str, symbol: str, middle) -> object:
    """The C entry point of a U-pass library, resolved once per process."""
    return _build.function(library, symbol, _HEAD + tuple(middle) + _TAIL)


def launch_u_pass(library: str, symbol: str, middle_types, X, U, V, middle):
    """Run a U-pass entry point on X (n, m), U (n, k), V (m, k) with the
    library's own arguments ``middle`` (tensors passed by pointer, held
    until the launch is enqueued); returns (U_new, numV, gramU). At k >
    K_NARROW the call goes to the wide route's entry, ``<symbol>_wide`` in
    ``u_pass_wide``, which takes the plan's n8 tiles a slice and k_slices
    where the narrow entries take clusters and slice_cols."""
    n, m = X.shape
    k = U.shape[1]
    plan = plan_for(X, k)
    route = (plan.clusters, plan.slice_cols)
    if k > K_NARROW:
        library, symbol = "u_pass_wide", symbol + "_wide"
        route = (plan.nt // plan.k_slices, plan.k_slices)
    fn = entry(library, symbol, middle_types)
    dev = X.device.index
    work = torch.empty(plan.floats, dtype=torch.float32, device=X.device)
    # the three outputs in one allocation, viewed after the launch (the
    # host's time before it is part of the call's)
    out = torch.empty(n * k + m * k + k * k, dtype=torch.float32,
                      device=X.device)
    base, obase = work.data_ptr(), out.data_ptr()
    # the C side makes `dev` current for its launches
    rc = fn(X_CODES[X.dtype], X.data_ptr(), U.data_ptr(),
            V.data_ptr(),
            *(a.data_ptr() if isinstance(a, torch.Tensor) else a
              for a in middle), *route,
            obase, obase + 4 * n * k, obase + 4 * (n + m) * k,
            *(base + 4 * o for o in plan.offsets),
            plan.ld_vt, plan.ld_ux, plan.seg_rows, plan.n_seg, dev,
            torch._C._cuda_getCurrentRawStream(dev))
    if rc:
        _build.check(_build.load(library), rc, symbol)
    return (out[:n * k].view(n, k), out[n * k:(n + m) * k].view(m, k),
            out[(n + m) * k:].view(k, k))


def check_data_dtype(X: torch.Tensor) -> None:
    """fp8 data is float8_e4m3fn (the estimator's 'fp8'); float8_e5m2 has
    no form in these kernels and raises on every device."""
    if X.dtype in FP8_DTYPES and X.dtype != torch.float8_e4m3fn:
        raise NotImplementedError(
            f"the data-pass kernels take fp8 data as float8_e4m3fn (the "
            f"estimator's data_dtype='fp8'), got {X.dtype}")


def check_card_operands(X: torch.Tensor, U, V, k_by_k) -> None:
    """Raise on what the CUDA data-pass kernels (K1-K4) do not take."""
    if X.dim() != 2 or X.dtype not in X_CODES:
        raise NotImplementedError(
            f"the CUDA data-pass kernels take 2-D float32, bfloat16 or "
            f"float8_e4m3fn X, got {X.dtype} {tuple(X.shape)} (float64 on "
            "the card: ROADMAP C1; use use_pallas=False for the plain path)")
    n, m = X.shape
    k = U.shape[1]
    if k < 1:
        raise NotImplementedError(
            f"the CUDA data-pass kernels take k >= 1, got k={k}")
    for t, rows in ((U, n), (V, m)):
        if t.dtype != torch.float32 or t.shape != (rows, k):
            raise NotImplementedError(
                f"the CUDA data-pass kernels take float32 factors of shape "
                f"({rows}, {k}), got {t.dtype} {tuple(t.shape)} (float64 "
                "factors on the card: ROADMAP C1; use use_pallas=False)")
    for t in k_by_k:
        if t.dtype != torch.float32 or t.shape != (k, k):
            raise NotImplementedError(
                f"the CUDA data-pass kernels take float32 ({k}, {k}) matrices, "
                f"got {t.dtype} {tuple(t.shape)}")


def _acc_matmul(a: torch.Tensor, b: torch.Tensor, acc) -> torch.Tensor:
    """a @ b with both operands (already in X's operand dtype, or fp8 X,
    which widens exactly) widened to acc."""
    return torch.matmul(a.to(acc), b.to(acc))


def fused_mu_u_pass_ref(X, U, V, VtV, l1, l2, eps, n_valid=None):
    """Plain PyTorch version of :func:`fused_mu_u_pass` (same contract).
    fp8 X gives the bf16 version's result on X widened to bf16 bit for
    bit: the same products of the same values."""
    check_data_dtype(X)
    n = X.shape[0]
    acc = U.dtype
    op = operand_dtype(X.dtype)
    num_u = _acc_matmul(X, V.to(op), acc)
    unew = U * num_u / (U @ VtV + l1 + l2 * U + eps)
    nv = n if n_valid is None else int(n_valid)
    if nv < n:
        unew[nv:] = 0.0
    numv = _acc_matmul(X.mT, unew.to(op), acc)
    return unew, numv, unew.mT @ unew


def fused_mu_u_pass(X, U, V, VtV, l1, l2, eps, n_valid=None):
    """Single-call MU U-update plus V's X-side terms.

    X: (n, m) dense, float32, bfloat16 or float8_e4m3fn on the card; U:
    (n, k), V: (m, k), VtV: (k, k) float32. Returns (U_new (n, k), numV
    (m, k), gramU (k, k)). CUDA tensors launch ``csrc/mu_fused.cu`` (its
    fp8 form for e4m3 X; ``csrc/u_pass_wide.cu`` at k > 32); CPU tensors
    take :func:`fused_mu_u_pass_ref`.
    """
    check_data_dtype(X)
    if not on_card(X, U, V, VtV):
        return fused_mu_u_pass_ref(X, U, V, VtV, l1, l2, eps, n_valid)
    check_card_operands(X, U, V, (VtV,))
    out = launch_u_pass(
        "mu_fused", "pycmf_mu_fused_u_pass",
        (ctypes.c_void_p,) + (ctypes.c_int,) * 4 + (ctypes.c_float,) * 3,
        X.contiguous(), U.contiguous(), V.contiguous(),
        (VtV.contiguous(), X.shape[0], X.shape[1], U.shape[1],
         X.shape[0] if n_valid is None else int(n_valid), float(l1),
         float(l2), float(eps)))
    launches(X, LAUNCHES, LAUNCHES_FP8, LAUNCHES_WIDE, U.shape[1]).n += 1
    return out
