"""Batched k×k solves: the CUDA kernels' wrappers, their launch plan and
their plain PyTorch versions.

Counterpart of ``pycmf_tpu/ops/pallas/batched_solve.py:74`` (the TPU
kernel's Cholesky for k <= 32, ``jnp.linalg.solve`` above) and of the full
Hessian form's ``jnp.linalg.solve`` at ``pycmf_tpu/solvers/newton.py:308``:
(H[i] + H_shared) d[i] = G[i] for every i, with an optional k×k H_shared
added to every system as the kernel reads it (the Newton solver's per-row
Hessians plus their shared part; no (p, k, k) sum is written). SPD systems
(:func:`batched_spd_solve`; the Gauss-Newton Hessians are, by
construction: H ⪰ (l2 + hessian_pertubation)·I) take an unpivoted
Cholesky; :func:`batched_lu_solve` (the full form, maybe indefinite) LU
with getrf's partial pivoting. A system that is not SPD, or is singular,
gives NaN in its own row, with no host sync.

The kernels are ``csrc/batched_solve.cu`` and, for the wide route, its own
library ``csrc/batched_solve_wide.cu``. SPD: a row of a system per lane up
to k = 32 (``batched_spd_solve``), a warp per system up to MAX_K = 64
(``batched_spd_solve_wide``: lane l holds row l and, for l < KP - 32, row
KP - 1 - l in registers, KP = k rounded up to 4, :func:`wide_rows`), and
above that the blocked route (``batched_spd_solve_block``, which
:func:`batched_spd_solve_block` also takes at any k). LU
(``batched_lu_solve``): a warp per system up to k = 32, the blocked route
above. Bound: bytes at the main path's shapes (11314 SPD systems of
100×100 read 262 MB of their lower triangles: 0.078 ms at an H100's
3.35 TB/s), operations from k = 128.
A column-at-a-time factorization is bound instead by its ~3k barriers and
k³/3 shared-memory round trips per system; the blocked route
works by panels of NB = 16 columns: one warp factors Cholesky's diagonal
block, the CTA LU's panel (a row per thread in registers, two barriers a
column), and the trailing matrix takes a 4×4 register tile per thread per
panel, so each entry makes one shared-memory round trip per panel.
:func:`solve_plan` decides where a system lies, by measurements on an
H100: one CTA's shared memory up to ``block_max_k`` (SPD as a packed lower
triangle, seven CTAs an SM at k = 100, which beat two buffers with the next
system's copy in flight); past that a global scratch slot per CTA, two an
SM (faster than slots within the L2 and than thread-block clusters), the
work area in shared memory while it fits, else in the slot too, so that
any k runs; the scratch is allocated here before the launch. Every route
is capturable in a CUDA graph and repeats bit for bit; the blocked
variants give the same bits as each other.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from . import _build
from .mu_fused import _sm_count
from .policy import launch_count, on_card

LAUNCHES = launch_count("batched_spd_solve")
WIDE_LAUNCHES = launch_count("batched_spd_solve_wide")
BLOCK_LAUNCHES = launch_count("batched_spd_solve_block")
LU_LAUNCHES = launch_count("batched_lu_solve")
NARROW_K = 32  # a row of H per lane of one warp, in registers
MAX_K = 64     # above NARROW_K: up to two rows per lane (wide_rows)
NB = 16        # panel width of the blocked routes (csrc: kNB)
BLOCK_THREADS = 256
# global scratch slots an SM above block_max_k: the CTAs of BLOCK_THREADS
# an SM holds (csrc: __launch_bounds__(kBlockThreads, 2))
SCRATCH_PER_SM = 2
# where a system lies (csrc: Place): one CTA's shared memory; its rows in a
# scratch slot; its rows and the work area in the slot
SHARED, SLOT_ROWS, SLOT_ALL = 0, 1, 2
_ARGTYPES = ((ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 2
             + (ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p))
_BLOCK_ARGTYPES = ((ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 3
                   + (ctypes.c_void_p,) * 2 + (ctypes.c_int,) * 4
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
    be SPD; one that is not gives NaN in its own row (on the card's wide
    route so does a pivot below the least normal float32, which its
    flush-to-zero reciprocal square root cannot take).

    The card's kernel adds H_shared to each system as it reads it, so the
    (p, k, k) sum is never written. CUDA tensors (float32) launch
    ``csrc/batched_solve.cu``: one row per lane up to NARROW_K, the wide
    route (``csrc/batched_solve_wide.cu``) up to MAX_K, the block route
    above; CPU tensors take :func:`batched_spd_solve_ref`."""
    p, k, _ = H.shape
    if p == 0:
        return G.new_empty((0, k))
    ops = (H, G) if H_shared is None else (H, G, H_shared)
    if not on_card(*ops):
        return batched_spd_solve_ref(H, G, H_shared)
    _check_card_operands(ops, p, k)
    if k > MAX_K:
        return batched_spd_solve_block(H, G, H_shared)
    H, G = H.contiguous(), G.contiguous()
    hs = None if H_shared is None else H_shared.contiguous()
    out = torch.empty_like(G)
    lib, entry, counter = (
        ("batched_solve", "pycmf_batched_spd_solve", LAUNCHES)
        if k <= NARROW_K else
        ("batched_solve_wide", "pycmf_batched_wide_solve", WIDE_LAUNCHES))
    fn = _build.function(lib, entry, _ARGTYPES)
    dev = H.get_device()
    # the C side makes `dev` current for its launch
    rc = fn(H.data_ptr(), None if hs is None else hs.data_ptr(),
            G.data_ptr(), p, k, out.data_ptr(), dev,
            torch._C._cuda_getCurrentRawStream(dev))
    if rc:
        _build.check(_build.load(lib), rc, "batched_spd_solve")
    counter.n += 1
    return out


def batched_spd_solve_block(H, G, H_shared=None):
    """:func:`batched_spd_solve` by the blocked route at any k (the route
    of k > MAX_K; at smaller k the yardstick of the narrow and wide
    routes). CPU tensors take :func:`batched_spd_solve_ref`."""
    p, k, _ = H.shape
    if p == 0:
        return G.new_empty((0, k))
    ops = (H, G) if H_shared is None else (H, G, H_shared)
    if not on_card(*ops):
        return batched_spd_solve_ref(H, G, H_shared)
    _check_card_operands(ops, p, k)
    out = _block_solve(H, G, H_shared, lu=False)
    BLOCK_LAUNCHES.n += 1
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


def _round4(k: int) -> int:
    return (k + 3) & ~3


def wide_rows(k: int):
    """The rows of a k x k system (32 < k <= 64) each lane of the wide
    route's warp holds (csrc/batched_solve_wide.cu: chol_solve_wide_kernel):
    row l and, for l < KP - 32, row KP - 1 - l, KP = k rounded up to 4
    (rows k..KP-1 an identity block). Its entries of the lower triangle,
    and of g, are those rows'."""
    kp = _round4(k)
    return [(lane,) + ((kp - 1 - lane,) if lane < kp - 32 else ())
            for lane in range(32)]


def block_ld(k: int) -> int:
    """Row stride of a system in the blocked routes (csrc: block_ld): room
    for [H | g], a multiple of 4 whose quarter is odd."""
    ld = _round4(k + 1)
    return ld if ld & 7 else ld + 4


def packed_row(i: int) -> int:
    """Offset of row i of a lower triangle packed with its rows padded to a
    multiple of 4 (csrc: packed_row)."""
    q, s = divmod(i, 4)
    return 4 * (q + 1) * (2 * q + s)


def block_rows_floats(k: int, packed: bool) -> int:
    """Floats of a system's rows (csrc: block_rows_floats): the packed lower
    triangle (SPD in shared memory), else whole rows at block_ld(k)."""
    return packed_row(_round4(k)) if packed else _round4(k) * block_ld(k)


def block_work_floats(k: int, lu: bool) -> int:
    """Floats of the blocked routes' work area (csrc: block_work_floats):
    the transposed panel, LU's panel or SPD's diagonal block, g and the
    pivots' reciprocals."""
    kr = _round4(k)
    return NB * block_ld(k) + (kr * (NB + 1) if lu else NB * (NB + 3)) \
        + 2 * kr


def block_smem_floats(k: int, lu: bool, place: int = SHARED) -> int:
    """Shared floats of one CTA of the blocked routes (csrc:
    block_smem_floats, which the C entry checks the plan against): what
    of the rows and the work area ``place`` leaves in shared memory, and a
    few panel-sized buffers; with SLOT_ALL the same for every k."""
    f = 2 * NB + (16 + 4 * NB + 4 if lu else 0)
    if place != SLOT_ALL:
        f += block_work_floats(k, lu)
    if place == SHARED:
        f += block_rows_floats(k, not lu)
    return f


def block_slot_floats(k: int, lu: bool, place: int) -> int:
    """Floats of one global scratch slot (csrc: block_slot_floats): a
    system's whole rows, and with SLOT_ALL the work area."""
    return block_rows_floats(k, False) \
        + (block_work_floats(k, lu) if place == SLOT_ALL else 0)


@dataclass(frozen=True)
class SolvePlan:
    """How one call of the batched solve runs on the card.

    route: 'narrow' (k <= 32, a warp per system), 'wide' (<= 64, SPD),
    'lu_warp' (LU at k <= 32, a warp per system), 'block' (a CTA per
    system in shared memory) or 'scratch' (a CTA per global slot,
    ``slots`` of ``slot_floats`` each, walking the systems; ``place``
    SLOT_ROWS, or SLOT_ALL where the work area leaves shared memory too).
    ``threads`` and ``smem`` (bytes per CTA) are the blocked routes'
    launch."""
    route: str
    place: int = SHARED
    threads: int = 0
    smem: int = 0
    slots: int = 0
    slot_floats: int = 0


def block_threads(k: int, lu: bool) -> int:
    """Threads per CTA of the blocked routes (measured on an H100: fewer
    threads let more systems share an SM at small k; every count gives
    the same bits)."""
    if k <= (MAX_K if lu else 100):
        return 64
    return 128 if k <= 128 else BLOCK_THREADS


def solve_plan(p: int, k: int, lu: bool, optin: int, sms: int) -> SolvePlan:
    """The route of p systems of k × k on a card whose CTAs may take
    ``optin`` bytes of shared memory, with ``sms`` SMs: the one place the
    crossovers are decided. One CTA per system while its shared memory
    holds the system (to ``block_max_k``); past that SCRATCH_PER_SM global
    scratch slots an SM, whatever their bytes, the work area in shared
    memory while it fits, else in the slot too (any k). On an H100 these
    slots beat slots within the L2 and 2- or 4-CTA clusters at every k
    measured, and the work area in shared memory beat it in the slot."""
    if not lu and k <= NARROW_K:
        return SolvePlan("narrow")
    if not lu and k <= MAX_K:
        return SolvePlan("wide")
    return blocked_plan(p, k, lu, optin, sms)


def blocked_plan(p: int, k: int, lu: bool, optin: int,
                 sms: int) -> SolvePlan:
    """:func:`solve_plan`'s blocked part, at any k: LU's warp per system
    at k <= NARROW_K, else one CTA per system or the scratch slots."""
    if lu and k <= NARROW_K:
        return SolvePlan("lu_warp")
    threads = block_threads(k, lu)
    smem = 4 * block_smem_floats(k, lu)
    if smem <= optin:
        return SolvePlan("block", SHARED, threads, smem)
    place = SLOT_ROWS
    if 4 * block_smem_floats(k, lu, place) > optin:
        place = SLOT_ALL
    return SolvePlan("scratch", place, threads,
                     4 * block_smem_floats(k, lu, place),
                     min(p, SCRATCH_PER_SM * sms),
                     block_slot_floats(k, lu, place))


@functools.lru_cache(maxsize=None)
def smem_optin(device_index: int) -> int:
    """Bytes of shared memory one CTA may opt in to on this card."""
    fn = _build.function("batched_solve", "pycmf_block_solve_optin",
                         (ctypes.c_int,))
    return int(fn(device_index))


@functools.lru_cache(maxsize=None)
def block_max_k(device_index: int, lu: bool = False) -> int:
    """Largest k whose system the block (or, ``lu``, the LU) route keeps in
    one CTA's shared memory on this card (above it: the scratch slots)."""
    optin = smem_optin(device_index)
    return max(k for k in range(MAX_K + 1, 4096)
               if 4 * block_smem_floats(k, lu) <= optin)


def _block_solve(H, G, H_shared, lu: bool):
    """One launch of the block (SPD) or LU route on card operands."""
    p, k, _ = H.shape
    H, G = H.contiguous(), G.contiguous()
    hs = None if H_shared is None else H_shared.contiguous()
    out = torch.empty(G.shape, dtype=G.dtype, device=G.device)
    dev = H.get_device()
    plan = blocked_plan(p, k, lu, smem_optin(dev), _sm_count(dev))
    scratch = None
    if plan.slots:
        scratch = torch.empty(plan.slots * plan.slot_floats,
                              dtype=torch.float32, device=H.device)
    fn = _build.function("batched_solve", "pycmf_batched_block_solve",
                         _BLOCK_ARGTYPES)
    rc = fn(H.data_ptr(), None if hs is None else hs.data_ptr(),
            G.data_ptr(), p, k, int(lu), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(), plan.slots,
            plan.threads, plan.smem, dev,
            torch._C._cuda_getCurrentRawStream(dev))
    if rc:
        _build.check(_build.load("batched_solve"), rc,
                     "batched_lu_solve" if lu else "batched_spd_solve")
    return out
