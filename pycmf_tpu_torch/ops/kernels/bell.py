"""Block-sparse (BlockEll) product: the layout, the CUDA kernel's wrapper
and its plain PyTorch version.

Counterpart of ``pycmf_tpu/ops/pallas/bell.py``. A sparse matrix whose
nonzeros cluster is re-laid once per fit into dense 128×128 blocks at the
block positions that hold nonzeros, sorted by row block; every row block
holds at least one block (a zero block at column 0 where it had none), so
every output row is written. ``bell_spmm`` is then a stream of dense block
products (``csrc/bell_spmm.cu``), and ⟨A, M Bᵀ⟩ is Σ((AᵀM)⊙B) over the
layout of Aᵀ (``bell_inner``).

The layout pays when the blocks are full enough: the kernel's time follows
the stored blocks, the CSR kernel's (``ops/kernels/spmm.py``) the nonzeros.
``bell_from_scipy`` refuses a layout whose fill is below ``min_fill``.

The kernel splits its work by stored blocks: each row block's blocks are
cut into segments of at most ``SEG_BLOCKS`` consecutive blocks
(:func:`bell_segments`, a function of ``bptr`` alone, built once with the
layout), one CTA per segment.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from . import _build
from .policy import check_device, launch_count, on_card

LAUNCHES = launch_count("bell_spmm")
BLOCK = 128
SLICE = 32  # output columns per CTA: at most four mma tiles of 8 columns
# Blocks per segment (one CTA each): path F's X (235 row blocks, ~13.5
# blocks each) and Xᵀ (89 row blocks, ~36 each) both give several CTAs per
# SM of an H100.
SEG_BLOCKS = 4
# Fill (nnz / stored block entries) below which the CSR kernel is faster
# than this one on the same matrix: chip_smoke's phase 3 measures the
# crossover of their device times on a block-structured 30000×11314 matrix
# (3166 blocks) and checks this constant within a factor 2 of the bf16
# value. Three runs of phase 3 on an H100 (NVIDIA H100 80GB HBM3, 700 W)
# with the segment-split tensor-core kernel and the lane-group CSR walk
# gave 0.0592, 0.0601 and 0.0593 with bf16 values (0.153-0.156 with
# float32); PERF.md lists every run. The kernels before the redesign
# crossed at 0.094-0.110, and a crossover taken with the host's time per
# call swung from 0.004 to 0.09. The same constant on every device, so the
# CPU and the card choose the same layout for the same matrix.
BELL_MIN_FILL = 0.06


@dataclasses.dataclass(frozen=True)
class BlockEll:
    """Dense-block CSR layout on one device.

    blocks : (NB, 128, 128) dense blocks at the storage dtype (0-padded)
    brows  : (NB,) int32 row block of each block, ascending
    bcols  : (NB,) int32 column block of each block
    bptr   : (ceil(p/128) + 1,) int32: the blocks of row block r are
             bptr[r] .. bptr[r+1]
    segs   : (n_seg + 1,) int32: segment s holds blocks segs[s] .. segs[s+1]
    rb_segs: (ceil(p/128) + 1,) int32: the segments of row block r are
             rb_segs[r] .. rb_segs[r+1]
    sq_norm: () Σ data², float32 under bf16 data, else the data's dtype
             (as ``CsrMatrix.sq_norm``)
    shape  : (p, q) of the matrix
    fill   : nnz / (NB · 128 · 128)
    """

    blocks: torch.Tensor
    brows: torch.Tensor
    bcols: torch.Tensor
    bptr: torch.Tensor
    segs: torch.Tensor
    rb_segs: torch.Tensor
    sq_norm: torch.Tensor
    shape: Tuple[int, int]
    fill: float

    @property
    def nbytes(self) -> int:
        return self.blocks.numel() * self.blocks.element_size()


def bell_segments(bptr: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(segs, rb_segs) for the row-block pointers ``bptr``: each row block
    of n blocks is cut into ceil(n / SEG_BLOCKS) segments of consecutive
    blocks whose sizes differ by at most one."""
    bptr = np.asarray(bptr, dtype=np.int64)
    counts = np.diff(bptr)
    nseg = -(-counts // SEG_BLOCKS)
    rb_segs = np.r_[0, np.cumsum(nseg)]
    rb = np.repeat(np.arange(counts.size), nseg)
    i = np.arange(rb.size) - rb_segs[rb]
    starts = bptr[rb] + i * counts[rb] // nseg[rb]
    return (np.r_[starts, bptr[-1]].astype(np.int32),
            rb_segs.astype(np.int32))


def bell_from_scipy(A, dtype=torch.float32, device="cuda", *,
                    max_bytes: Optional[int] = None,
                    min_fill: float = 0.0) -> Optional[BlockEll]:
    """A scipy.sparse matrix as a BlockEll on ``device`` (built on the host,
    once per fit; the card by default, as the reference's lands on its
    default device; 'cuda' without a card raises), or None when the blocks
    would take more than ``max_bytes`` at ``dtype`` or their fill is below
    ``min_fill``."""
    device = check_device(device)
    A = sp.csr_matrix(A)
    A.sum_duplicates()
    p, q = A.shape
    nrb = -(-p // BLOCK)
    ncb = -(-q // BLOCK)
    coo = A.tocoo()
    keys = (coo.row // BLOCK).astype(np.int64) * ncb + coo.col // BLOCK
    uniq = np.unique(keys)
    # a zero block at column 0 for every row block without one
    missing = np.setdiff1d(np.arange(nrb, dtype=np.int64),
                           np.unique(uniq // ncb))
    if missing.size:
        uniq = np.unique(np.concatenate([uniq, missing * ncb]))
    nb = int(uniq.size)
    fill = A.nnz / float(nb * BLOCK * BLOCK) if nb else 0.0
    itemsize = torch.empty((), dtype=dtype).element_size()
    if max_bytes is not None and nb * BLOCK * BLOCK * itemsize > max_bytes:
        return None
    if fill < min_fill:
        return None
    blocks = np.zeros((nb, BLOCK, BLOCK), dtype=np.float64)
    blocks[np.searchsorted(uniq, keys), coo.row % BLOCK,
           coo.col % BLOCK] = coo.data
    brows = (uniq // ncb).astype(np.int32)
    bptr = np.searchsorted(brows, np.arange(nrb + 1)).astype(np.int32)
    segs, rb_segs = bell_segments(bptr)

    data = torch.from_numpy(coo.data).to(dtype).to(torch.float64)
    sq = torch.sum(data ** 2).to(
        torch.float32 if dtype == torch.bfloat16 else dtype)

    def up(a):
        return torch.from_numpy(a).to(device)

    return BlockEll(torch.from_numpy(blocks).to(dtype).to(device), up(brows),
                    up((uniq % ncb).astype(np.int32)), up(bptr), up(segs),
                    up(rb_segs), sq.to(device), (int(p), int(q)), fill)


def _acc_dtype(B: torch.Tensor) -> torch.dtype:
    return torch.float64 if B.dtype == torch.float64 else torch.float32


def bell_spmm_ref(A: BlockEll, B: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`bell_spmm`: one batched product of
    every block with its rows of B, summed per row block."""
    p, q = A.shape
    k = B.shape[1]
    acc = _acc_dtype(B)
    nrb = -(-p // BLOCK)
    ncb = -(-q // BLOCK)
    Bp = B.new_zeros((ncb * BLOCK, k), dtype=acc)
    Bp[:q] = B.to(A.blocks.dtype).to(acc)
    prods = torch.bmm(A.blocks.to(acc),
                      Bp.view(ncb, BLOCK, k)[A.bcols.long()])
    out = prods.new_zeros((nrb, BLOCK, k)).index_add_(0, A.brows, prods)
    return out.reshape(nrb * BLOCK, k)[:p]


def bell_tiles(k: int) -> Tuple[int, int]:
    """(columns per slice, slices) of the kernel's output: k rounded up to
    the 8-column mma tiles in one slice for k <= SLICE, else SLICE-column
    slices (csrc/bell_spmm.cu takes the same rule from k)."""
    if k <= SLICE:
        return -(-k // 8) * 8, 1
    return SLICE, -(-k // SLICE)


def check_card_operands(A: BlockEll, B: torch.Tensor) -> None:
    """Raise on what the CUDA block-sparse kernel does not take: float32
    or bfloat16 blocks, float32 B (q, k), any k >= 1."""
    q = A.shape[1]
    if A.blocks.dtype not in (torch.float32, torch.bfloat16):
        raise NotImplementedError(
            f"the CUDA block-sparse kernel takes float32 or bfloat16 blocks, "
            f"got {A.blocks.dtype} (float64 on the card: ROADMAP C1; use "
            "use_pallas=False)")
    if B.dim() != 2 or B.shape[1] < 1 or B.dtype != torch.float32 \
            or B.shape[0] != q:
        raise NotImplementedError(
            f"the CUDA block-sparse kernel takes float32 B of shape (q, k) "
            f"with q = {q}, k >= 1; got {B.dtype} {tuple(B.shape)} (float64 "
            "factors on the card: ROADMAP C1; use use_pallas=False)")


def bell_spmm(A: BlockEll, B: torch.Tensor) -> torch.Tensor:
    """A @ B for BlockEll A (p, q) and dense B (q, k) → (p, k), float32
    (float64 for float64 B on the CPU). B is rounded to the blocks' dtype
    first, as the reference does.

    CUDA tensors launch ``csrc/bell_spmm.cu``; CPU tensors take
    :func:`bell_spmm_ref`."""
    if not on_card(A.blocks, B):
        return bell_spmm_ref(A, B)
    check_card_operands(A, B)
    p, q = A.shape
    k = B.shape[1]
    B = B.contiguous()
    kpn, n_slices = bell_tiles(k)
    n_seg = A.segs.numel() - 1
    out = torch.empty((p, k), dtype=torch.float32, device=B.device)
    bt = torch.empty((kpn * n_slices, -(-q // BLOCK) * BLOCK),
                     dtype=A.blocks.dtype, device=B.device)
    part = torch.empty((n_slices, n_seg, BLOCK, kpn), dtype=torch.float32,
                       device=B.device)
    fn = _build.function("bell_spmm", "pycmf_bell_spmm",
                         [ctypes.c_int] + [ctypes.c_void_p] * 4
                         + [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
                         + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4)
    with torch.cuda.device(B.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(int(A.blocks.dtype == torch.bfloat16), A.blocks.data_ptr(),
                A.bcols.data_ptr(), A.brows.data_ptr(), A.segs.data_ptr(),
                n_seg, A.rb_segs.data_ptr(), B.data_ptr(), p, q, k,
                bt.data_ptr(), part.data_ptr(), out.data_ptr(), stream)
    _build.check(_build.load("bell_spmm"), rc, "bell_spmm")
    LAUNCHES.n += 1
    return out


def bell_inner(At_bell: BlockEll, M: torch.Tensor,
               B: torch.Tensor) -> torch.Tensor:
    """⟨A, M Bᵀ⟩ = Σ((AᵀM) ⊙ B), with At_bell the layout of Aᵀ; M (p, k),
    B (q, k)."""
    return torch.sum(bell_spmm(At_bell, M) * B.to(M.dtype))
