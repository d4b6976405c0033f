"""The port's in-memory sparse path against the reference's, on the CPU.

- ops/sparse.py against pycmf_tpu.ops.sparse at float64, rtol 1e-12;
- the plain versions of the sparse kernels (the CPU path of their
  wrappers) against the Pallas kernels whose contracts they serve, run in
  interpret mode as the JAX suite runs them: csr_spmm against spmm_tiled
  and onehot_spmm, csr_spmm on the CSR of Aᵀ against onehot_spmm_t,
  csr_rowdots against sddmm_rowdots_tiled, bell_spmm against bell_spmm,
  fused_mu_update against fused_mu_update. float64 at rtol 1e-12 where
  the reference kernel takes float64; the one-hot strips take float32 or
  bf16 only: rtol 1e-5 (f32 sums in two orders);
- as_coupled's CSR branch: norms, transpose, layout choice by fill;
- CMF fits on CSR X (MU; Newton with linear X and linear or sigmoid Y; a
  block-structured X that takes BlockEll), both use_pallas settings:
  float64 loss histories and factors at rtol 1e-9, iteration counts;
- transform on CSR input, and the mu_dense_reg golden on the CSR path.
"""
import warnings
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from pycmf_tpu import CMF as JCMF
from pycmf_tpu.ops import losses as jlosses
from pycmf_tpu.ops import sparse as jsparse
from pycmf_tpu.ops.pallas import bell as jbell
from pycmf_tpu.ops.pallas import onehot as jonehot
from pycmf_tpu.ops.pallas.mu_update import fused_mu_update as j_mu_update
from pycmf_tpu.ops.pallas.spmm import (sddmm_rowdots_tiled, spmm_tiled,
                                       tile_csr_from_matrix)
from pycmf_tpu.solvers import newton as jnewton
from pycmf_tpu.utils.validation import as_coupled as j_as_coupled
from pycmf_tpu_torch import CMF
from pycmf_tpu_torch.ops import losses as tlosses
from pycmf_tpu_torch.ops import sparse as tsparse
from pycmf_tpu_torch.ops.kernels import bell as tbell
from pycmf_tpu_torch.ops.kernels import mu_update as tmu_update
from pycmf_tpu_torch.ops.kernels import policy
from pycmf_tpu_torch.ops.kernels import spmm as tspmm
from pycmf_tpu_torch.solvers import newton as tnewton
from pycmf_tpu_torch.utils.datasets import block_sparse_matrix
from pycmf_tpu_torch.utils.validation import as_coupled
from tests.conftest import make_problem


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float64).numpy()
    return np.asarray(x, dtype=np.float64)


def _scattered(rng, p=60, q=40, density=0.1):
    return sp.random(p, q, density=density, format="csr", random_state=rng,
                     data_rvs=lambda n: rng.rand(n) + 0.5)


def _sparse_problem(rng, n=60, **kw):
    """make_problem's sparse X (30% of entries) thinned to about half its
    nonzeros, so its 128×128 block fills below BELL_MIN_FILL and the fit
    runs the CSR path."""
    X, Y = make_problem(rng, n=n, sparse=True, **kw)
    X = sp.csr_matrix(X.multiply(rng.rand(*X.shape) < 0.5))
    X.eliminate_zeros()
    assert tbell.bell_from_scipy(X, device="cpu").fill < tbell.BELL_MIN_FILL
    return X, Y


def _jdt(tdt):
    return jnp.float64 if tdt == torch.float64 else jnp.float32


def _pair_csr(A, dtype="float64"):
    tdt = {"float64": torch.float64, "float32": torch.float32,
           "bfloat16": torch.bfloat16}[dtype]
    return (jsparse.csr_from_scipy(A, dtype=getattr(jnp, dtype)),
            tsparse.csr_from_scipy(A, tdt, device="cpu"))


# -- ops/sparse.py -----------------------------------------------------------

@pytest.mark.parametrize("op", ["spmm", "sddmm_rowdots", "sddmm_dot",
                                "row_sq_norms", "to_dense"])
def test_sparse_op_matches_reference_f64(rng, op):
    A = _scattered(rng)
    Aj, At = _pair_csr(A)
    M, B = rng.randn(60, 5), rng.randn(40, 5)
    args = {"spmm": (B,), "sddmm_rowdots": (M, B), "sddmm_dot": (M, B),
            "row_sq_norms": (), "to_dense": ()}[op]
    want = getattr(jsparse, op)(Aj, *(jnp.asarray(a) for a in args))
    got = getattr(tsparse, op)(At, *(torch.from_numpy(a) for a in args))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
def test_csr_from_scipy_matches_reference(rng, dtype):
    """Duplicates summed; int32 indices; sq_norm of the stored values in
    float64, cast to float32 under bf16 (and the data's dtype otherwise)."""
    A = _scattered(rng).tocoo()
    A = sp.coo_matrix((np.r_[A.data, 1.5], (np.r_[A.row, A.row[0]],
                                             np.r_[A.col, A.col[0]])),
                      shape=A.shape)
    Aj, At = _pair_csr(A, dtype)
    for f in ("data", "indices", "indptr", "row_ids"):
        np.testing.assert_array_equal(_np(getattr(At, f)),
                                      _np(getattr(Aj, f)))
    assert At.indices.dtype == torch.int32 and At.shape == Aj.shape
    assert At.sq_norm.dtype == {"bfloat16": torch.float32}.get(
        dtype, getattr(torch, dtype))
    assert float(At.sq_norm) == float(Aj.sq_norm)


def test_csr_transpose_host(rng):
    A = _scattered(rng)
    C, Ct = tsparse.csr_transpose_host(A, torch.float64, device="cpu")
    np.testing.assert_array_equal(_np(tsparse.to_dense(Ct)),
                                  A.toarray().T)
    assert Ct.shape == (40, 60)


# -- the sparse kernels' plain versions against the Pallas kernels ----------

@pytest.mark.parametrize("dtype", ["float64", "bfloat16"])
def test_csr_spmm_ref_matches_spmm_tiled(rng, dtype):
    """bf16 values widen exactly against float32 B in both (rtol 1e-5: f32
    sums in two orders)."""
    A = _scattered(rng)
    B = rng.randn(40, 6)
    bdt = torch.float64 if dtype == "float64" else torch.float32
    want = spmm_tiled(tile_csr_from_matrix(jsparse.csr_from_scipy(
        A, getattr(jnp, dtype))), jnp.asarray(B, _jdt(bdt)))
    got = tspmm.csr_spmm(tsparse.csr_from_scipy(A, getattr(torch, dtype),
                                                device="cpu"),
                         torch.from_numpy(B).to(bdt))
    assert got.dtype == bdt
    np.testing.assert_allclose(_np(got), _np(want),
                               rtol=1e-12 if dtype == "float64" else 1e-5,
                               atol=1e-14)


@pytest.mark.parametrize("transposed", [False, True])
def test_csr_spmm_ref_matches_onehot_f32(rng, transposed):
    """A @ B against onehot_spmm; Aᵀ @ B (csr_spmm on the CSR of Aᵀ)
    against onehot_spmm_t over A's own strips. The strips take float32 or
    bf16 only, and under bf16 they also round B and the scaled rows of B to
    bf16 (a TPU precision choice the CSR contract does not make), so the
    comparison is at float32 storage."""
    A = _scattered(rng)
    L = jonehot.onehot_from_scipy(A, jnp.float32)
    C, Ct = tsparse.csr_transpose_host(A, torch.float32, device="cpu")
    B = np.abs(rng.randn(60 if transposed else 40, 6)).astype(np.float32)
    if transposed:
        want = jonehot.onehot_spmm(jonehot.OneHotStripsT(L), jnp.asarray(B))
    else:
        want = jonehot.onehot_spmm(L, jnp.asarray(B))
    got = tspmm.csr_spmm(Ct if transposed else C, torch.from_numpy(B))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-6)


def test_csr_rowdots_ref_matches_sddmm_tiled_f64(rng):
    A = _scattered(rng)
    M, B = rng.randn(60, 5), rng.randn(40, 5)
    want = sddmm_rowdots_tiled(tile_csr_from_matrix(jsparse.csr_from_scipy(
        A, jnp.float64)), jnp.asarray(M), jnp.asarray(B))
    got = tspmm.csr_rowdots(tsparse.csr_from_scipy(A, torch.float64,
                                                   device="cpu"),
                            torch.from_numpy(M), torch.from_numpy(B))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-12, atol=1e-13)


@pytest.mark.parametrize("dtype", ["float64", "bfloat16"])
def test_bell_spmm_ref_matches_pallas(rng, dtype):
    """B is rounded to the blocks' dtype in both; bf16 products are exact
    in float32, summed in two orders (rtol 1e-5)."""
    A = block_sparse_matrix(384, 256, 0.5, rng)
    B = rng.rand(256, 6)
    Lj = jbell.bell_from_scipy(A, getattr(jnp, dtype))
    Lt = tbell.bell_from_scipy(A, getattr(torch, dtype), device="cpu")
    for f in ("brows", "bcols"):
        np.testing.assert_array_equal(_np(getattr(Lt, f)),
                                      _np(getattr(Lj, f)))
    assert Lt.fill == Lj.fill and Lt.shape == Lj.shape
    np.testing.assert_array_equal(_np(Lt.blocks), _np(Lj.blocks))
    Bj = jnp.asarray(B, jnp.float64 if dtype == "float64" else jnp.float32)
    Bt = torch.from_numpy(B).to(torch.float64 if dtype == "float64"
                                else torch.float32)
    want = jbell.bell_spmm(Lj, Bj)
    got = tbell.bell_spmm(Lt, Bt)
    rtol = 1e-12 if dtype == "float64" else 1e-5
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol)
    M = rng.rand(384, 6)
    Ltt = tbell.bell_from_scipy(A.T, getattr(torch, dtype), device="cpu")
    Ljt = jbell.bell_from_scipy(A.T.tocsr(), getattr(jnp, dtype))
    np.testing.assert_allclose(
        float(tbell.bell_inner(Ltt, torch.from_numpy(M).to(Bt.dtype), Bt)),
        float(jbell.bell_inner(Ljt, jnp.asarray(M, Bj.dtype), Bj)),
        rtol=rtol)


def test_bell_from_scipy_refusals(rng):
    A = block_sparse_matrix(384, 256, 0.5, rng)
    L = tbell.bell_from_scipy(A, device="cpu")
    assert L.bptr.tolist()[-1] == L.blocks.shape[0]
    assert torch.all(L.brows[L.bptr[:-1].long()] == torch.arange(3))
    assert tbell.bell_from_scipy(A, max_bytes=L.nbytes - 1,
                                 device="cpu") is None
    assert tbell.bell_from_scipy(A, min_fill=L.fill + 1e-9,
                                 device="cpu") is None
    # a row block with no nonzeros gets a zero block at column 0
    E = sp.csr_matrix(A.toarray() * (np.arange(384) >= 128)[:, None])
    Le = tbell.bell_from_scipy(E, device="cpu")
    assert Le.brows.tolist()[0] == 0 and Le.bcols.tolist()[0] == 0
    assert float(Le.blocks[0].abs().sum()) == 0.0


@pytest.mark.parametrize("counts", [[1], [1, 1, 1], [4, 5, 1, 9],
                                    [36, 13, 2, 8, 3]])
def test_bell_segments_cover_each_block_once(counts):
    """The kernel's work list: every stored block in exactly one segment,
    in order; no segment crosses a row block; at most SEG_BLOCKS blocks a
    segment, balanced within a row block; a row block of one block is one
    segment."""
    bptr = np.r_[0, np.cumsum(counts)]
    segs, rb_segs = tbell.bell_segments(bptr)
    assert segs.dtype == rb_segs.dtype == np.int32
    assert segs[0] == 0 and segs[-1] == bptr[-1]
    sizes = np.diff(segs)
    assert np.all(sizes >= 1) and np.all(sizes <= tbell.SEG_BLOCKS)
    assert rb_segs[0] == 0 and rb_segs[-1] == sizes.size
    for r, n in enumerate(counts):
        s0, s1 = rb_segs[r], rb_segs[r + 1]
        assert segs[s0] == bptr[r] and segs[s1] == bptr[r + 1]
        assert s1 - s0 == -(-n // tbell.SEG_BLOCKS)
        assert np.ptp(sizes[s0:s1]) <= 1
        if n == 1:
            assert s1 - s0 == 1


def test_bell_from_scipy_carries_its_segments(rng):
    """Path F's shape in miniature: a row block with more blocks than one
    segment and a row block holding only the zero filler block."""
    A = block_sparse_matrix(384, 1280, 0.6, rng).tolil()
    A[128:256, :] = 0
    L = tbell.bell_from_scipy(sp.csr_matrix(A), device="cpu")
    segs, rb_segs = tbell.bell_segments(L.bptr.numpy())
    np.testing.assert_array_equal(L.segs.numpy(), segs)
    np.testing.assert_array_equal(L.rb_segs.numpy(), rb_segs)
    assert int(L.bptr[2] - L.bptr[1]) == 1          # the filler block
    assert int(L.rb_segs[2] - L.rb_segs[1]) == 1
    assert int(np.diff(L.rb_segs.numpy()).max()) > 1


@pytest.mark.parametrize("nnz", [1, 15, 16, 17, 873651, 10 ** 6,
                                 60_651_325])
@pytest.mark.parametrize("n_sm", [1, 132])
def test_csr_chunk_rule_and_workspace(nnz, n_sm):
    """The chunk size handed to the CSR kernel is a power of two in range
    and a multiple of its eight-nonzero step, and the workspace holds both
    partial slots (2c, 2c + 1) of every chunk c the kernel walks."""
    ch = tspmm.chunk_size(nnz, n_sm)
    assert tspmm.CHUNK_MIN <= ch <= tspmm.CHUNK_MAX
    assert ch & (ch - 1) == 0 and ch % 8 == 0
    n_chunks = -(-nnz // ch)
    assert (n_chunks - 1) * ch < nnz <= n_chunks * ch
    for kw in (1, 20, 32):
        floats = tspmm.workspace_floats(nnz, kw, ch)
        assert floats == 2 * n_chunks * kw
        assert (2 * (n_chunks - 1) + 1) * kw + kw <= floats
    if n_sm == 132:
        # the 20NG surrogate fills the card with small chunks, the RCV1
        # shape takes the largest
        assert tspmm.chunk_size(873651, n_sm) == 16
        assert tspmm.chunk_size(60_651_325, n_sm) == tspmm.CHUNK_MAX


@pytest.mark.parametrize("k", [1, 7, 20, 32])
def test_csr_factor_padding(k):
    """Factors reach the CSR kernel as rows of a multiple of 4 floats,
    zero past k, 16-byte aligned; an aligned k = 4j factor goes as is."""
    t = torch.arange(3 * (k + 1), dtype=torch.float32).view(3, k + 1)[:, 1:]
    ld = -(-k // 4) * 4
    got = tspmm._padded(t, ld)
    assert got.shape == (3, ld) and got.is_contiguous()
    assert got.data_ptr() % 16 == 0
    assert torch.equal(got[:, :k], t) and not got[:, k:].any()
    full = torch.ones(5, ld)
    assert tspmm._padded(full, ld) is full


@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
def test_bell_sq_norm_matches_csr(rng, dtype):
    """A BlockEll carries the CSR's Σ data² of the stored values, bit for
    bit (float32 under bf16 data)."""
    A = block_sparse_matrix(384, 256, 0.5, rng)
    L = tbell.bell_from_scipy(A, getattr(torch, dtype), device="cpu")
    C = tsparse.csr_from_scipy(A, getattr(torch, dtype), device="cpu")
    assert L.sq_norm.dtype == C.sq_norm.dtype
    assert float(L.sq_norm) == float(C.sq_norm)


def test_mu_update_ref_matches_pallas_f64(rng):
    M, num = np.abs(rng.randn(61, 5)), np.abs(rng.randn(61, 5))
    S = np.abs(rng.randn(5, 5))
    want = j_mu_update(jnp.asarray(M), jnp.asarray(S), jnp.asarray(num),
                       0.1, 0.2, 1e-10)
    got = tmu_update.fused_mu_update(torch.from_numpy(M), torch.from_numpy(S),
                                     torch.from_numpy(num), 0.1, 0.2, 1e-10)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-12)


# -- k > 32 (the CUDA kernels take it in 32-column slices) -------------------

_WIDE_K = [33, 40, 64]


@pytest.mark.parametrize("k", _WIDE_K)
def test_csr_spmm_ref_matches_spmm_tiled_wide_k(rng, k):
    A = _scattered(rng)
    B = rng.randn(40, k)
    want = spmm_tiled(tile_csr_from_matrix(jsparse.csr_from_scipy(
        A, jnp.float64)), jnp.asarray(B))
    got = tspmm.csr_spmm(tsparse.csr_from_scipy(A, torch.float64,
                                                device="cpu"),
                         torch.from_numpy(B))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("k", _WIDE_K)
def test_csr_rowdots_ref_matches_sddmm_tiled_wide_k(rng, k):
    A = _scattered(rng)
    M, B = rng.randn(60, k), rng.randn(40, k)
    want = sddmm_rowdots_tiled(tile_csr_from_matrix(jsparse.csr_from_scipy(
        A, jnp.float64)), jnp.asarray(M), jnp.asarray(B))
    got = tspmm.csr_rowdots(tsparse.csr_from_scipy(A, torch.float64,
                                                   device="cpu"),
                            torch.from_numpy(M), torch.from_numpy(B))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-12, atol=1e-13)


@pytest.mark.parametrize("k", _WIDE_K)
def test_bell_spmm_ref_matches_pallas_wide_k(rng, k):
    A = block_sparse_matrix(384, 256, 0.5, rng)
    B = rng.rand(256, k)
    want = jbell.bell_spmm(jbell.bell_from_scipy(A, jnp.float64),
                           jnp.asarray(B))
    got = tbell.bell_spmm(
        tbell.bell_from_scipy(A, torch.float64, device="cpu"),
        torch.from_numpy(B))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-12)


@pytest.mark.parametrize("k", _WIDE_K)
def test_mu_update_ref_matches_pallas_f64_wide_k(rng, k):
    M, num = np.abs(rng.randn(61, k)), np.abs(rng.randn(61, k))
    S = np.abs(rng.randn(k, k))
    want = j_mu_update(jnp.asarray(M), jnp.asarray(S), jnp.asarray(num),
                       0.1, 0.2, 1e-10)
    got = tmu_update.fused_mu_update(torch.from_numpy(M), torch.from_numpy(S),
                                     torch.from_numpy(num), 0.1, 0.2, 1e-10)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-12)


@pytest.mark.parametrize("k", [1, 8, 32, 33, 64, 100, 128])
def test_bell_tiles_cover_each_column_once(k):
    """csrc/bell_spmm.cu's output slices: one slice of k rounded up to 8
    for k <= 32, else 32-column slices, which cover 0 .. k-1 once."""
    kpn, n_slices = tbell.bell_tiles(k)
    assert kpn % 8 == 0 and kpn * n_slices >= k > kpn * (n_slices - 1)
    cols = [c for s in range(n_slices)
            for c in range(s * kpn, min(k, (s + 1) * kpn))]
    assert cols == list(range(k))
    assert n_slices == 1 or kpn == tbell.SLICE


@pytest.mark.parametrize("k", [1, 32, 33, 64, 100])
def test_csr_slices_and_rowdots_workspace(k):
    """csrc/csr_spmm.cu walks k in 32-column slices: csr_spmm's partials
    lie side by side (2 slots per chunk and output column), csr_rowdots
    keeps one partial column per slice and, with more than one slice,
    each slice's row dots."""
    nnz, ch, p = 1000, 16, 300
    n_chunks = -(-nnz // ch)
    n_slices = -(-k // tspmm.SLICE)
    assert tspmm.workspace_floats(nnz, k, ch) == 2 * n_chunks * k
    want = 2 * n_chunks * n_slices + (n_slices * p if n_slices > 1 else 0)
    assert tspmm.rowdots_workspace_floats(nnz, k, ch, p) == want
    widths = [min(tspmm.SLICE, k - tspmm.SLICE * s) for s in range(n_slices)]
    assert sum(widths) == k and all(0 < w <= 8 * 4 for w in widths)


@pytest.mark.parametrize("k", [1, 32, 33, 64, 100, 128])
def test_sparse_card_operand_checks_take_any_k(rng, k):
    """The CUDA sparse wrappers' operand checks, called directly: any k
    for f32 or bf16 values and f32 factors; float64 refused naming
    ROADMAP C1."""
    A = _scattered(rng)
    for dt in (torch.float32, torch.bfloat16):
        C = tsparse.csr_from_scipy(A, dt, device="cpu")
        assert tspmm._check_card_operands(
            C, ((torch.zeros(60, k), 60), (torch.zeros(40, k), 40))) == k
        L = tbell.bell_from_scipy(A, dt, device="cpu")
        tbell.check_card_operands(L, torch.zeros(40, k))
    tmu_update.check_card_operands(torch.zeros(5, k), torch.zeros(k, k),
                                   torch.zeros(5, k))
    with pytest.raises(NotImplementedError, match="ROADMAP C1"):
        tspmm._check_card_operands(tsparse.csr_from_scipy(A, torch.float64,
                                                          device="cpu"),
                                   ((torch.zeros(40, k), 40),))
    with pytest.raises(NotImplementedError, match="ROADMAP C1"):
        tbell.check_card_operands(
            tbell.bell_from_scipy(A, torch.float64, device="cpu"),
            torch.zeros(40, k))
    with pytest.raises(NotImplementedError, match="ROADMAP C1"):
        tmu_update.check_card_operands(torch.zeros(5, k, dtype=torch.float64),
                                       torch.zeros(k, k), torch.zeros(5, k))


# -- losses ------------------------------------------------------------------

@pytest.mark.parametrize("use_pallas", [True, False])
def test_reconstruction_term_csr_f64(rng, use_pallas):
    """sq_norm and ⟨A, M Bᵀ⟩ at the nonzeros (the row-dot kernel under
    use_pallas)."""
    A = _scattered(rng)
    Aj, At = _pair_csr(A)
    M, B = rng.randn(60, 5) * 0.3, rng.randn(40, 5) * 0.3
    want = jlosses.reconstruction_term(Aj, jnp.asarray(M), jnp.asarray(B),
                                       "linear")
    got = tlosses.reconstruction_term(At, torch.from_numpy(M),
                                      torch.from_numpy(B), "linear",
                                      use_pallas=use_pallas)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-12)


@pytest.mark.parametrize("layout", ["csr", "bell"])
def test_sigmoid_term_on_sparse_layout_raises(rng, layout):
    """A sigmoid term over a BlockEll layout raises (the estimator never
    makes one for a sigmoid-linked matrix); over CSR it is the reference's
    ΣS² + Σ_nnz(a² − 2a·S), f64 rtol 1e-12."""
    A = block_sparse_matrix(384, 256, 0.5, rng)
    L = (tsparse.csr_from_scipy(A, torch.float64, device="cpu")
         if layout == "csr"
         else tbell.bell_from_scipy(A, torch.float64, device="cpu"))
    assert tsparse.is_sparse(L)
    M, B = 0.3 * rng.randn(384, 3), 0.3 * rng.randn(256, 3)
    if layout == "csr":
        want = jlosses.reconstruction_term(
            jsparse.csr_from_scipy(A, dtype=jnp.float64), jnp.asarray(M),
            jnp.asarray(B), "sigmoid")
        got = tlosses.reconstruction_term(L, torch.from_numpy(M),
                                          torch.from_numpy(B), "sigmoid")
        np.testing.assert_allclose(float(got), float(want), rtol=1e-12)
        return
    with pytest.raises(NotImplementedError, match="dense data"):
        tlosses.reconstruction_term(L, torch.zeros(384, 3),
                                    torch.zeros(256, 3), "sigmoid")


def test_linear_term_over_bell_layout_f64(rng):
    A = block_sparse_matrix(384, 256, 0.5, rng)
    Aj, At = _pair_csr(A)
    M, B = rng.rand(384, 4), rng.rand(256, 4)
    want = jlosses.reconstruction_term(Aj, jnp.asarray(M), jnp.asarray(B),
                                       "linear")
    got = tlosses.reconstruction_term(
        At, torch.from_numpy(M), torch.from_numpy(B), "linear",
        bell_t=tbell.bell_from_scipy(A.T, torch.float64, device="cpu"),
        use_pallas=True)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-12)


def test_newton_sigmoid_term_on_csr_raises_like_reference(rng):
    A = _scattered(rng)
    Aj, At = _pair_csr(A)
    M, B = rng.randn(60, 3), rng.randn(40, 3)
    with pytest.raises(NotImplementedError):
        jnewton._accumulate_term(jnp.asarray(M), Aj, jnp.asarray(B),
                                 "sigmoid", "gauss", None, False)
    with pytest.raises(NotImplementedError, match="dense D"):
        tnewton._accumulate_term(torch.from_numpy(M),
                                 tnewton.Term(At, torch.from_numpy(B)),
                                 "sigmoid")


# -- as_coupled --------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16])
def test_as_coupled_csr_norms_and_transpose(rng, dtype):
    """Host float64 norms of the unquantized values, float32 under bf16;
    At is the CSR of Aᵀ; ‖A‖² is the matrix's own sq_norm."""
    A = _scattered(rng)
    C = as_coupled(A, dtype, "cpu", sparse_mode="csr")
    jdt = jnp.float64 if dtype == torch.float64 else jnp.bfloat16
    J = j_as_coupled(A, jdt, sparse_mode="csr")
    fdt = torch.float64 if dtype == torch.float64 else torch.float32
    for name in ("row_sq", "row_sq_t"):
        got = getattr(C, name)
        assert got.dtype == fdt
        np.testing.assert_allclose(_np(got), _np(getattr(J, name)),
                                   rtol=1e-6 if dtype == torch.bfloat16
                                   else 1e-12)
    assert C.a_sq is None and C.A.dtype == dtype
    np.testing.assert_array_equal(_np(tsparse.to_dense(C.At)),
                                  _np(tsparse.to_dense(C.A)).T)
    assert float(C.A.sq_norm) == float(J.A.sq_norm)


@pytest.mark.parametrize("kind,use_pallas,takes_bell", [
    ("scattered", True, False), ("blocks", True, True),
    ("blocks", False, False)])
def test_as_coupled_layout_choice_by_fill(rng, kind, use_pallas, takes_bell):
    """BlockEll only under use_pallas and only when its fill reaches
    BELL_MIN_FILL: a scattered 10% matrix fills one 128×128 block to 1.5%,
    a block-structured one fills its blocks to ~1."""
    A = (_scattered(rng) if kind == "scattered"
         else block_sparse_matrix(384, 256, 0.5, rng))
    C = as_coupled(A, torch.float32, "cpu", use_pallas=use_pallas,
                   sparse_mode="csr")
    assert tsparse.is_sparse(C.A) and tsparse.is_sparse(C.At)
    assert (C.A_bell is not None) == takes_bell
    assert (C.At_bell is not None) == takes_bell
    if takes_bell:
        # the BlockEll layouts are the matrix: no CSR is built beside them
        assert C.A is C.A_bell and C.At is C.At_bell
        assert C.A_bell.fill >= tbell.BELL_MIN_FILL
        assert C.At_bell.shape == (256, 384)
    else:
        assert isinstance(C.A, tsparse.CsrMatrix)


def test_as_coupled_bell_capped_at_threshold(rng):
    A = block_sparse_matrix(384, 256, 0.5, rng)
    C = as_coupled(A, torch.float32, "cpu", use_pallas=True,
                   sparse_mode="csr", densify_threshold=1 << 16)
    assert C.A_bell is None and C.At_bell is None
    assert tsparse.is_sparse(C.A)


# -- the estimator -----------------------------------------------------------

def _pair(**kw):
    return JCMF(**kw), CMF(device="cpu", **kw)


def _assert_same_fit(j, t):
    assert j.n_iter_ == t.n_iter_
    assert j.loss_iters_ == t.loss_iters_
    np.testing.assert_allclose(t.loss_history_, j.loss_history_, rtol=1e-9)
    for name in ("U_", "V_", "Z_"):
        a, b = getattr(j, name), getattr(t, name)
        if a is None:
            assert b is None
        else:
            np.testing.assert_allclose(b, a, rtol=1e-9, atol=1e-12)


def _csr_problem(rng, kind, binary_y=False):
    if kind == "blocks":
        X = block_sparse_matrix(384, 256, 0.5, rng)
        Vt = np.abs(rng.randn(256, 4))
        Y = Vt @ np.abs(rng.randn(10, 4)).T
        if binary_y:
            Y = (Y > np.median(Y)).astype(float)
        return X, Y
    return _sparse_problem(rng, binary_y=binary_y)


@pytest.mark.parametrize("solver,y_link", [("mu", "linear"),
                                           ("newton", "linear"),
                                           ("newton", "sigmoid")])
@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("kind", ["scattered", "blocks"])
def test_csr_fit_matches_reference_f64(rng, solver, y_link, use_pallas, kind):
    """sparse_mode='csr': CSR X (with BlockEll layouts for the block-
    structured X under use_pallas), dense Y."""
    X, Y = _csr_problem(rng, kind, binary_y=y_link == "sigmoid")
    kw = dict(n_components=4, solver=solver, y_link=y_link, random_state=0,
              max_iter=20, eval_every=5, tol=1e-7, dtype="float64",
              use_pallas=use_pallas, sparse_mode="csr")
    if solver == "newton":
        kw.update(alpha=0.1, l1_ratio=0.5, max_iter=10)
    j, t = _pair(**kw)
    j.fit(X, Y)
    policy.reset_launch_counts()
    t.fit(X, Y)
    assert set(policy.launch_counts().values()) <= {0}
    _assert_same_fit(j, t)


@pytest.mark.parametrize("solver", ["mu", "newton"])
@pytest.mark.parametrize("use_pallas", [True, False])
def test_csr_y_fit_matches_reference_f64(rng, solver, use_pallas):
    """A linear-linked CSR Y beside a CSR X."""
    X, Y = _sparse_problem(rng)
    Y = sp.csr_matrix(Y * (rng.rand(*Y.shape) > 0.5))
    kw = dict(n_components=4, solver=solver, random_state=0, max_iter=10,
              eval_every=5, tol=1e-7, dtype="float64", use_pallas=use_pallas,
              sparse_mode="csr")
    j, t = _pair(**kw)
    j.fit(X, Y)
    t.fit(X, Y)
    _assert_same_fit(j, t)


@pytest.mark.parametrize("solver", ["mu", "newton"])
def test_csr_transform_matches_reference_f64(rng, solver):
    X, Y = _sparse_problem(rng)
    kw = dict(n_components=4, solver=solver, random_state=3, dtype="float64",
              max_iter=30 if solver == "mu" else 3, eval_every=5, tol=1e-7,
              sparse_mode="csr")
    j, t = _pair(**kw)
    j.fit(X, Y)
    t.fit(X, Y)
    np.testing.assert_allclose(t.transform(X[:9]), j.transform(X[:9]),
                               rtol=1e-9, atol=1e-12)


def test_bf16_csr_fit_objective_gap():
    """bf16-stored CSR X with f32 factors: both packages widen the stored
    values exactly and sum f32 products in different orders."""
    X, Y = _sparse_problem(np.random.RandomState(1), n=61, noise=0.5)
    kw = dict(n_components=4, solver="mu", random_state=0, max_iter=10,
              eval_every=10, data_dtype="bfloat16", sparse_mode="csr")
    j, t = _pair(**kw)
    j.fit(X, Y)
    t.fit(X, Y)
    gap = np.abs(np.subtract(t.loss_history_, j.loss_history_)) \
        / np.asarray(j.loss_history_)
    assert gap.max() < 1e-5


def test_sigmoid_csr_under_newton_densifies_with_the_warning(rng):
    X, Y = make_problem(rng, n=60, binary_y=True)
    Xb = sp.csr_matrix((X > np.median(X)).astype(float))
    msgs = []
    for est in _pair(n_components=3, solver="newton", x_link="sigmoid",
                     sparse_mode="csr", max_iter=3, dtype="float64",
                     U_non_negative=False, V_non_negative=False):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            est.fit(Xb, Y)
        msgs.append([str(x.message) for x in w
                     if "overridden to 'dense'" in str(x.message)])
    assert msgs[0] and msgs[0] == msgs[1]


@pytest.mark.parametrize("sparse", [False, True])
def test_mu_dense_reg_golden_replays_on_the_port(sparse):
    """tests/goldens/mu_dense_reg.npz, the NumPy implementation's MU
    trajectory that tests/test_goldens.py replays on the reference, through
    the dense path and through the CSR form of the same X, at the same
    tolerances."""
    g = np.load(Path(__file__).parent / "goldens" / "mu_dense_reg.npz")
    X = sp.csr_matrix(g["X"]) if sparse else g["X"]
    m = CMF(n_components=g["U0"].shape[1], solver="mu",
            alpha=float(g["alpha"]), l1_ratio=float(g["l1_ratio"]),
            max_iter=int(g["n_iter"]), tol=0.0, eval_every=1,
            dtype="float64", sparse_mode="csr" if sparse else "auto",
            device="cpu")
    m.fit(X, g["Y"], U=g["U0"], V=g["V0"], Z=g["Z0"])
    assert np.allclose(m.loss_history_, g["losses"], rtol=1e-9)
    assert np.allclose(m.U_, g["U"], rtol=1e-8, atol=1e-11)
    assert np.allclose(m.V_, g["V"], rtol=1e-8, atol=1e-11)
    assert np.allclose(m.Z_, g["Z"], rtol=1e-8, atol=1e-11)
