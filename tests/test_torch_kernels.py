"""The port's kernels on the CPU: the wrappers take their plain PyTorch
versions for CPU tensors, held against the JAX Pallas kernels run in
interpret mode (pycmf_tpu/ops/pallas/mu_fused.py, newton_fused.py,
sigmoid_newton.py, batched_solve.py), with the same NumPy inputs. The CUDA
kernels themselves run only on a card; they are checked against these
plain versions by chip_smoke.py.

Tolerances:
- float64: rtol 1e-10, the reference's own bar for its kernels against
  their unfused math (tests/test_pallas.py).
- bf16 X with f32 factors: both round V and U_new to bf16 at the same
  points and accumulate in f32, in different orders: rtol 1e-5 on U_new,
  1e-4 on numV (a sum over n rows of bf16-rounded U_new). The sigmoid
  passes widen X to f32 and sum f32 products in different orders: rtol
  1e-4 against the largest entry of G, H and φ.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pycmf_tpu.ops.pallas.batched_solve import batched_spd_solve as j_solve
from pycmf_tpu.ops.pallas.mu_fused import fused_mu_u_pass as j_mu
from pycmf_tpu.ops.pallas.newton_fused import \
    fused_newton_linear_u_pass as j_newton
from pycmf_tpu.ops.pallas.sigmoid_newton import sigmoid_gh_pass as j_gh
from pycmf_tpu.ops.pallas.sigmoid_newton import sigmoid_phi_pass as j_phi
from pycmf_tpu.solvers import newton as jnewton
from pycmf_tpu_torch.ops import losses as tlosses
from pycmf_tpu_torch.ops.kernels import (_build, batched_solve, mu_fused,
                                         mu_update, newton_fused, policy,
                                         sigmoid_newton)
from pycmf_tpu_torch.solvers import newton as tnewton


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.asarray(a, dtype=np.float64)).to(dtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float64).numpy()
    return np.asarray(x, dtype=np.float64)


def _operands(rng, n, m, k, pert=0.21, l2=0.01):
    X = np.abs(rng.randn(n, m))
    U = np.abs(rng.randn(n, k))
    V = np.abs(rng.randn(m, k))
    BtB = V.T @ V
    Hinv = np.linalg.inv(BtB + (l2 + pert) * np.eye(k))
    return X, U, V, BtB, Hinv


@pytest.mark.parametrize("n,n_valid", [(60, None), (61, None), (61, 50)])
def test_mu_pass_f64_matches_pallas(rng, n, n_valid):
    """61 rows with row_tile=16: the Pallas grid's edge tile is ragged."""
    X, U, V, VtV, _ = _operands(rng, n, 40, 4)
    l1, l2, eps = 0.2, 0.5, 1e-10
    want = j_mu(jnp.asarray(X), jnp.asarray(U), jnp.asarray(V),
                jnp.asarray(VtV), l1, l2, eps, row_tile=16, n_valid=n_valid)
    got = mu_fused.fused_mu_u_pass(_t(X), _t(U), _t(V), _t(VtV), l1, l2, eps,
                                   n_valid=n_valid)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("n", [60, 61])
def test_mu_pass_bf16_matches_pallas(rng, n):
    X, U, V, _, _ = _operands(rng, n, 40, 4)
    VtV = (V.astype(np.float32).T @ V.astype(np.float32))
    args = (0.01, 0.02, 1e-10)
    want = j_mu(jnp.asarray(X, jnp.bfloat16), jnp.asarray(U, jnp.float32),
                jnp.asarray(V, jnp.float32), jnp.asarray(VtV), *args,
                row_tile=16)
    got = mu_fused.fused_mu_u_pass(
        _t(X, torch.bfloat16), _t(U, torch.float32), _t(V, torch.float32),
        _t(VtV, torch.float32), *args)
    assert all(g.dtype == torch.float32 for g in got)
    np.testing.assert_allclose(_np(got[0]), _np(want[0]), rtol=1e-5)
    np.testing.assert_allclose(_np(got[1]), _np(want[1]), rtol=1e-4)
    np.testing.assert_allclose(_np(got[2]), _np(want[2]), rtol=1e-5)


@pytest.mark.parametrize("n", [60, 61])
@pytest.mark.parametrize("trials,non_negative", [(8, True), (1, True),
                                                 (0, True), (3, False)])
def test_newton_pass_f64_matches_pallas(rng, n, trials, non_negative):
    X, U, V, BtB, Hinv = _operands(rng, n, 40, 4)
    row_sq = (X ** 2).sum(axis=1)
    l1, l2 = 0.0, 0.01
    want = j_newton(jnp.asarray(X), jnp.asarray(U), jnp.asarray(V),
                    jnp.asarray(BtB), jnp.asarray(Hinv), jnp.asarray(row_sq),
                    l1, l2, trials=trials, non_negative=non_negative,
                    row_tile=16)
    got = newton_fused.fused_newton_linear_u_pass(
        _t(X), _t(U), _t(V), _t(BtB), _t(Hinv), _t(row_sq), l1, l2,
        trials=trials, non_negative=non_negative)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("n", [60, 61])
def test_newton_pass_bf16_matches_pallas(rng, n):
    X, U, V, _, _ = _operands(rng, n, 40, 4)
    V32 = V.astype(np.float32)
    BtB = V32.T @ V32
    Hinv = np.linalg.inv(BtB + 0.21 * np.eye(4)).astype(np.float32)
    row_sq = (X.astype(np.float32) ** 2).sum(axis=1)
    l1, l2 = 0.001, 0.01
    want = j_newton(jnp.asarray(X, jnp.bfloat16), jnp.asarray(U, jnp.float32),
                    jnp.asarray(V32), jnp.asarray(BtB), jnp.asarray(Hinv),
                    jnp.asarray(row_sq), l1, l2, trials=8, non_negative=True,
                    row_tile=16)
    got = newton_fused.fused_newton_linear_u_pass(
        _t(X, torch.bfloat16), _t(U, torch.float32), _t(V32, torch.float32),
        _t(BtB, torch.float32), _t(Hinv, torch.float32),
        _t(row_sq, torch.float32), l1, l2, trials=8, non_negative=True)
    np.testing.assert_allclose(_np(got[0]), _np(want[0]), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(_np(got[1]), _np(want[1]), rtol=1e-4)


def test_cpu_wrappers_take_plain_versions_without_launching(rng):
    """CPU tensors: the wrapper returns the plain version's result exactly,
    and no kernel launch is counted."""
    X, U, V, BtB, Hinv = _operands(rng, 61, 40, 4)
    rs = _t((X ** 2).sum(axis=1))
    policy.reset_launch_counts()
    a = mu_fused.fused_mu_u_pass(_t(X), _t(U), _t(V), _t(BtB), 0.1, 0.2,
                                 1e-10)
    b = mu_fused.fused_mu_u_pass_ref(_t(X), _t(U), _t(V), _t(BtB), 0.1, 0.2,
                                     1e-10)
    c = newton_fused.fused_newton_linear_u_pass(
        _t(X), _t(U), _t(V), _t(BtB), _t(Hinv), rs, 0.0, 0.01, trials=8,
        non_negative=True)
    d = newton_fused.fused_newton_linear_u_pass_ref(
        _t(X), _t(U), _t(V), _t(BtB), _t(Hinv), rs, 0.0, 0.01, trials=8,
        non_negative=True)
    for x, y in list(zip(a, b)) + list(zip(c, d)):
        assert torch.equal(x, y)
    assert policy.launch_counts()["fused_mu_u_pass"] == 0
    assert policy.launch_counts()["fused_newton_linear_u_pass"] == 0


def test_fp8_data_raises_in_both_wrappers(rng):
    """fp8 data is stored as float8_e4m3fn (the estimator's 'fp8'); the
    kernels have no float8_e5m2 form, and both wrappers refuse it on every
    device (tests/test_torch_fp8.py holds the e4m3 forms)."""
    X, U, V, BtB, Hinv = _operands(rng, 8, 6, 2)
    X8 = _t(X, torch.float32).to(torch.float8_e5m2)
    f = lambda a: _t(a, torch.float32)  # noqa: E731
    with pytest.raises(NotImplementedError, match="float8_e4m3fn"):
        mu_fused.fused_mu_u_pass(X8, f(U), f(V), f(BtB), 0.0, 0.0, 1e-10)
    with pytest.raises(NotImplementedError, match="float8_e4m3fn"):
        newton_fused.fused_newton_linear_u_pass(
            X8, f(U), f(V), f(BtB), f(Hinv), f(np.ones(8)), 0.0, 0.0,
            trials=2, non_negative=True)


def test_mixed_devices_raise(rng):
    X, U, V, BtB, _ = _operands(rng, 8, 6, 2)
    with pytest.raises(ValueError, match="one CUDA device or all"):
        policy.on_card(_t(X), _t(U).to("meta"))


def test_build_without_nvcc_raises_clearly(monkeypatch, tmp_path):
    """Here (no CUDA toolkit) a kernel build fails with a message naming
    what is missing; it never falls back."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "DEFAULT_NVCC", tmp_path / "nvcc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_sources_name_the_kernels_they_replace():
    for name, ref in (("mu_fused", "mu_fused.py:fused_mu_u_pass"),
                      ("newton_fused",
                       "newton_fused.py:fused_newton_linear_u_pass"),
                      ("sigmoid_newton", "sigmoid_newton.py:sigmoid_gh_pass"),
                      ("sigmoid_newton",
                       "sigmoid_newton.py:sigmoid_phi_pass"),
                      ("batched_solve", "batched_solve.py:batched_spd_solve"),
                      ("batched_solve_wide",
                       "batched_solve.py:batched_spd_solve")):
        head = (_build.CSRC / f"{name}.cu").read_text()[:2000]
        assert f"pycmf_tpu/ops/pallas/{ref}" in head
        assert "Bound:" in head and "Design:" in head


# n, m on and off the tiles (64 rows, 128 columns, 128-column stages), the
# main-path shape, k at each count of n8 tiles
_PLAN_SHAPES = [(1, 1, 1), (17, 15, 7), (64, 128, 8), (65, 129, 9),
                (30000, 4097, 20), (30000, 11314, 20), (100000, 300, 32)]


@pytest.mark.parametrize("n,m,k", _PLAN_SHAPES)
@pytest.mark.parametrize("x_bytes", [2, 4])
@pytest.mark.parametrize("n_sm", [1, 132])
def test_u_pass_plan_covers_each_row_and_column_once(n, m, k, x_bytes, n_sm):
    """The CUDA U-pass's plan (csrc/u_pass_common.cuh checks the same
    rules in plan_ok): column slices and row segments cover the matrix
    exactly once, segments are whole 64-row blocks (so a row's 16-byte
    alignment repeats in each), the column sweep stays within one resident
    wave, and the workspace parts hold what the kernels write."""
    p = mu_fused.u_pass_plan(n, m, k, x_bytes, n_sm)
    assert p.nt == -(-k // 8) and 8 * p.nt >= k
    cols = [c for s in range(p.col_slices)
            for c in range(s * mu_fused.B_COLS,
                           min(m, (s + 1) * mu_fused.B_COLS))]
    assert cols == list(range(m))
    rows = [r for s in range(p.n_seg)
            for r in range(s * p.seg_rows, min(n, (s + 1) * p.seg_rows))]
    assert rows == list(range(n))
    assert p.seg_rows % 64 == 0 and p.seg_rows % 16 == 0
    assert all(s * p.seg_rows * m * x_bytes % 16 == 0 for s in range(p.n_seg))
    assert p.n_seg * p.col_slices <= max(p.col_slices,
                                         mu_fused.B_CTAS_PER_SM * n_sm)
    assert p.row_blocks * mu_fused.A_ROWS >= n > (p.row_blocks - 1) * 64
    assert p.ld_vt >= m and p.ld_vt % 128 == 0
    assert p.ld_ux == p.row_blocks * 64 >= n
    np8 = 8 * p.nt
    sizes = (np8 * p.ld_vt * x_bytes / 4, np8 * p.ld_ux * x_bytes / 4,
             p.row_blocks * k * k, p.n_seg * m * k if p.n_seg > 1 else 0)
    ends = list(p.offsets[1:]) + [p.floats]
    for off, size, end in zip(p.offsets, sizes, ends):
        assert off % mu_fused.WORK_ALIGN == 0 and off + size <= end


def test_u_pass_plan_at_the_main_shape():
    """bf16 X 30000 x 11314, k = 20 on 132 SMs: 469 row blocks, 89 column
    slices in 2 row segments (178 CTAs, one wave at 2 per SM)."""
    p = mu_fused.u_pass_plan(30000, 11314, 20, 2, 132)
    assert (p.nt, p.row_blocks, p.col_slices, p.n_seg, p.seg_rows) == (
        3, 469, 89, 2, 15040)
    assert p.floats * 4 < 5 * 2 ** 20  # under 5 MB of scratch per call


# The two sweeps' plan (with the wide route's slices: one of ceil(k / 8) n8
# tiles, 9-16 rounded up to even, at k <= 128; 128-component slices above)
# as it stands without the cluster route: bf16 and e4m3 X keep it field for
# field.
def _two_sweep_plan(n, m, k, op_bytes, n_sm):
    ceil = lambda a, b: -(-a // b)
    k_slices = 1 if k <= 128 else ceil(k, 128)
    nt = ceil(k, 8) if k <= 64 else 16 if k > 128 else 2 * ceil(k, 16)
    np_ = 8 * nt * k_slices
    row_blocks = ceil(n, 64)
    ld_ux, ld_vt = row_blocks * 64, ceil(m, 128) * 128
    col_slices = ceil(m, 128)
    n_seg = min(max(1, 2 * n_sm // col_slices), row_blocks)
    seg_rows = ceil(row_blocks, n_seg) * 64
    n_seg = ceil(n, seg_rows)
    planes = 2 if op_bytes == 4 and k > 32 else 1  # f32: TF32 parts
    sizes = ((planes + planes // 2) * ceil(np_ * ld_vt * op_bytes, 4),
             planes * ceil(np_ * ld_ux * op_bytes, 4), row_blocks * k * k,
             max(n_seg * m * k if n_seg > 1 else 0,
                 2 * n * k if k > 32 else 0))
    offsets, at = [], 0
    for size in sizes:
        offsets.append(at)
        at += ceil(size, 64) * 64
    return mu_fused.UPassPlan(np_ // 8, k_slices, ld_vt, ld_ux, row_blocks,
                              col_slices, seg_rows, n_seg, tuple(offsets),
                              max(at, 64))


@pytest.mark.parametrize("n,m,k", _PLAN_SHAPES + [(30000, 11314, 40),
                                                  (17, 47236, 100)])
@pytest.mark.parametrize("n_sm", [1, 132])
def test_u_pass_plan_of_bf16_x_is_unchanged(n, m, k, n_sm):
    """bf16 X (and e4m3 X, which takes the bf16 call's plan) keeps the two
    sweeps' plan as it was, with no clusters: its kernels and bits are
    the parent's."""
    p = mu_fused.u_pass_plan(n, m, k, 2, n_sm)
    assert p == _two_sweep_plan(n, m, k, 2, n_sm)
    assert (p.clusters, p.slice_cols) == (0, 0)


@pytest.mark.parametrize("n", [1, 17, 30000])
@pytest.mark.parametrize("m", [1, 15, 4097, 11314, 47236])
@pytest.mark.parametrize("k", [1, 7, 20, 32])
def test_u_pass_cluster_plan_covers_each_row_and_column_once(n, m, k):
    """f32 X at k <= 32 (csrc/u_pass_cluster.cuh): the 16 CTAs of a
    cluster hold slices of m (multiples of 16 columns) that cover it once,
    the clusters' bands of 16 rows (band b on cluster b % clusters, its
    row r on rank r) cover n once, a CTA's shared memory stays within 227
    KB, its warps hold numV's tiles of the slice in registers, a thread of
    warps 1-11 copies each 16-byte chunk of a tile row, and the workspace
    holds a Gram partial per CTA and a numV partial per
    cluster. Past cluster_max_m(k) (47236 here) the two sweeps' plan."""
    p = mu_fused.u_pass_plan(n, m, k, 4, 132, 7)
    if m > mu_fused.cluster_max_m(k):
        assert p == _two_sweep_plan(n, m, k, 4, 132)
        return
    w, cl = p.slice_cols, p.clusters
    assert cl == 7 and w % 16 == 0 and 16 <= w <= mu_fused.C_MAX_COLS
    cols = [c for s in range(mu_fused.C_CTAS)
            for c in range(s * w, min(m, (s + 1) * w))]
    assert cols == list(range(m))
    bands = -(-n // mu_fused.C_ROWS)
    owned = sorted(16 * b + r for c in range(cl) for b in range(c, bands, cl)
                   for r in range(mu_fused.C_CTAS) if 16 * b + r < n)
    assert owned == list(range(n))
    np_ = 8 * p.nt
    assert mu_fused.cluster_smem(w, np_) <= mu_fused.SMEM_OPTIN == 232448
    assert w <= 16 * mu_fused.C_WARPS * mu_fused.C_MTILES
    assert w // 4 + 1 <= 32 * (mu_fused.C_WARPS - 1)
    ends = list(p.offsets[1:]) + [p.floats]
    sizes = (np_ * p.ld_vt, 0, 16 * cl * k * k, cl * m * k if cl > 1 else 0)
    for off, size, end in zip(p.offsets, sizes, ends):
        assert off % mu_fused.WORK_ALIGN == 0 and off + size <= end


@pytest.mark.parametrize("k,widest", [(1, 12288), (8, 12288), (9, 12288),
                                      (16, 12288), (17, 11520), (20, 11520),
                                      (24, 11520), (25, 9984), (32, 9984)])
def test_u_pass_cluster_route_crossover(k, widest):
    """The cluster route takes f32 X up to the widest m whose CTA fits 227
    KB at its slice (at most 768 columns, numV's registers), two sweeps
    above; bf16 X and k > 32 never take it; clusters: n_sm // 16, at most
    the card's resident count, at least one."""
    assert mu_fused.cluster_max_m(k) == widest
    at = mu_fused.u_pass_plan(30000, widest, k, 4, 132)
    w, np_ = at.slice_cols, 8 * at.nt
    assert (at.clusters, 16 * w) == (8, widest)
    assert w == mu_fused.C_MAX_COLS or mu_fused.cluster_smem(
        w + 16, np_) > mu_fused.SMEM_OPTIN
    assert mu_fused.u_pass_plan(30000, widest + 1, k, 4, 132).clusters == 0
    assert mu_fused.u_pass_plan(30000, widest, k, 2, 132).clusters == 0
    assert mu_fused.u_pass_plan(30000, 100, 33, 4, 132).clusters == 0
    assert mu_fused.u_pass_plan(30000, widest, k, 4, 132, 7).clusters == 7
    assert mu_fused.u_pass_plan(30000, widest, k, 4, 1, 7).clusters == 1
    assert mu_fused.u_pass_plan(30000, widest, k, 4, 132, 0).clusters == 1


@pytest.mark.parametrize("library,symbol,middle", [
    ("mu_fused", "pycmf_mu_fused_u_pass", 8),
    ("newton_fused", "pycmf_newton_fused_u_pass", 10)])
def test_u_pass_entry_is_resolved_once(monkeypatch, library, symbol, middle):
    """The wrappers' C entry points are looked up and typed once per
    process (pointers as c_void_p), not on every call."""
    import ctypes
    import types

    loads = []

    def fake_load(name):
        loads.append(name)
        return types.SimpleNamespace(**{symbol: types.SimpleNamespace()})

    monkeypatch.setattr(_build, "load", fake_load)
    monkeypatch.setattr(_build, "_functions", {})
    types_ = (ctypes.c_float,) * middle
    a = mu_fused.entry(library, symbol, types_)
    b = mu_fused.entry(library, symbol, types_)
    assert a is b and loads == [library]
    # the tail: the cluster route's clusters and slice_cols, Unew, numV,
    # gramU, four workspace parts, four plan ints, device, stream
    assert len(a.argtypes) == 4 + middle + 15
    assert a.argtypes[1] is ctypes.c_void_p and a.restype is ctypes.c_int


def _sig_operands(rng, n, m, k):
    """0/1 data (exact in bf16), O(1) logits."""
    X = (rng.rand(n, m) < 0.3).astype(np.float64)
    return X, 0.5 * rng.randn(n, k), 0.5 * rng.randn(m, k)


def _close_to_scale(got, want, rtol):
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


# n = 1, n below the Pallas row tile, n past it with a ragged edge; q not a
# multiple of the CUDA kernels' 32- and 64-column chunks
_SIG_SHAPES = [(1, 40, 4), (7, 33, 5), (137, 90, 5), (64, 300, 8)]


@pytest.mark.parametrize("n,m,k", _SIG_SHAPES)
def test_sigmoid_gh_f64_matches_pallas(rng, n, m, k):
    X, M, B = _sig_operands(rng, n, m, k)
    want = j_gh(jnp.asarray(X), jnp.asarray(M), jnp.asarray(B), 0.05, 0.2)
    got = sigmoid_newton.sigmoid_gh_pass(_t(X), _t(M), _t(B), 0.05, 0.2)
    assert got[1].shape == (n, k, k)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("n,m,k", [(7, 33, 5), (61, 90, 20)])
def test_sigmoid_gh_bf16_matches_pallas(rng, n, m, k):
    X, M, B = _sig_operands(rng, n, m, k)
    want = j_gh(jnp.asarray(X, jnp.bfloat16), jnp.asarray(M, jnp.float32),
                jnp.asarray(B, jnp.float32), 0.01, 0.02)
    got = sigmoid_newton.sigmoid_gh_pass(
        _t(X, torch.bfloat16), _t(M, torch.float32), _t(B, torch.float32),
        0.01, 0.02)
    assert all(g.dtype == torch.float32 for g in got)
    for g, w in zip(got, want):
        _close_to_scale(g, w, 1e-4)


@pytest.mark.parametrize("n,m,k", [(1, 40, 4), (61, 90, 5)])
@pytest.mark.parametrize("trials", [0, 1, 8])
@pytest.mark.parametrize("non_negative", [True, False])
def test_sigmoid_phi_f64_matches_pallas(rng, n, m, k, trials, non_negative):
    X, M, B = _sig_operands(rng, n, m, k)
    if non_negative:
        M = np.abs(M)
    d = rng.randn(n, k)
    kw = dict(trials=trials, non_negative=non_negative)
    want = j_phi(jnp.asarray(X), jnp.asarray(M), jnp.asarray(d),
                 jnp.asarray(B), 0.05, 0.2, **kw)
    got = sigmoid_newton.sigmoid_phi_pass(_t(X), _t(M), _t(d), _t(B), 0.05,
                                          0.2, **kw)
    assert got.shape == (n, trials + 1)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-10)


def test_sigmoid_phi_bf16_matches_pallas(rng):
    n, m, k = 61, 90, 20
    X, M, B = _sig_operands(rng, n, m, k)
    d = 0.1 * rng.randn(n, k)
    f = lambda a: _t(a, torch.float32)  # noqa: E731
    want = j_phi(jnp.asarray(X, jnp.bfloat16), *(jnp.asarray(a, jnp.float32)
                                                 for a in (M, d, B)),
                 0.01, 0.02, trials=8, non_negative=True)
    got = sigmoid_newton.sigmoid_phi_pass(_t(X, torch.bfloat16), f(M), f(d),
                                          f(B), 0.01, 0.02, trials=8,
                                          non_negative=True)
    assert got.dtype == torch.float32
    _close_to_scale(got, want, 1e-5)


@pytest.mark.parametrize("stream", ["gh", "phi"])
def test_sigmoid_rows_stream_like_one_block(rng, monkeypatch, stream):
    """The plain passes over row blocks (and candidates) of _BLOCK_ELEMS
    give what one block gives."""
    X, M, B = _sig_operands(rng, 61, 40, 4)
    C = np.stack([M, M + 0.1, np.abs(M)])
    if stream == "gh":
        def run():
            return sigmoid_newton.sigmoid_gh_rows(_t(X), _t(M), _t(B))
    else:
        def run():
            return (tlosses.sigmoid_sq_rows(_t(X), _t(C), _t(B)),)
    whole = run()
    monkeypatch.setattr(tlosses, "_BLOCK_ELEMS", 7 * 40)
    for a, b in zip(run(), whole):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-13)


def _spd(rng, p, k):
    A = rng.randn(p, k, k)
    return np.einsum("pij,pkj->pik", A, A) + 0.5 * np.eye(k), rng.randn(p, k)


@pytest.mark.parametrize("p,k", [(1, 3), (5, 3), (130, 8), (1000, 20),
                                 (7, 40)])
def test_batched_solve_f64_matches_pallas(rng, p, k):
    """k = 40 > 32: the reference takes a generic LU solve, the port's
    plain version Cholesky (the card's wide route)."""
    H, G = _spd(rng, p, k)
    want = j_solve(jnp.asarray(H), jnp.asarray(G))
    got = batched_solve.batched_spd_solve(_t(H), _t(G))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-10, atol=1e-12)


def test_batched_solve_f32_matches_pallas(rng):
    """Damped rank-one systems, the Newton Hessians' structure; f32 at a
    tolerance of the systems' condition number times f32 rounding."""
    v = rng.randn(300, 20, 1)
    H = v @ v.transpose(0, 2, 1) + 0.2 * np.eye(20)
    G = rng.randn(300, 20)
    want = j_solve(jnp.asarray(H, jnp.float32), jnp.asarray(G, jnp.float32))
    got = batched_solve.batched_spd_solve(_t(H, torch.float32),
                                          _t(G, torch.float32))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-5)


def test_batched_solve_not_spd_gives_nan_like_reference(rng):
    H, G = _spd(rng, 4, 3)
    H[2] = np.array([[1.0, 2.0, 0.0], [2.0, 1.0, 0.0], [0.0, 0.0, 1.0]])
    want = np.asarray(j_solve(jnp.asarray(H), jnp.asarray(G)))
    got = _np(batched_solve.batched_spd_solve(_t(H), _t(G)))
    assert np.isnan(want[2]).all() and np.isnan(got[2]).all()
    np.testing.assert_allclose(got[[0, 1, 3]], want[[0, 1, 3]], rtol=1e-10)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("p,k", [(1, 3), (33, 20), (7, 40)])
def test_batched_solve_with_shared_equals_solve_of_sum(rng, dtype, p, k):
    """H_shared apart gives what the solve of H + H_shared gives, bit for
    bit (the plain version adds first; k = 40 > 32 takes the generic solve
    on the sum)."""
    H, G = _spd(rng, p, k)
    Hs = _spd(rng, 1, k)[0][0]
    for fn in (batched_solve.batched_spd_solve,
               batched_solve.batched_spd_solve_ref):
        if k > batched_solve.MAX_K and fn is not batched_solve.batched_spd_solve:
            continue
        got = fn(_t(H, dtype), _t(G, dtype), _t(Hs, dtype))
        want = fn(_t(H, dtype) + _t(Hs, dtype), _t(G, dtype))
        assert torch.equal(got, want)


@pytest.mark.parametrize("k", [33, 40, 48, 63, 64])
def test_batched_solve_ref_wide_k_matches_reference(rng, k):
    """32 < k <= 64, the card's wide route: the plain version (Cholesky)
    against the reference, which takes jnp.linalg.solve (LU) above 32;
    SPD systems, f64 rtol 1e-9."""
    H, G = _spd(rng, 9, k)
    Hs = _spd(rng, 1, k)[0][0]
    want = j_solve(jnp.asarray(H + Hs), jnp.asarray(G))
    got = batched_solve.batched_spd_solve_ref(_t(H), _t(G), _t(Hs))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-9, atol=1e-12)
    assert torch.equal(batched_solve.batched_spd_solve(_t(H), _t(G), _t(Hs)),
                       got)


@pytest.mark.parametrize("k", range(33, 65))
def test_wide_rows_hold_each_row_once(k):
    """The wide route's row map (batched_solve.wide_rows, the mirror of
    csrc's chol_solve_wide_kernel): with KP = k rounded up to 4, every row
    of the lower triangle and of g (rows k..KP-1 the identity block's) is
    held by exactly one lane, and no lane holds more than KP + 1 entries
    of the triangle."""
    kp = -(-k // 4) * 4
    rows = batched_solve.wide_rows(k)
    assert len(rows) == 32
    held = sorted(i for lane in rows for i in lane)
    assert held == list(range(kp))
    assert all(len(lane) <= 2 and lane[0] == n for n, lane in enumerate(rows))
    assert max(sum(i + 1 for i in lane) for lane in rows) <= kp + 1


@pytest.mark.parametrize("p,k", [(1, 3), (40, 8), (300, 20), (5, 40)])
def test_solve_direction_pallas_matches_reference(rng, p, k):
    """_solve_direction under use_pallas: the port hands K5 H_rows and
    H_shared apart, the reference adds them first; f64 at rtol 1e-9."""
    H, G = _spd(rng, p, k)
    Hs = _spd(rng, 1, k)[0][0]
    want = jnewton._solve_direction(jnp.asarray(Hs), jnp.asarray(H),
                                    jnp.asarray(G), True)
    got = tnewton._solve_direction(_t(Hs), _t(H), _t(G), True)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-9, atol=1e-12)


def _lean_operands(kernel, dtype=torch.float32):
    """A CPU call of K5 or K6 through its card route: (module, library,
    symbol, call)."""
    f = lambda *shape: torch.rand(*shape, dtype=dtype)  # noqa: E731
    if kernel == "batched_spd_solve":
        H = torch.eye(4, dtype=dtype).expand(6, 4, 4).contiguous()
        return (batched_solve, "batched_solve", "pycmf_batched_spd_solve",
                lambda: batched_solve.batched_spd_solve(H, f(6, 4),
                                                        f(4, 4)))
    return (mu_update, "mu_update", "pycmf_mu_update",
            lambda: mu_update.fused_mu_update(f(6, 4), f(4, 4), f(6, 4),
                                              0.1, 0.2, 1e-9))


H100_SMEM_OPTIN = 232448  # an H100's shared memory per CTA, opted in


@pytest.fixture
def lean_entry(monkeypatch):
    """Routes K5 and K6 through their launch code on CPU tensors: a fake
    library whose entry records its arguments and returns `rc`, and a fake
    raw stream. Yields the record."""
    import types

    rec = types.SimpleNamespace(loads=[], calls=[], streams=[], rc=0)

    def entry(*args):
        rec.calls.append(args)
        return rec.rc

    def fake_load(name):
        rec.loads.append(name)
        return types.SimpleNamespace(
            pycmf_batched_spd_solve=entry, pycmf_mu_update=entry,
            pycmf_batched_wide_solve=entry, pycmf_batched_block_solve=entry,
            pycmf_block_solve_optin=lambda dev: H100_SMEM_OPTIN,
            pycmf_error_string=lambda rc: b"fake failure")

    def raw_stream(dev):
        rec.streams.append(dev)
        return 0xBEEF

    monkeypatch.setattr(_build, "load", fake_load)
    monkeypatch.setattr(_build, "_functions", {})
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", raw_stream,
                        raising=False)
    for mod in (batched_solve, mu_update):
        monkeypatch.setattr(mod, "on_card", lambda *t: True)
        monkeypatch.setattr(mod, "_sm_count", lambda dev: 132)
    batched_solve.smem_optin.cache_clear()
    batched_solve.block_max_k.cache_clear()
    yield rec
    batched_solve.smem_optin.cache_clear()
    batched_solve.block_max_k.cache_clear()


@pytest.mark.parametrize("kernel", ["batched_spd_solve", "fused_mu_update"])
def test_lean_launch_resolves_entry_once_and_passes_device_and_stream(
        lean_entry, kernel):
    """K5's and K6's wrappers launch as K1's do: the C entry is looked up
    once per process, gets the device index (the C side makes it current)
    and the raw current stream, and nothing else wraps the call."""
    import ctypes

    mod, library, symbol, call = _lean_operands(kernel)
    policy.reset_launch_counts()
    call()
    call()
    assert lean_entry.loads == [library]
    fn = _build._functions[(library, symbol)]
    assert fn.restype is ctypes.c_int
    assert fn.argtypes[-2:] == [ctypes.c_int, ctypes.c_void_p]
    assert len(lean_entry.calls) == 2
    for args, dev in zip(lean_entry.calls, lean_entry.streams):
        assert len(args) == len(fn.argtypes)
        assert args[-1] == 0xBEEF and args[-2] == dev
    assert lean_entry.streams == [-1, -1]  # a CPU tensor's get_device()
    assert policy.launch_counts()[kernel] == 2


@pytest.mark.parametrize("kernel", ["batched_spd_solve", "fused_mu_update"])
def test_lean_launch_raises_on_nonzero_rc(lean_entry, kernel):
    mod, library, symbol, call = _lean_operands(kernel)
    policy.reset_launch_counts()
    lean_entry.rc = 700
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        call()
    # the entry resolved, then the library asked for the error's text
    assert lean_entry.loads == [library, library]
    assert policy.launch_counts()[kernel] == 0


@pytest.mark.parametrize("kernel", ["batched_spd_solve", "fused_mu_update"])
def test_lean_launch_refuses_float64_naming_c1(lean_entry, kernel):
    mod, library, symbol, call = _lean_operands(kernel, torch.float64)
    with pytest.raises(NotImplementedError, match="ROADMAP C1"):
        call()
    assert lean_entry.calls == []


@pytest.mark.parametrize("k,route", [(32, "batched_spd_solve"),
                                     (33, "batched_spd_solve_wide"),
                                     (40, "batched_spd_solve_wide"),
                                     (48, "batched_spd_solve_wide"),
                                     (64, "batched_spd_solve_wide"),
                                     (65, "batched_spd_solve_block")])
def test_batched_solve_dispatch_boundary(lean_entry, k, route):
    """On the card every k launches the kernel: its wide route above 32
    (a library of its own, the narrow route's arguments) and its block
    route above 64 (each counted apart), where the reference takes
    jnp.linalg.solve."""
    H = torch.eye(k).expand(3, k, k).contiguous()
    G, Hs = torch.rand(3, k), torch.eye(k)
    policy.reset_launch_counts()
    batched_solve.batched_spd_solve(H, G, Hs)
    counts = {n: c for n, c in policy.launch_counts().items() if c}
    assert len(lean_entry.calls) == 1 and counts == {route: 1}
    args = lean_entry.calls[0]
    assert args[4] == k  # (H, Hs, G, p, k, ...)
    if route != "batched_spd_solve_block":  # (..., D, device, stream)
        assert len(args) == 8
        assert lean_entry.loads == [
            "batched_solve_wide" if k > 32 else "batched_solve"]


@pytest.mark.parametrize("k", [20, 40, 64, 100])
def test_batched_spd_solve_block_takes_any_k(lean_entry, k):
    """batched_spd_solve_block launches the blocked route at any k (below
    65 the yardstick of the narrow and wide routes): the blocked plan's
    threads and shared bytes, one CTA per system, counted as a block
    launch; on CPU tensors it is the plain version."""
    H = torch.eye(k).expand(3, k, k).contiguous()
    G, Hs = torch.rand(3, k), torch.eye(k)
    policy.reset_launch_counts()
    batched_solve.batched_spd_solve_block(H, G, Hs)
    (args,) = lean_entry.calls
    plan = batched_solve.blocked_plan(3, k, False, H100_SMEM_OPTIN, 132)
    assert plan.route == "block" and args[3:6] == (3, k, 0)
    assert args[8:11] == (0, plan.threads, plan.smem)
    counts = {n: c for n, c in policy.launch_counts().items() if c}
    assert counts == {"batched_spd_solve_block": 1}


def test_batched_spd_solve_block_on_cpu_is_the_plain_version(rng):
    H, G = _spd(rng, 5, 40)
    Hs = _spd(rng, 1, 40)[0][0]
    policy.reset_launch_counts()
    got = batched_solve.batched_spd_solve_block(_t(H), _t(G), _t(Hs))
    assert torch.equal(got, batched_solve.batched_spd_solve_ref(
        _t(H), _t(G), _t(Hs)))
    assert not any(policy.launch_counts().values())


# k at each crossover of the plan on an H100 and one past it: one CTA's
# reach (SPD 320, LU 220) and the scratch slot's work area (in shared
# memory to SPD 3203, LU 1652)
PLAN_KS = [1, 20, 32, 33, 40, 48, 64, 65, 100, 220, 221, 239, 240, 320, 321,
           1652, 1653, 2000, 3203, 3204, 5000]


@pytest.mark.parametrize("lu", [False, True], ids=["spd", "lu"])
@pytest.mark.parametrize("k", PLAN_KS, ids=str)
def test_batched_solve_plan_routes_and_scratch(k, lu):
    """The launch plan on an H100 (227 KB of shared memory per CTA, 132
    SMs): SPD's narrow and wide routes, LU's warp per system at k <= 32,
    then the blocked routes: one CTA per system while its shared memory
    holds it; past that two global scratch slots an SM (fewer for fewer
    systems), the work area in shared memory while it fits, else in the
    slot, where shared memory no longer grows with k: every k runs."""
    smem = batched_solve.block_smem_floats
    slot = batched_solve.block_slot_floats
    for p in (11314, 2048, 20, 3):
        plan = batched_solve.solve_plan(p, k, lu, H100_SMEM_OPTIN, 132)
        if k <= 32:
            assert plan.route == ("lu_warp" if lu else "narrow")
            assert (plan.smem, plan.slots) == (0, 0)
            continue
        if k <= 64 and not lu:
            assert plan.route == "wide"
            continue
        assert plan.threads == batched_solve.block_threads(k, lu)
        assert plan.smem <= H100_SMEM_OPTIN
        if 4 * smem(k, lu) <= H100_SMEM_OPTIN:
            assert (plan.route, plan.place, plan.slots) == (
                "block", batched_solve.SHARED, 0)
            assert plan.smem == 4 * smem(k, lu)
            continue
        place = (batched_solve.SLOT_ROWS
                 if 4 * smem(k, lu, batched_solve.SLOT_ROWS)
                 <= H100_SMEM_OPTIN else batched_solve.SLOT_ALL)
        assert (plan.route, plan.place) == ("scratch", place)
        assert plan.smem == 4 * smem(k, lu, place)
        assert plan.slots == min(p, 2 * 132)
        assert plan.slot_floats == slot(k, lu, place)
        # a slot holds the whole rows [H | g], and the work area with it
        # where shared memory does not
        assert slot(k, lu, place) >= k * (k + 1)
    top, wide = (220, 1652) if lu else (320, 3203)
    plan = batched_solve.solve_plan(2048, k, lu, H100_SMEM_OPTIN, 132)
    if k > (32 if lu else 64):
        assert (plan.route, plan.place) == (
            ("block", batched_solve.SHARED) if k <= top else
            ("scratch", batched_solve.SLOT_ROWS) if k <= wide else
            ("scratch", batched_solve.SLOT_ALL))
    if k > wide:  # the same shared bytes at every k past the work area's
        assert plan.smem == batched_solve.solve_plan(
            2048, 2 * k, lu, H100_SMEM_OPTIN, 132).smem


@pytest.mark.parametrize("k,lu", [
    (k, lu) for lu in (False, True)
    for k in ([20, 33, 221, 1653] if lu else [321]) + [65, 100, 240]],
    ids=str)
def test_blocked_solve_launch_passes_the_plan(lean_entry, monkeypatch, k,
                                              lu):
    """The wrapper hands the C entry the plan's scratch slots, threads and
    shared bytes, the scratch allocated before the launch (slots x
    slot_floats floats), after H (p, k, ...) as before; one launch, counted
    under its route's name."""
    p = 3
    H = torch.eye(k).expand(p, k, k).contiguous()
    G, Hs = torch.rand(p, k), torch.eye(k)
    policy.reset_launch_counts()
    allocs = []
    empty = torch.empty

    def spy_empty(*shape, **kw):
        out = empty(*shape, **kw)
        allocs.append(out.numel())
        return out
    monkeypatch.setattr(batched_solve.torch, "empty", spy_empty)
    (batched_solve.batched_lu_solve if lu
     else batched_solve.batched_spd_solve)(H, G, Hs)
    plan = batched_solve.solve_plan(p, k, lu, H100_SMEM_OPTIN, 132)
    (args,) = lean_entry.calls
    # (H, Hs, G, p, k, lu, out, scratch, slots, threads, smem, dev, stream)
    assert args[3:6] == (p, k, int(lu))
    assert (args[7] is None) == (plan.slots == 0)
    assert args[8:11] == (plan.slots, plan.threads, plan.smem)
    assert (plan.slots * plan.slot_floats in allocs) == (plan.slots > 0)
    counts = {n: c for n, c in policy.launch_counts().items() if c}
    assert counts == {"batched_lu_solve" if lu
                      else "batched_spd_solve_block": 1}


def test_block_max_k_follows_the_cards_shared_memory(lean_entry):
    """block_max_k from the card's opt-in shared memory: an H100's 227 KB
    holds SPD systems to k = 320 in one CTA (the packed lower triangle;
    LU 220, whole rows and its panel); one above, the scratch slots."""
    assert batched_solve.block_max_k(-1) == 320
    assert batched_solve.block_max_k(-1, lu=True) == 220
    for lu in (False, True):
        top = batched_solve.block_max_k(-1, lu)
        assert batched_solve.solve_plan(
            2048, top, lu, H100_SMEM_OPTIN, 132).route == "block"
        assert batched_solve.solve_plan(
            2048, top + 1, lu, H100_SMEM_OPTIN, 132).route == "scratch"


def test_blocked_solve_panel_width_matches_the_source():
    """The plan's panel width NB is the kernel's kNB: the shared bytes the
    plan asks for are what the C entry checks."""
    import re
    from pathlib import Path

    src = (Path(_build.CSRC) / "batched_solve.cu").read_text()
    assert int(re.search(r"constexpr int kNB = (\d+);", src).group(1)) \
        == batched_solve.NB


def test_mu_update_tile_rows_cover_each_row_once():
    """K6's plan for k <= 32 (csrc/mu_update.cu checks the same rules):
    whole tiles of a multiple of 4 rows, at most TILE_FLOATS floats, about
    two per SM on a short M; 0 above 32 (one thread per element)."""
    for k in (1, 3, 4, 20, 32):
        for p in (1, 7, 129, 11314, 804414):
            r = mu_update.tile_rows(p, k, 132)
            assert r >= 4 and r % 4 == 0 and r * k <= mu_update.TILE_FLOATS
            n_tiles = -(-p // r)
            assert (n_tiles - 1) * r < p <= n_tiles * r
            if p >= 2 * 132 * r:
                assert r == mu_update.TILE_FLOATS // k // 4 * 4
    assert mu_update.tile_rows(11314, 20, 132) == 44
    assert mu_update.tile_rows(804414, 20, 132) == 128
    assert mu_update.tile_rows(100, 33, 132) == 0


def test_sigmoid_cpu_wrappers_take_plain_versions_without_launching(rng):
    X, M, B = _sig_operands(rng, 9, 30, 4)
    d = rng.randn(9, 4)
    H, G = _spd(rng, 9, 4)
    policy.reset_launch_counts()
    a = sigmoid_newton.sigmoid_gh_pass(_t(X), _t(M), _t(B), 0.1, 0.2)
    b = sigmoid_newton.sigmoid_gh_pass_ref(_t(X), _t(M), _t(B), 0.1, 0.2)
    kw = dict(trials=3, non_negative=True)
    c = sigmoid_newton.sigmoid_phi_pass(_t(X), _t(M), _t(d), _t(B), 0.1, 0.2,
                                        **kw)
    e = sigmoid_newton.sigmoid_phi_pass_ref(_t(X), _t(M), _t(d), _t(B), 0.1,
                                            0.2, **kw)
    f = batched_solve.batched_spd_solve(_t(H), _t(G))
    g = batched_solve.batched_spd_solve_ref(_t(H), _t(G))
    for x, y in list(zip(a, b)) + [(c, e), (f, g)]:
        assert torch.equal(x, y)
    for name in ("sigmoid_gh_pass", "sigmoid_phi_pass", "batched_spd_solve"):
        assert policy.launch_counts()[name] == 0


def test_sigmoid_wrappers_refuse_fp8_and_transposed_views(rng):
    """fp8 data other than float8_e4m3fn (the e5m2 format, which no kernel
    form takes) and, on the card, transposed views."""
    X, M, B = _sig_operands(rng, 8, 6, 2)
    X8 = _t(X, torch.float32).to(torch.float8_e5m2)
    f = lambda a: _t(a, torch.float32)  # noqa: E731
    with pytest.raises(NotImplementedError, match="float8_e4m3fn"):
        sigmoid_newton.sigmoid_gh_pass(X8, f(M), f(B), 0.0, 0.0)
    with pytest.raises(NotImplementedError, match="float8_e4m3fn"):
        sigmoid_newton.sigmoid_phi_pass(X8, f(M), f(M), f(B), 0.0, 0.0,
                                        trials=2, non_negative=True)
    # the card's operand check: Xᵀ must be a contiguous copy, not a view
    Xt = f(X.T.copy()).mT
    with pytest.raises(ValueError, match="Coupled.At"):
        sigmoid_newton._card_operands(Xt, f(M), f(B))


# -- k > 32: the plain versions against the Pallas kernels, and the card's
# plans and operand checks (the CUDA kernels take any k, wider than 32 in
# 32-component slices or tiles of the product table) ------------------------

_WIDE_K = [33, 40, 64, 100]


@pytest.mark.parametrize("k", _WIDE_K)
def test_mu_pass_wide_k_f64_matches_pallas(rng, k):
    X, U, V, VtV, _ = _operands(rng, 61, 40, k)
    args = (0.2, 0.5, 1e-10)
    want = j_mu(jnp.asarray(X), jnp.asarray(U), jnp.asarray(V),
                jnp.asarray(VtV), *args, row_tile=16, n_valid=50)
    got = mu_fused.fused_mu_u_pass(_t(X), _t(U), _t(V), _t(VtV), *args,
                                   n_valid=50)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("k", _WIDE_K)
def test_newton_pass_wide_k_f64_matches_pallas(rng, k):
    """m > k (96, or k + 32 past that): with m < k, BᵀB has rank m and
    the damped Hinv's condition number (~1e4) amplifies f64 rounding past
    rtol 1e-10."""
    X, U, V, BtB, Hinv = _operands(rng, 61, max(96, k + 32), k)
    row_sq = (X ** 2).sum(axis=1)
    kw = dict(trials=8, non_negative=True)
    want = j_newton(jnp.asarray(X), jnp.asarray(U), jnp.asarray(V),
                    jnp.asarray(BtB), jnp.asarray(Hinv), jnp.asarray(row_sq),
                    0.0, 0.01, row_tile=16, **kw)
    got = newton_fused.fused_newton_linear_u_pass(
        _t(X), _t(U), _t(V), _t(BtB), _t(Hinv), _t(row_sq), 0.0, 0.01, **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("k", _WIDE_K)
def test_sigmoid_gh_wide_k_f64_matches_pallas(rng, k):
    X, M, B = _sig_operands(rng, 7, 33, k)
    want = j_gh(jnp.asarray(X), jnp.asarray(M), jnp.asarray(B), 0.05, 0.2)
    got = sigmoid_newton.sigmoid_gh_pass(_t(X), _t(M), _t(B), 0.05, 0.2)
    assert got[1].shape == (7, k, k)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("k", _WIDE_K)
def test_sigmoid_phi_wide_k_f64_matches_pallas(rng, k):
    X, M, B = _sig_operands(rng, 7, 33, k)
    d = 0.1 * rng.randn(7, k)
    kw = dict(trials=8, non_negative=False)
    want = j_phi(jnp.asarray(X), jnp.asarray(M), jnp.asarray(d),
                 jnp.asarray(B), 0.05, 0.2, **kw)
    got = sigmoid_newton.sigmoid_phi_pass(_t(X), _t(M), _t(d), _t(B), 0.05,
                                          0.2, **kw)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-10)


@pytest.mark.parametrize("n,m", [(1, 1), (65, 129), (30000, 11314)])
@pytest.mark.parametrize("k", [33, 64, 100, 128])
@pytest.mark.parametrize("x_bytes", [2, 4])
def test_u_pass_plan_wide_k_slices_cover_each_component_once(n, m, k,
                                                             x_bytes):
    """k > 32 (csrc/u_pass_wide.cu's wide route): at k <= 128 one slice
    of ceil(k / 8) n8 tiles (from 9, the next even count: the instantiated
    ones) covers 0 .. k-1, so each sweep reads X once; Vᵀ and U_newᵀ hold
    its rows, and the last workspace part holds the X V and scratch rows
    (2 n k floats) as well as the column sweep's partials."""
    p = mu_fused.u_pass_plan(n, m, k, x_bytes, 132)
    assert p.k_slices == 1 and p.nt == mu_fused.wide_nt(k)
    # the n8 tile counts the C side instantiates (u_pass_wide.cuh)
    assert p.nt in (5, 6, 7, 8, 10, 12, 14, 16)
    assert 8 * p.nt - 16 < k <= 8 * p.nt
    comps = [c for s in range(p.k_slices)
             for c in range(8 * p.nt * s, min(k, 8 * p.nt * (s + 1)))]
    assert comps == list(range(k))
    ends = list(p.offsets[1:]) + [p.floats]
    planes = 2 if x_bytes == 4 else 1  # f32: Vᵀ's 3 TF32 parts, U_newᵀ's 2
    sizes = ((planes + planes // 2) * 8 * p.nt * p.ld_vt * x_bytes / 4,
             planes * 8 * p.nt * p.ld_ux * x_bytes / 4,
             p.row_blocks * k * k,
             max(2 * n * k, p.n_seg * m * k if p.n_seg > 1 else 0))
    for off, size, end in zip(p.offsets, sizes, ends):
        assert off % mu_fused.WORK_ALIGN == 0 and off + size <= end
    assert mu_fused.u_pass_plan(n, m, 32, x_bytes, 132).k_slices == 1


@pytest.mark.parametrize("n,m", [(1, 1), (65, 129), (30000, 11314)])
@pytest.mark.parametrize("k", [100, 128, 129, 200])
@pytest.mark.parametrize("x_bytes", [2, 4])
def test_u_pass_plan_wide_route_covers_rows_columns_components_once(
        n, m, k, x_bytes):
    """The wide route's grids (csrc/u_pass_wide.cuh): the row sweep's
    blocks (128 rows times the slices, the slice fastest), the epilogue's
    64-row blocks and the column sweep's blocks (slice, 128-column block,
    row segment, the slice fastest) each cover every row, column and
    component once, counted on numpy grids; one slice up to k = 128,
    slices of 128 components above; the workspace parts hold Vᵀ and U_newᵀ
    (every slice's rows; f32 X: three and two planes of TF32 parts), the
    Gram partials and the X V and scratch rows within the plan's floats."""
    p = mu_fused.u_pass_plan(n, m, k, x_bytes, 132)
    ceil = lambda a, b: -(-a // b)  # noqa: E731
    assert p.k_slices == mu_fused.wide_slices(k) == (1 if k <= 128 else
                                                      ceil(k, 128))
    per = 8 * p.nt // p.k_slices  # components a slice
    assert per == (8 * mu_fused.wide_nt(k) if k <= 128 else 128)
    for rows_cta, blocks in ((128, ceil(n, 128)), (64, p.row_blocks)):
        # the row sweep's blocks, then the epilogue's (every slice at once)
        slices, width = (p.k_slices, per) if rows_cta == 128 else (1, k)
        seen = np.zeros((n, k), np.int32)
        for b in range(blocks * slices):
            s, r0 = b % slices, b // slices * rows_cta
            seen[r0:r0 + rows_cta, s * width:(s + 1) * width] += 1
        assert (seen == 1).all()
    seen = np.zeros((p.n_seg, m, k), np.int32)
    for b in range(p.k_slices * p.col_slices * p.n_seg):
        s = b % p.k_slices
        c0 = b // p.k_slices % p.col_slices * mu_fused.B_COLS
        seg = b // p.k_slices // p.col_slices
        seen[seg, c0:c0 + mu_fused.B_COLS, s * per:(s + 1) * per] += 1
    assert (seen == 1).all()
    rows = np.zeros(n, np.int32)
    for s in range(p.n_seg):
        rows[s * p.seg_rows:(s + 1) * p.seg_rows] += 1
    assert (rows == 1).all()
    planes = 2 if x_bytes == 4 else 1
    sizes = ((planes + planes // 2) * 8 * p.nt * p.ld_vt * x_bytes / 4,
             planes * 8 * p.nt * p.ld_ux * x_bytes / 4, p.row_blocks * k * k,
             max(2 * n * k, p.n_seg * m * k if p.n_seg > 1 else 0))
    ends = list(p.offsets[1:]) + [p.floats]
    for off, size, end in zip(p.offsets, sizes, ends):
        assert off % mu_fused.WORK_ALIGN == 0 and off + size <= end


_SPLAN_SHAPES = [(1, 1, 1), (17, 15, 7), (20, 11314, 20), (30000, 11314, 20),
                 (11314, 30000, 20), (17, 4097, 33), (20, 300, 64),
                 (1, 15, 100), (65, 97, 300)]


@pytest.mark.parametrize("n,q,k", _SPLAN_SHAPES)
@pytest.mark.parametrize("x_bytes", [2, 4])
@pytest.mark.parametrize("n_sm", [1, 132])
def test_sigmoid_gh_plan_covers_each_row_column_and_segment_once(n, q, k,
                                                                x_bytes,
                                                                n_sm):
    """K3's plan (csrc/sigmoid_newton.cu checks the same rules in
    splan_ok): row tiles, q segments (whole 32-column chunks) and the
    product table's 128-column tiles cover rows, q and the table exactly
    once; the table holds B's padded columns then every pair (a <= b);
    the CTA's shared memory fits, and the workspace parts hold the padded
    B, M's two TF32 parts, T's pair columns (32 words per chunk and column)
    and one partial per (segment, row)."""
    p = sigmoid_newton.gh_plan(n, q, k, x_bytes, n_sm)
    rows = [r for t in range(p.row_tiles)
            for r in range(t * sigmoid_newton.ROWS,
                           min(n, (t + 1) * sigmoid_newton.ROWS))]
    assert rows == list(range(n))
    assert p.seg_len % sigmoid_newton.CHUNK == 0
    cols = [c for s in range(p.n_seg)
            for c in range(s * p.seg_len, min(q, (s + 1) * p.seg_len))]
    assert cols == list(range(q))
    assert p.kg == 8 * -(-k // 8)
    g0 = sigmoid_newton.g_offset(k)  # T = [pairs, padded to 8 | B]
    assert g0 % 8 == 0 and k * (k + 1) // 2 <= g0 < k * (k + 1) // 2 + 8
    assert p.ldp >= g0 + p.kg
    tiles = [c for t in range(p.col_tiles)
             for c in range(t * sigmoid_newton.COLS,
                            (t + 1) * sigmoid_newton.COLS)]
    assert tiles == list(range(p.ldp))
    assert p.smem == sigmoid_newton.smem_bytes(x_bytes, p.kg, True,
                                               p.ops_smem, 1)
    assert p.smem <= sigmoid_newton.SMEM_MAX
    q_pad = sigmoid_newton.CHUNK * -(-q // sigmoid_newton.CHUNK)
    rows = sigmoid_newton.ROWS * p.row_tiles * p.kg
    sizes = (q_pad * p.kg, rows, rows, q_pad * p.ldp, p.n_seg * n * p.ldp)
    ends = list(p.offsets[1:]) + [p.floats]
    for off, size, end in zip(p.offsets, sizes, ends):
        assert off % sigmoid_newton.WORK_ALIGN == 0 and off + size <= end
    assert p.n_seg == 1 or \
        p.row_tiles * p.col_tiles * (p.n_seg - 1) \
        < sigmoid_newton.CTAS_PER_SM * n_sm


@pytest.mark.parametrize("n,q,k", _SPLAN_SHAPES)
@pytest.mark.parametrize("slots", [1, 9, 256])
def test_sigmoid_phi_plan_covers_each_row_and_segment_once(n, q, k, slots):
    """K4's plan: rows and q segments covered once, the per-(row, slot)
    sums fit in shared memory with the operands there or in device memory,
    and the workspace holds B, M and d padded to kg columns and one partial
    per (segment, row, slot)."""
    p = sigmoid_newton.phi_plan(n, q, k, slots, 2, 132)
    assert p.kg == 8 * -(-k // 8) and p.col_tiles == 1 and p.ldp == 0
    cols = [c for s in range(p.n_seg)
            for c in range(s * p.seg_len, min(q, (s + 1) * p.seg_len))]
    assert cols == list(range(q))
    assert p.row_tiles * sigmoid_newton.ROWS >= n
    assert p.smem <= sigmoid_newton.SMEM_MAX
    assert p.ops_smem == int(sigmoid_newton.smem_bytes(
        2, p.kg, False, True, slots) <= sigmoid_newton.SMEM_MAX)
    padded = sigmoid_newton.ROWS * p.row_tiles * p.kg
    sizes = (sigmoid_newton.CHUNK * -(-q // sigmoid_newton.CHUNK) * p.kg,
             padded, padded, p.n_seg * n * slots)
    ends = list(p.offsets[1:]) + [p.floats]
    for off, size, end in zip(p.offsets, sizes, ends):
        assert off % sigmoid_newton.WORK_ALIGN == 0 and off + size <= end


def test_sigmoid_plans_at_the_main_shapes():
    """Path A's Z update (20 x 11314) splits q so that its one row tile
    fills the card; path B's 30000 rows take one segment; both keep their
    operands in shared memory at two CTAs per SM."""
    a = sigmoid_newton.gh_plan(20, 11314, 20, 2, 132)
    assert (a.row_tiles, a.col_tiles, a.ldp) == (1, 2, 256)
    assert a.n_seg * a.col_tiles >= 132 and a.ops_smem == 1
    b = sigmoid_newton.gh_plan(30000, 11314, 20, 2, 132)
    assert (b.row_tiles, b.n_seg, b.ops_smem) == (469, 1, 1)
    assert 2 * b.smem <= 228 * 1024
    f = sigmoid_newton.phi_plan(20, 11314, 20, 9, 2, 132)
    assert f.n_seg >= 132 and f.ops_smem == 1


@pytest.mark.parametrize("k", [1, 32, 33, 64, 100, 128])
@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16,
                                 torch.float8_e4m3fn])
def test_card_operand_checks_take_any_k(k, xdt):
    """The CUDA wrappers' operand checks, called directly: any k for f32,
    bf16 or e4m3 data and f32 factors; float64 factors (naming ROADMAP C1)
    and e5m2 data still refused."""
    X = torch.zeros(5, 7, dtype=xdt)
    U, V = torch.zeros(5, k), torch.zeros(7, k)
    S = torch.zeros(k, k)
    mu_fused.check_card_operands(X, U, V, (S,))
    sigmoid_newton._card_operands(X, U, V)
    with pytest.raises(NotImplementedError, match="ROADMAP C1"):
        mu_fused.check_card_operands(X, U.double(), V.double(), ())
    with pytest.raises(NotImplementedError, match="ROADMAP C1"):
        mu_fused.check_card_operands(X.double(), U, V, ())
    with pytest.raises(NotImplementedError, match="float8_e4m3fn"):
        sigmoid_newton.sigmoid_gh_pass(X.float().to(torch.float8_e5m2),
                                       U, V, 0.0, 0.0)
    with pytest.raises(NotImplementedError, match="float8_e4m3fn"):
        mu_fused.check_card_operands(X.float().to(torch.float8_e5m2), U, V,
                                     ())
