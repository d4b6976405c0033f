"""fp8 data storage (data_dtype='fp8', float8_e4m3fn) in the port, on the
CPU, against the reference (pycmf_tpu, its Pallas kernels in interpret
mode as tests/test_fp8.py runs them) and against the port's own bf16 path.

Tolerances:
- the four data-pass kernels' plain versions on e4m3 X against the Pallas
  kernels on the same X: the bf16 tests' bars (tests/test_torch_kernels.py):
  rtol 1e-5 on U_new and gramU, 1e-4 on numV; the sigmoid passes 1e-4
  (G, H) and 1e-5 (φ) of the largest entry. Both widen e4m3 to bf16
  exactly, round V and U_new to bf16 at the same points and sum in f32 in
  different orders.
- the port's fp8 fit against its bf16 fit on X quantized to e4m3: equal bit
  for bit. Every e4m3 value is exact in bf16, the fp8 norms are those of
  the quantized values, and the roundings of V and U_new are the same.
- the port's fp8 fit against the reference's: objective gap < 1e-4 at every
  eval point (the bf16 bar, tests/test_torch_estimator.py).
"""
import types
import warnings

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from pycmf_tpu import CMF as JCMF
from pycmf_tpu.ops.pallas.mu_fused import fused_mu_u_pass as j_mu
from pycmf_tpu.ops.pallas.newton_fused import \
    fused_newton_linear_u_pass as j_newton
from pycmf_tpu.ops.pallas.sigmoid_newton import sigmoid_gh_pass as j_gh
from pycmf_tpu.ops.pallas.sigmoid_newton import sigmoid_phi_pass as j_phi
from pycmf_tpu.utils.validation import as_coupled as j_as_coupled
from pycmf_tpu_torch import CMF
from pycmf_tpu_torch.models import cmf as tcmf
from pycmf_tpu_torch.ops import losses as tlosses
from pycmf_tpu_torch.ops.kernels import (_build, mu_fused, newton_fused,
                                         policy, sigmoid_newton)
from pycmf_tpu_torch.ops.matmul import (contiguous_t, matmul, operand_dtype,
                                        select_columns)
from pycmf_tpu_torch.utils.validation import as_coupled
from tests.conftest import make_problem

F8 = torch.float8_e4m3fn


def _fp8_exact(rng, n, m):
    """The reference's data (tests/test_fp8.py): small integer halves,
    exact in e4m3."""
    return (rng.randint(0, 8, size=(n, m)) * 0.5).astype(np.float64)


def _in_range(rng, n, m):
    """Random in-range data that quantization rounds: the bf16 tests'
    |N(0, 1)| data, scaled by 4 (a few subnormals below 2^-6)."""
    return 4.0 * np.abs(rng.randn(n, m))


def _wide(rng, n, m):
    """Random data over all of e4m3's range (|x| <= 448, subnormals and
    zeros included), for the checks that hold bit for bit."""
    return np.minimum(np.abs(rng.randn(n, m))
                      * np.exp2(rng.randint(-11, 7, (n, m))), 440.0)


_DATA = {"exact": _fp8_exact, "in_range": _in_range}


def _q(a):
    """a quantized to e4m3, as float64 (the reference's conversion)."""
    return np.asarray(a, np.float64).astype(ml_dtypes.float8_e4m3fn) \
        .astype(np.float64)


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a, dtype=np.float64)).to(dtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float64).numpy()
    return np.asarray(x, dtype=np.float64)


def _close_to_scale(got, want, rtol):
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def _upass_operands(rng, data, n, m, k):
    X = _DATA[data](rng, n, m)
    U = np.abs(rng.randn(n, k))
    V = np.abs(rng.randn(m, k))
    return X, U, V


# -- the four data-pass kernels: plain versions on e4m3 X against the
# Pallas kernels on the same X -------------------------------------------

@pytest.mark.parametrize("data", sorted(_DATA))
@pytest.mark.parametrize("n", [60, 61])
def test_mu_pass_fp8_matches_pallas(rng, data, n):
    X, U, V = _upass_operands(rng, data, n, 40, 4)
    V32 = V.astype(np.float32)
    VtV = V32.T @ V32
    args = (0.01, 0.02, 1e-10)
    want = j_mu(jnp.asarray(X, jnp.float8_e4m3fn),
                jnp.asarray(U, jnp.float32), jnp.asarray(V32),
                jnp.asarray(VtV), *args, row_tile=16)
    got = mu_fused.fused_mu_u_pass(_t(X, F8), _t(U), _t(V32), _t(VtV), *args)
    assert all(g.dtype == torch.float32 for g in got)
    np.testing.assert_allclose(_np(got[0]), _np(want[0]), rtol=1e-5)
    np.testing.assert_allclose(_np(got[1]), _np(want[1]), rtol=1e-4)
    np.testing.assert_allclose(_np(got[2]), _np(want[2]), rtol=1e-5)


@pytest.mark.parametrize("data", sorted(_DATA))
@pytest.mark.parametrize("n", [60, 61])
def test_newton_pass_fp8_matches_pallas(rng, data, n):
    X, U, V = _upass_operands(rng, data, n, 40, 4)
    V32 = V.astype(np.float32)
    BtB = V32.T @ V32
    Hinv = np.linalg.inv(BtB + 0.21 * np.eye(4)).astype(np.float32)
    row_sq = (_q(X) ** 2).sum(axis=1).astype(np.float32)
    l1, l2 = 0.001, 0.01
    want = j_newton(jnp.asarray(X, jnp.float8_e4m3fn),
                    jnp.asarray(U, jnp.float32), jnp.asarray(V32),
                    jnp.asarray(BtB), jnp.asarray(Hinv), jnp.asarray(row_sq),
                    l1, l2, trials=8, non_negative=True, row_tile=16)
    got = newton_fused.fused_newton_linear_u_pass(
        _t(X, F8), _t(U), _t(V32), _t(BtB), _t(Hinv), _t(row_sq), l1, l2,
        trials=8, non_negative=True)
    np.testing.assert_allclose(_np(got[0]), _np(want[0]), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(_np(got[1]), _np(want[1]), rtol=1e-4)
    np.testing.assert_allclose(_np(got[2]), _np(want[2]), rtol=1e-5)


def _sig_operands(rng, data, n, m, k):
    return _DATA[data](rng, n, m), 0.5 * rng.randn(n, k), 0.5 * rng.randn(m, k)


@pytest.mark.parametrize("data", sorted(_DATA))
@pytest.mark.parametrize("n", [60, 61])
def test_sigmoid_gh_fp8_matches_pallas(rng, data, n):
    X, M, B = _sig_operands(rng, data, n, 90, 5)
    want = j_gh(jnp.asarray(X, jnp.float8_e4m3fn), jnp.asarray(M, jnp.float32),
                jnp.asarray(B, jnp.float32), 0.01, 0.02)
    got = sigmoid_newton.sigmoid_gh_pass(_t(X, F8), _t(M), _t(B), 0.01, 0.02)
    assert all(g.dtype == torch.float32 for g in got)
    for g, w in zip(got, want):
        _close_to_scale(g, w, 1e-4)


@pytest.mark.parametrize("data", sorted(_DATA))
@pytest.mark.parametrize("n", [60, 61])
def test_sigmoid_phi_fp8_matches_pallas(rng, data, n):
    X, M, B = _sig_operands(rng, data, n, 90, 5)
    d = 0.1 * rng.randn(n, 5)
    want = j_phi(jnp.asarray(X, jnp.float8_e4m3fn),
                 *(jnp.asarray(a, jnp.float32) for a in (np.abs(M), d, B)),
                 0.01, 0.02, trials=8, non_negative=True)
    got = sigmoid_newton.sigmoid_phi_pass(_t(X, F8), _t(np.abs(M)), _t(d),
                                          _t(B), 0.01, 0.02, trials=8,
                                          non_negative=True)
    assert got.dtype == torch.float32
    _close_to_scale(got, want, 1e-5)


def _kernel_calls(rng, n, m, k):
    """Each data-pass kernel's plain version as a function of X."""
    U, V = _t(np.abs(rng.randn(n, k))), _t(np.abs(rng.randn(m, k)))
    M, B, d = _t(0.5 * rng.randn(n, k)), _t(0.5 * rng.randn(m, k)), \
        _t(0.1 * rng.randn(n, k))
    VtV = V.T @ V
    Hinv = torch.linalg.inv(VtV + 0.21 * torch.eye(k))
    rs = _t(rng.rand(n) * 100)
    return {
        "fused_mu_u_pass": lambda X: mu_fused.fused_mu_u_pass_ref(
            X, U, V, VtV, 0.01, 0.02, 1e-10, n_valid=n - 3),
        "fused_newton_linear_u_pass":
            lambda X: newton_fused.fused_newton_linear_u_pass_ref(
                X, U, V, VtV, Hinv, rs, 0.001, 0.01, trials=8,
                non_negative=True),
        "sigmoid_gh_pass": lambda X: sigmoid_newton.sigmoid_gh_pass_ref(
            X, M, B, 0.01, 0.02),
        "sigmoid_phi_pass": lambda X: (sigmoid_newton.sigmoid_phi_pass_ref(
            X, M, d, B, 0.01, 0.02, trials=8, non_negative=False),),
    }


@pytest.mark.parametrize("kernel", ["fused_mu_u_pass",
                                    "fused_newton_linear_u_pass",
                                    "sigmoid_gh_pass", "sigmoid_phi_pass"])
def test_fp8_plain_versions_equal_bf16_on_widened_x(rng, kernel):
    """Each kernel's plain version on e4m3 X equals, bit for bit, its bf16
    form on X widened to bf16: the property the card's fp8 forms are held
    to against their bf16 forms (chip_smoke.py phase 3)."""
    X8 = _t(_wide(rng, 37, 45), F8)
    fn = _kernel_calls(rng, 37, 45, 6)[kernel]
    for a, b in zip(fn(X8), fn(X8.to(torch.bfloat16))):
        assert torch.equal(a, b)


# -- ingest ---------------------------------------------------------------

@pytest.mark.parametrize("sparse", [False, True])
def test_fp8_ingest_matches_reference(rng, sparse):
    """The stored e4m3 bytes and the norms of the stored (quantized) values
    equal the reference's, for dense input and for sparse input densified
    through a float32 buffer; the float64 input rounds through float32 as
    the reference's conversion does."""
    A = _wide(rng, 23, 31) * (rng.rand(23, 31) < 0.4)
    A = sp.csr_matrix(A) if sparse else A
    kw = dict(sparse_mode="dense") if sparse else {}
    c = as_coupled(A, F8, "cpu", **kw)
    j = j_as_coupled(A, jnp.float8_e4m3fn, **kw)
    assert c.A.dtype == F8
    np.testing.assert_array_equal(c.A.view(torch.uint8).numpy(),
                                  np.asarray(j.A).view(np.uint8))
    for name in ("row_sq", "row_sq_t", "a_sq"):
        got, want = getattr(c, name), getattr(j, name)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(_np(got), np.asarray(want, np.float64),
                                   rtol=1e-9)
    q = _q(A.toarray() if sparse else A)
    np.testing.assert_allclose(_np(c.a_sq), (q ** 2).sum(), rtol=1e-6)


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("big", [449.0, 1000.0])
def test_fp8_range_guard(rng, sparse, big):
    """|x| past e4m3's 448 raises ValueError naming the range, as in the
    reference. Here the guard is the only one: torch's conversion saturates
    to 448 where the reference's gives NaN."""
    A = np.abs(rng.randn(16, 16)) + 1.0
    A[3, 4] = big
    assert float(torch.tensor(big).to(F8)) == 448.0
    A = sp.csr_matrix(A) if sparse else A
    with pytest.raises(ValueError, match="range"):
        as_coupled(A, F8, "cpu", sparse_mode="dense")
    with pytest.raises(ValueError, match="range"):
        j_as_coupled(A, jnp.float8_e4m3fn, sparse_mode="dense")
    X, Y = make_problem(rng, n=16, m=16)
    with pytest.raises(ValueError, match="range"):
        CMF(n_components=2, data_dtype="fp8", device="cpu").fit(A, Y)


def test_fp8_stores_y_at_bf16(rng, monkeypatch):
    """Only X is stored at fp8; Y is bf16 (and its dense copy counts 2
    bytes per element against the densify threshold)."""
    X, Y = make_problem(rng, n=30, m=20)
    seen = {}
    real = tcmf.run_mu

    def spy(Xc, Yc, *a, **kw):
        seen.update(x=Xc.A.dtype, y=Yc.A.dtype)
        return real(Xc, Yc, *a, **kw)
    monkeypatch.setattr(tcmf, "run_mu", spy)
    est = CMF(n_components=2, data_dtype="fp8", device="cpu", max_iter=2)
    est.fit(X, Y)
    assert seen == dict(x=F8, y=torch.bfloat16)
    assert est._y_dtype() == torch.bfloat16
    assert CMF(data_dtype="bfloat16")._y_dtype() == torch.bfloat16
    # 'auto' densifies Y by its bf16 bytes, 2 per element; X's fp8 by the
    # float32 buffer it goes through, 4
    Ys, Xs = sp.csr_matrix(Y), sp.csr_matrix(X)
    for A, dt, item in ((Ys, est._y_dtype(), 2), (Xs, F8, 4)):
        size = A.shape[0] * A.shape[1] * item
        c = as_coupled(A, dt, "cpu", densify_threshold=size)
        assert isinstance(c.A, torch.Tensor) and c.A.dtype == dt
        if dt != F8:
            c = as_coupled(A, dt, "cpu", densify_threshold=size - 1)
            assert not isinstance(c.A, torch.Tensor)
    with pytest.raises(ValueError, match="dense device form"):
        as_coupled(Xs, F8, "cpu", densify_threshold=Xs.shape[0]
                   * Xs.shape[1] * 4 - 1)


def test_fp8_storage_helpers_are_exact(rng):
    """The byte-view helpers the solvers use on fp8 data (a transposed
    contiguous copy, a column gather) and the bf16 product rule."""
    X8 = _t(_wide(rng, 9, 13), F8)
    Xf = X8.to(torch.float32)
    assert torch.equal(contiguous_t(X8).to(torch.float32), Xf.T)
    idx = torch.tensor([0, 3, 12])
    assert torch.equal(select_columns(X8, idx).to(torch.float32), Xf[:, idx])
    assert torch.equal(select_columns(X8.mT, torch.tensor([1, 8]))
                       .to(torch.float32), Xf.T[:, [1, 8]])
    assert operand_dtype(F8) == torch.bfloat16
    assert operand_dtype(torch.float32) == torch.float32
    B = _t(rng.randn(13, 3))
    assert torch.equal(matmul(X8, B), matmul(X8.to(torch.bfloat16), B))


def test_fp8_linear_term_upcasts_in_row_blocks(rng, monkeypatch):
    """Past _BLOCK_ELEMS the factored linear term's sums over fp8 (or
    bf16) data upcast A one row block at a time, never as a whole; data at
    the factors' dtype takes one product. The sum is the whole product's
    up to f32 summation order."""
    A8 = _t(_wide(rng, 64, 40), F8)
    M, B = _t(rng.rand(64, 3)), _t(rng.rand(40, 3))
    rows = []

    def inner(Ab, Mb):
        rows.append(Ab.shape[0])
        return torch.sum(matmul(Ab, B) * Mb)
    whole = inner(A8, M)
    monkeypatch.setattr(tlosses, "_BLOCK_ELEMS", 10 * 40)
    for A in (A8, A8.to(torch.bfloat16)):
        rows.clear()
        got = tlosses._row_blocks_sum(A, M, inner)
        assert rows == [10] * 6 + [4]
        np.testing.assert_allclose(_np(got), _np(whole), rtol=1e-6)
    rows.clear()
    tlosses._row_blocks_sum(A8.to(torch.float32), M, inner)
    assert rows == [64]


# -- the estimator --------------------------------------------------------

def _fit_case(rng, case):
    X, Y = make_problem(rng, n=64, m=48)
    kw = dict(solver="newton")
    if case == "mu":
        kw = dict(solver="mu")
    elif case == "newton_sigmoid_y":
        kw.update(y_link="sigmoid")
        Y = (Y > np.median(Y)).astype(float)
    elif case == "sigmoid_x":
        kw.update(x_link="sigmoid", y_link="sigmoid", U_non_negative=False,
                  V_non_negative=False, Z_non_negative=False)
        X = rng.rand(64, 48) * (rng.rand(64, 48) < 0.5)
        Y = (Y > np.median(Y)).astype(float)
    elif case == "sampled":
        kw.update(y_link="sigmoid", sg_sample_ratio=0.25)
        Y = (Y > np.median(Y)).astype(float)
    k = 4
    init = (np.abs(rng.randn(64, k)), np.abs(rng.randn(48, k)),
            np.abs(rng.randn(Y.shape[1], k)))
    if case == "sigmoid_x":
        init = tuple(0.3 * rng.randn(*a.shape) for a in init)
    return X, Y, init, dict(n_components=k, random_state=0, max_iter=12,
                            eval_every=3, tol=0.0, **kw)


_CASES = ["mu", "newton_linear", "newton_sigmoid_y", "sigmoid_x", "sampled"]


@pytest.mark.parametrize("case", _CASES)
@pytest.mark.parametrize("use_pallas", [True, False])
def test_fp8_fit_equals_bf16_fit_on_quantized_x(rng, case, use_pallas):
    """A fit with data_dtype='fp8' is, by the reference's own arithmetic,
    the bf16 fit of X quantized to e4m3: equal bit for bit (losses,
    factors, n_iter_, and the fold-in of new rows)."""
    X, Y, (U0, V0, Z0), kw = _fit_case(rng, case)
    a = CMF(data_dtype="fp8", device="cpu", use_pallas=use_pallas, **kw)
    b = CMF(data_dtype="bfloat16", device="cpu", use_pallas=use_pallas, **kw)
    # the initial factors given: the default draw scales by X's mean,
    # which quantization changes
    out_a = a.fit_transform(X, Y, U=U0, V=V0, Z=Z0)
    out_b = b.fit_transform(_q(X), Y, U=U0, V=V0, Z=Z0)
    assert a.n_iter_ == b.n_iter_ == 12
    assert a.loss_history_ == b.loss_history_
    assert all(np.isfinite(a.loss_history_))
    for x, y in zip(out_a, out_b):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(a.transform(X[:9], U=U0[:9]),
                                  b.transform(_q(X[:9]), U=U0[:9]))


@pytest.mark.parametrize("case,max_iter", [("mu", 10), ("newton_linear", 1),
                                           ("newton_sigmoid_y", 1)])
@pytest.mark.parametrize("use_pallas", [True, False])
def test_fp8_objective_gap_vs_reference(case, max_iter, use_pallas):
    """data_dtype='fp8' against the reference's: objectives within 1e-4 at
    every eval point, over the depths of the bf16 comparison
    (tests/test_torch_estimator.py: test_bf16_data_objective_gap, whose
    docstring says why they are short)."""
    X, Y = make_problem(np.random.RandomState(1), n=61, noise=0.5)
    kw = dict(solver="newton")
    if case == "mu":
        kw = dict(solver="mu")
    elif case == "newton_sigmoid_y":
        kw.update(y_link="sigmoid")
        Y = (Y > np.median(Y)).astype(float)
    kw.update(n_components=4, random_state=0, max_iter=max_iter,
              eval_every=max_iter, data_dtype="fp8", use_pallas=use_pallas)
    j = JCMF(**kw).fit(X, Y)
    t = CMF(device="cpu", **kw).fit(X, Y)
    assert t.n_iter_ == j.n_iter_
    gap = np.abs(np.subtract(t.loss_history_, j.loss_history_)) \
        / np.asarray(j.loss_history_)
    assert gap.max() < 1e-4


def _refusal(rng, which):
    X, Y = make_problem(rng, n=48, m=40)
    Xs = sp.csr_matrix(np.where(X > np.median(X), X, 0.0))
    fit = dict(n_components=3, max_iter=2, tol=0.0, random_state=0)
    if which == "dtype":
        return dict(fit, dtype="fp8"), "data storage dtype", (X, Y), None
    if which == "transform_csr":
        return (dict(fit, data_dtype="fp8", sparse_mode="csr"),
                "dense device form", (X, Y), Xs[:10])
    mode = {"csr": "csr", "chunked": "chunked", "auto_past": "auto"}[which]
    return (dict(fit, data_dtype="fp8", sparse_mode=mode),
            "dense device storage", (Xs, Y), None)


@pytest.mark.parametrize("which", ["dtype", "csr", "chunked", "auto_past",
                                   "transform_csr"])
def test_fp8_refusals_match_reference(rng, monkeypatch, which):
    """Where the reference raises for fp8, the port raises the same
    ValueError: fp8 as the factor dtype; X staying CSR under 'csr',
    'chunked' and 'auto' past the densify threshold; transform of a CSR
    input (as_coupled's storage guard)."""
    kw, match, data, new = _refusal(rng, which)
    if which == "auto_past":
        import pycmf_tpu.utils.validation as jval

        monkeypatch.setattr(tcmf, "DENSIFY_THRESHOLD", 100)
        monkeypatch.setattr(jval, "DENSIFY_THRESHOLD", 100)
    for est in (CMF(device="cpu", **kw), JCMF(**kw)):
        if new is None:
            with pytest.raises(ValueError, match=match):
                est.fit(*data)
        else:
            est.fit(*data)
            with pytest.raises(ValueError, match=match):
                est.transform(new)


def test_fp8_allows_csr_y_and_sigmoid_newton_x(rng):
    """fp8 governs X's dense storage only: a CSR Y (stored bf16) and a
    sigmoid-linked sparse X under Newton with 'csr' (densified, with the
    reference's warning) fit, as in the reference, to its objective (both
    on the unfused branch, the reference's default on the CPU)."""
    X, Y = make_problem(rng, n=48, m=40)
    Ys = sp.csr_matrix(np.where(Y > np.median(Y), Y, 0.0))
    kw = dict(n_components=4, data_dtype="fp8", sparse_mode="csr",
              max_iter=4, eval_every=4, tol=0.0, random_state=0,
              use_pallas=False)
    t = CMF(device="cpu", **kw).fit(X, Ys)
    j = JCMF(**kw).fit(X, Ys)
    np.testing.assert_allclose(t.loss_history_, j.loss_history_, rtol=1e-4)

    Xs = sp.csr_matrix((X > np.median(X)).astype(float))
    # one Newton step: later ones amplify f32 rounding-order differences
    # to ~1e-3, bf16 X's as much (test_bf16_data_objective_gap)
    kw2 = dict(kw, solver="newton", x_link="sigmoid", max_iter=1,
               eval_every=1, U_non_negative=False, V_non_negative=False,
               Z_non_negative=False)
    with pytest.warns(UserWarning, match="overridden to 'dense'"):
        t2 = CMF(device="cpu", **kw2).fit(Xs, Y)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        j2 = JCMF(**kw2).fit(Xs, Y)
    assert np.all(np.isfinite(t2.loss_history_))
    np.testing.assert_allclose(t2.loss_history_, j2.loss_history_, rtol=1e-4)


def test_from_reference_fitted_with_fp8(rng):
    """CMF.from_reference takes a reference fitted with data_dtype='fp8':
    the params (fp8 included) and the factors carry across, and the fold-in
    of new rows agrees."""
    X, Y = make_problem(rng, n=48, m=40)
    j = JCMF(n_components=4, data_dtype="fp8", max_iter=10, tol=0.0,
             random_state=0).fit(X, Y)
    t = CMF.from_reference(j, device="cpu")
    assert t.data_dtype == "fp8" and t._resolve_data_dtype() == F8
    np.testing.assert_array_equal(t.V_, j.V_)
    Xn = np.abs(rng.randn(12, 40))
    np.testing.assert_allclose(t.transform(Xn), j.transform(Xn), rtol=1e-3,
                               atol=1e-5)


# -- the card's launch code, reached on the CPU with a fake library --------

@pytest.fixture
def fake_launch(monkeypatch):
    """K1-K4's wrappers routed through their launch code on CPU tensors: a
    fake library whose entries record their arguments."""
    rec = types.SimpleNamespace(calls=[])

    def entry(*args):
        rec.calls.append(args)
        return 0

    def occupancy(k, slice_cols, device, out):
        out._obj.value = 7  # an H100's resident clusters of 16
        return 0

    def fake_load(name):
        return types.SimpleNamespace(
            pycmf_mu_fused_u_pass=entry, pycmf_newton_fused_u_pass=entry,
            pycmf_mu_fused_u_pass_wide=entry,
            pycmf_newton_fused_u_pass_wide=entry,
            pycmf_sigmoid_gh_pass=entry, pycmf_sigmoid_phi_pass=entry,
            pycmf_u_pass_cluster_occupancy=occupancy,
            pycmf_error_string=lambda rc: b"fake failure")

    monkeypatch.setattr(_build, "load", fake_load)
    monkeypatch.setattr(_build, "_functions", {})
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda dev: 0xBEEF, raising=False)
    for mod in (mu_fused, newton_fused, sigmoid_newton):
        monkeypatch.setattr(mod, "on_card", lambda *t: True)
    for mod in (mu_fused, sigmoid_newton):
        monkeypatch.setattr(mod, "_sm_count", lambda dev: 132)
    yield rec


@pytest.mark.parametrize("kernel", ["fused_mu_u_pass",
                                    "fused_newton_linear_u_pass",
                                    "sigmoid_gh_pass", "sigmoid_phi_pass"])
def test_fp8_launch_passes_its_code_and_counts_apart(rng, fake_launch,
                                                     kernel):
    """On the card e4m3 X launches the kernel's fp8 form: X's code 2 goes
    to the C entry, the launch counts under <kernel>_fp8 (the f32 and bf16
    forms under <kernel>), and K1/K2 size Vᵀ and U_newᵀ in bf16, the
    operand dtype, as the bf16 call does."""
    n, m, k = 70, 50, 6
    X, M, B = _t(_in_range(rng, n, m)), _t(rng.rand(n, k)), _t(rng.rand(m, k))
    S = _t(np.eye(k))
    calls = {
        "fused_mu_u_pass": lambda X: mu_fused.fused_mu_u_pass(
            X, M, B, S, 0.0, 0.0, 1e-9),
        "fused_newton_linear_u_pass":
            lambda X: newton_fused.fused_newton_linear_u_pass(
                X, M, B, S, S, _t(np.ones(n)), 0.0, 0.0, trials=2,
                non_negative=True),
        "sigmoid_gh_pass": lambda X: sigmoid_newton.sigmoid_gh_pass(
            X, M, B, 0.0, 0.0),
        "sigmoid_phi_pass": lambda X: sigmoid_newton.sigmoid_phi_pass(
            X, M, M, B, 0.0, 0.0, trials=2, non_negative=True),
    }
    policy.reset_launch_counts()
    for dt in (torch.bfloat16, F8, torch.float32):
        calls[kernel](X.to(dt))
    codes = [c[0] for c in fake_launch.calls]
    assert codes == [1, 2, 0]
    counts = policy.launch_counts()
    assert counts[kernel] == 2 and counts[kernel + "_fp8"] == 1
    if kernel.startswith("fused"):
        # the four workspace parts' offsets: equal for bf16 and e4m3 X
        bf16, fp8 = (c[-10:-6] for c in fake_launch.calls[:2])
        base16, base8 = bf16[0], fp8[0]
        assert [a - base16 for a in bf16] == [a - base8 for a in fp8]
        assert mu_fused.u_pass_plan(n, m, k, 2, 132) == mu_fused.u_pass_plan(
            n, m, k, operand_dtype(F8).itemsize, 132)


@pytest.mark.parametrize("kernel", ["fused_mu_u_pass",
                                    "fused_newton_linear_u_pass"])
def test_f32_launch_takes_the_cluster_plan(rng, fake_launch, kernel):
    """f32 X at k <= 32 passes the cluster route's clusters (the card's
    resident count, 7 from the fake library's occupancy) and columns per
    CTA to the C entry; bf16 and e4m3 X pass none (the two sweeps)."""
    n, m, k = 70, 50, 6
    X, M, B = _t(_in_range(rng, n, m)), _t(rng.rand(n, k)), _t(rng.rand(m, k))
    S = _t(np.eye(k))
    mu_fused.cluster_limit.cache_clear()
    mu_fused._PLANS.clear()
    for dt in (torch.float32, torch.bfloat16, F8):
        A = X.to(dt)
        if kernel == "fused_mu_u_pass":
            mu_fused.fused_mu_u_pass(A, M, B, S, 0.0, 0.0, 1e-9)
        else:
            newton_fused.fused_newton_linear_u_pass(
                A, M, B, S, S, _t(np.ones(n)), 0.0, 0.0, trials=2,
                non_negative=True)
    # clusters and slice_cols come before Unew and the 14 trailing arguments
    got = [c[-15:-13] for c in fake_launch.calls]
    assert got == [(7, 16), (0, 0), (0, 0)]
    mu_fused.cluster_limit.cache_clear()
    mu_fused._PLANS.clear()


@pytest.mark.parametrize("kernel", ["fused_mu_u_pass",
                                    "fused_newton_linear_u_pass"])
@pytest.mark.parametrize("n", [1, 17, 200])
@pytest.mark.parametrize("m", [1, 15, 4097])
@pytest.mark.parametrize("k", [1, 20, 33, 64])
def test_fp8_launch_edges_take_the_bf16_plan(rng, fake_launch, kernel, n, m,
                                             k):
    """At the edges of the U pass's tiles (one row, a ragged row block,
    several; one column, odd m, a ragged column slice; k from one n8 tile
    to the wide route's one slice of eight), e4m3 X launches with code 2
    and the bf16 call's plan: the same leading dimensions, row segments
    and workspace layout, which the C side's e4m3 stages split into the
    bf16 form's chains. It counts under <kernel>_fp8 alone, or at k > 32
    under <kernel>_wide with the bf16 call (<kernel>_fp8 counts k <= 32
    alone)."""
    X = _t(_in_range(rng, n, m))
    U, V = _t(rng.rand(n, k)), _t(rng.rand(m, k))
    S = _t(np.eye(k))
    if kernel == "fused_mu_u_pass":
        def call(A):
            return mu_fused.fused_mu_u_pass(A, U, V, S, 0.0, 0.0, 1e-9)
    else:
        def call(A):
            return newton_fused.fused_newton_linear_u_pass(
                A, U, V, S, S, _t(np.ones(n)), 0.0, 0.0, trials=2,
                non_negative=True)
    policy.reset_launch_counts()
    call(X.to(torch.bfloat16))
    call(X.to(F8))
    (bf16, fp8) = fake_launch.calls
    assert (bf16[0], fp8[0]) == (1, 2)
    # ld_vt, ld_ux, seg_rows, n_seg; then the workspace parts' offsets
    assert bf16[-6:-2] == fp8[-6:-2]
    plan = mu_fused.u_pass_plan(n, m, k, 2, 132)
    assert fp8[-6:-2] == (plan.ld_vt, plan.ld_ux, plan.seg_rows, plan.n_seg)
    assert ([a - bf16[-10] for a in bf16[-10:-6]]
            == [a - fp8[-10] for a in fp8[-10:-6]])
    counts = policy.launch_counts()
    if k > 32:
        # the wide entry takes the plan's n8 tiles a slice and its slices
        # where the narrow one takes clusters and slice_cols
        assert bf16[-15:-13] == fp8[-15:-13] == (plan.nt // plan.k_slices,
                                                  plan.k_slices)
        assert (counts[kernel], counts[kernel + "_fp8"],
                counts[kernel + "_wide"]) == (0, 0, 2)
    else:
        assert counts[kernel] == 1 and counts[kernel + "_fp8"] == 1
