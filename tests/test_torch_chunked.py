"""The streamed chunked-COO layout of the port against the reference's, on
the CPU, and the batched solve's block and LU routes.

- ``ops/chunked.py`` against ``pycmf_tpu.ops.chunked`` at float64 (rtol
  1e-12 for single products, 1e-9 where a line search or a solve
  intervenes): the layout, its streamed products and norms, the two
  streamed U passes with ``use_pallas`` on (the CPU takes the fused
  kernels' plain versions) and off;
- ``solvers/newton_chunked.py`` against the reference's in both Hessian
  forms, with and without a column mask;
- whole fits of ``CMF(sparse_mode='chunked')`` against the reference's
  (its pick_chunk_rows and the port's both set to 16 rows, so that
  several chunks and a ragged last chunk occur): MU, Newton with linear
  links, sigmoid X in both forms, a sigmoid Y on the chunked carrier, a
  sampled fit (each package drawing its own columns, the same ones), and
  ``transform``; n_iter, loss histories (rtol 1e-9) and factors;
- the device loop's CPU stand-in against the host loop, bit for bit;
- the port's 'auto' rule, and fp8 with the chunked layout (refused);
- K5's block route (k > 64) and LU route, their plain versions against
  the reference's solves and the dispatch of every (k, form, use_pallas).
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from pycmf_tpu import CMF as JCMF
from pycmf_tpu.ops import chunked as jchunked
from pycmf_tpu.ops import losses as jlosses
from pycmf_tpu.ops.pallas.batched_solve import batched_spd_solve as j_solve
from pycmf_tpu.solvers import common as jcommon
from pycmf_tpu.solvers import newton as jnewton
from pycmf_tpu.solvers import newton_chunked as jnc
from pycmf_tpu_torch import CMF
from pycmf_tpu_torch.ops import chunked as tchunked
from pycmf_tpu_torch.ops import losses as tlosses
from pycmf_tpu_torch.ops.kernels import _build, batched_solve, policy
from pycmf_tpu_torch.solvers import common as tcommon
from pycmf_tpu_torch.solvers import newton as tnewton
from pycmf_tpu_torch.solvers import newton_chunked as tnc
from pycmf_tpu_torch.utils.validation import as_coupled
from tests.conftest import make_problem


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.asarray(a, dtype=np.float64)).to(dtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float64).numpy()
    return np.asarray(x, dtype=np.float64)


def _sparse(rng, n=61, m=40, density=0.2, binary=False):
    A = sp.random(n, m, density=density, format="csr", random_state=rng,
                  data_rvs=lambda s: rng.rand(s) + 0.5)
    if binary:
        A.data[:] = 1.0
    return A


def _pair(A, R):
    return (jchunked.chunked_from_scipy(A, jnp.float64, chunk_rows=R),
            tchunked.chunked_from_scipy(A, torch.float64, chunk_rows=R,
                                        device="cpu"))


@pytest.fixture
def chunk16(monkeypatch):
    """Both packages' estimators cut their chunked layouts into 16 rows."""
    monkeypatch.setattr(jchunked, "pick_chunk_rows", lambda *a, **k: 16)
    monkeypatch.setattr(tchunked, "pick_chunk_rows", lambda *a, **k: 16)


# -- the layout -------------------------------------------------------------

def test_layout_matches_reference(rng):
    A = _sparse(rng)
    J, T = _pair(A, 16)
    assert (T.n_chunks, T.chunk_rows, T.n_pad, T.capacity, T.nnz, T.shape) \
        == (J.n_chunks, J.chunk_rows, J.n_pad, J.capacity, J.nnz, J.shape)
    assert T.dtype == torch.float64 and T.rows.dtype == torch.int32
    assert T.buffer.shape == (17, 40)
    np.testing.assert_allclose(float(T.sq_norm), float(J.sq_norm),
                               rtol=1e-14)
    np.testing.assert_array_equal(
        _np(tchunked.valid_rows(T, torch.float64)),
        np.asarray(jchunked.valid_rows(J, jnp.float64)))
    assert [T.chunk_valid(c) for c in range(T.n_chunks)] == [16, 16, 16, 13]


@pytest.mark.parametrize("R", [8, 16, 61, 64])
def test_densify_chunk_matches_reference(rng, R):
    """Every chunk's dense form is the reference's (its padding lands on
    (0, 0) by a scatter-add, the port's on the sink row)."""
    A = _sparse(rng)
    J, T = _pair(A, R)
    for c in range(T.n_chunks):
        want = jchunked._densify_chunk(J, J.data[c], J.cols[c], J.rows[c])
        np.testing.assert_array_equal(_np(tchunked.densify_chunk(T, c)),
                                      np.asarray(want))


def test_bf16_layout_and_sq_norm_of_unrounded_values(rng):
    A = _sparse(rng)
    J = jchunked.chunked_from_scipy(A, jnp.bfloat16, chunk_rows=16)
    T = tchunked.chunked_from_scipy(A, torch.bfloat16, chunk_rows=16,
                                    device="cpu")
    assert T.sq_norm.dtype == torch.float32 and T.data.dtype == torch.bfloat16
    assert float(T.sq_norm) == float(J.sq_norm)
    dense = sum(_np(tchunked.densify_chunk(T, c)).sum()
                for c in range(T.n_chunks))
    assert dense == float(np.asarray(J.data, np.float64).sum())


def test_duplicate_coo_entries_summed():
    A = sp.coo_matrix((np.array([1.0, 2.0, 3.0]), (np.array([0, 0, 5]),
                                                   np.array([1, 1, 2]))),
                      shape=(20, 4))
    T = tchunked.chunked_from_scipy(A, torch.float64, chunk_rows=8,
                                    device="cpu")
    assert T.nnz == 2
    np.testing.assert_array_equal(_np(tchunked.densify_chunk(T, 0)),
                                  A.toarray()[:8])


@pytest.mark.parametrize("n,m,item", [
    (10_000, 1000, 4), (10_000, 50_000_000, 4), (30000, 11314, 2),
    (804414, 47236, 2), (47236, 804414, 2), (5, 3, 8)])
def test_pick_chunk_rows_is_the_reference_rule(n, m, item):
    assert tchunked.DEFAULT_BUFFER_BYTES == jchunked.DEFAULT_BUFFER_BYTES
    assert tchunked.pick_chunk_rows(n, m, item) \
        == jchunked.pick_chunk_rows(n, m, tchunked.DEFAULT_BUFFER_BYTES, item)
    # the 20NG surrogate and the RCV1 shape's doc x term orientation
    assert tchunked.pick_chunk_rows(30000, 11314, 2) == 11776
    assert tchunked.pick_chunk_rows(804414, 47236, 2) == 2816


def test_skew_warning_as_reference():
    """One dense row among empty ones pads every chunk to its count."""
    A = sp.lil_matrix((64, 30))
    A[0, :] = 1.0
    A[40, 3] = 1.0
    for build in (lambda: jchunked.chunked_from_scipy(A, jnp.float64,
                                                      chunk_rows=8),
                  lambda: tchunked.chunked_from_scipy(A, torch.float64,
                                                      chunk_rows=8,
                                                      device="cpu")):
        with pytest.warns(UserWarning, match="padding is"):
            build()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tchunked.chunked_from_scipy(sp.eye(64), torch.float64, chunk_rows=8,
                                    device="cpu")


# -- streamed products ------------------------------------------------------

@pytest.mark.parametrize("R", [8, 16, 64])
def test_chunked_spmm_and_transpose_match_reference(rng, R):
    A = _sparse(rng)
    J, T = _pair(A, R)
    B, M = rng.rand(40, 5), rng.rand(61, 5)
    np.testing.assert_allclose(
        _np(tchunked.chunked_spmm(T, _t(B))),
        np.asarray(jchunked.chunked_spmm(J, jnp.asarray(B))), rtol=1e-12)
    np.testing.assert_allclose(
        _np(tchunked.chunked_spmm_t(T, _t(M))),
        np.asarray(jchunked.chunked_spmm_t(J, jnp.asarray(M))), rtol=1e-12)
    np.testing.assert_allclose(
        float(tchunked.chunked_inner(T, _t(M), _t(B))),
        float(jchunked.chunked_inner(J, jnp.asarray(M), jnp.asarray(B))),
        rtol=1e-12)


def test_chunked_masked_norms_match_reference(rng):
    A = _sparse(rng)
    J, T = _pair(A, 16)
    cm = (rng.rand(40) < 0.5).astype(float)
    rm = (rng.rand(61) < 0.5).astype(float)
    np.testing.assert_allclose(
        _np(tchunked.chunked_masked_row_sq(T, _t(cm))),
        np.asarray(jchunked.chunked_masked_row_sq(J, jnp.asarray(cm))),
        rtol=1e-12)
    np.testing.assert_allclose(
        _np(tchunked.chunked_masked_col_sq(T, _t(rm))),
        np.asarray(jchunked.chunked_masked_col_sq(J, jnp.asarray(rm))),
        rtol=1e-12)


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("l1,eps", [(0.01, 1e-10), (0.0, 0.0)])
def test_chunked_mu_u_pass_matches_reference(rng, use_pallas, l1, eps):
    """l1 = ε = 0: a padding row's ratio is 0/0; both give exact zeros."""
    A = _sparse(rng)
    J, T = _pair(A, 16)
    U, V = np.abs(rng.randn(61, 5)), np.abs(rng.randn(40, 5))
    VtV = V.T @ V
    want = jchunked.chunked_mu_u_pass(J, jnp.asarray(U), jnp.asarray(V),
                                      jnp.asarray(VtV), l1, 0.02, eps)
    got = tchunked.chunked_mu_u_pass(T, _t(U), _t(V), _t(VtV), l1, 0.02,
                                     eps, use_pallas)
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-12)


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("non_negative", [True, False])
def test_chunked_newton_linear_u_pass_matches_reference(rng, use_pallas,
                                                        non_negative):
    A = _sparse(rng)
    J, T = _pair(A, 16)
    U, V = rng.randn(61, 5), rng.randn(40, 5)
    BtB = V.T @ V
    Hinv = np.linalg.inv(BtB + 0.3 * np.eye(5))
    row_sq = np.asarray(A.multiply(A).sum(axis=1)).ravel()
    want = jchunked.chunked_newton_linear_u_pass(
        J, jnp.asarray(U), jnp.asarray(V), jnp.asarray(BtB),
        jnp.asarray(Hinv), jnp.asarray(row_sq), 0.01, 0.1, trials=8,
        non_negative=non_negative)
    got = tchunked.chunked_newton_linear_u_pass(
        T, _t(U), _t(V), _t(BtB), _t(Hinv), _t(row_sq), 0.01, 0.1, trials=8,
        non_negative=non_negative, use_pallas=use_pallas)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-9,
                                   atol=1e-12)


def test_fused_newton_u_pass_keeps_a_padding_row_zero(rng):
    """K2's contract on a chunk's tail: a zero row of data, U and norm
    takes a zero step (g = 0), so the padding adds nothing to numV and
    gramU; no mask is needed (the plain version, which the CPU runs)."""
    from pycmf_tpu_torch.ops.kernels import newton_fused

    X = _t(rng.rand(6, 9))
    X[4:] = 0.0
    U = _t(rng.randn(6, 3))
    U[4:] = 0.0
    V = _t(rng.randn(9, 3))
    BtB = V.T @ V
    Hinv = torch.linalg.inv(BtB + 0.2 * torch.eye(3, dtype=torch.float64))
    rs = (X * X).sum(dim=1)
    unew, numv, gramu = newton_fused.fused_newton_linear_u_pass(
        X, U, V, BtB, Hinv, rs, 0.05, 0.1, trials=8, non_negative=False)
    assert not unew[4:].any()
    want = newton_fused.fused_newton_linear_u_pass(
        X[:4], U[:4], V, BtB, Hinv, rs[:4], 0.05, 0.1, trials=8,
        non_negative=False)
    torch.testing.assert_close(unew[:4], want[0], rtol=1e-14, atol=0)
    torch.testing.assert_close(numv, want[1], rtol=1e-14, atol=1e-15)
    torch.testing.assert_close(gramu, want[2], rtol=1e-14, atol=1e-15)


# -- streamed sigmoid Newton ------------------------------------------------

def _sig_case(rng):
    A = _sparse(rng, binary=True)
    J, T = _pair(A, 16)
    M, B = 0.5 * rng.randn(61, 4), 0.5 * rng.randn(40, 4)
    return A, J, T, M, B


@pytest.mark.parametrize("form", ["gauss", "full"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("use_pallas", [True, False])
def test_chunked_sigmoid_row_update_matches_reference(rng, form, masked,
                                                      use_pallas):
    """use_pallas on, the Gauss-Newton form and no mask: each chunk through
    the port's fused sigmoid update (its plain versions on the CPU); else
    the plain chunk body; the reference's plain body either way."""
    A, J, T, M, B = _sig_case(rng)
    mask = (rng.rand(40) < 0.5).astype(float) if masked else None
    jh = jcommon.make_hyper(0.05, 0.3, dtype=jnp.float64)
    th = tcommon.make_hyper(0.05, 0.3, dtype=torch.float64)
    want = jnc.chunked_sigmoid_row_update(
        J, jnp.asarray(M), jnp.asarray(B), jh, trials=8, non_negative=False,
        hessian_form=form, use_pallas=False,
        col_mask=None if mask is None else jnp.asarray(mask))
    got = tnc.chunked_sigmoid_row_update(
        T, _t(M), _t(B), th, trials=8, non_negative=False, hessian_form=form,
        use_pallas=use_pallas, col_mask=None if mask is None else _t(mask))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-9,
                               atol=1e-12)


@pytest.mark.parametrize("form", ["gauss", "full"])
@pytest.mark.parametrize("masked", [False, True])
def test_chunked_sigmoid_rowwise_terms_and_phi_match_reference(rng, form,
                                                               masked):
    A, J, T, M, B = _sig_case(rng)
    mask = (rng.rand(40) < 0.5).astype(float) if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else _t(mask)
    want = jnc.chunked_sigmoid_rowwise_terms(J, jnp.asarray(M),
                                             jnp.asarray(B), form, mask=jm)
    got = tnc.chunked_sigmoid_rowwise_terms(T, _t(M), _t(B), form, tm)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-12,
                                   atol=1e-14)
    cands = np.stack([M, 0.5 * M, M + 0.1])
    jctx = jnc.ChunkedSigRowCtx(J, jnp.asarray(B), jm, False)
    want = np.stack([np.asarray(jnc.chunked_sigmoid_rowwise_phi(
        jctx, jnp.asarray(c))) for c in cands])
    got = tnc.chunked_sigmoid_rowwise_phi(
        tnc.ChunkedSigRowCtx(T, _t(B), tm), _t(cands))
    np.testing.assert_allclose(_np(got), want, rtol=1e-12)


@pytest.mark.parametrize("form", ["gauss", "full"])
@pytest.mark.parametrize("masked", [False, True])
def test_chunked_sigmoid_colwise_terms_and_phi_match_reference(rng, form,
                                                               masked):
    """V's X term on a chunked X (Xᵀ ≈ σ(V Uᵀ)): padding rows masked out
    of G, H and φ; the mask is an (n,) draw on X's rows."""
    A, J, T, U, _ = _sig_case(rng)
    V = 0.5 * rng.randn(40, 4)
    mask = (rng.rand(61) < 0.5).astype(float) if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else _t(mask)
    want = jnc.chunked_sigmoid_colwise_terms(J, jnp.asarray(V),
                                             jnp.asarray(U), form,
                                             col_mask=jm)
    got = tnc.chunked_sigmoid_colwise_terms(T, _t(V), _t(U), form, tm)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-12,
                                   atol=1e-14)
    cands = np.stack([V, 0.5 * V, V - 0.2])
    jctx = jnc.ChunkedTSigCtx(J, jnp.asarray(U), False, jm)
    want = np.stack([np.asarray(jnc.chunked_sigmoid_colwise_phi(
        jctx, jnp.asarray(c))) for c in cands])
    got = tnc.chunked_sigmoid_colwise_phi(tnc.ChunkedTSigCtx(T, _t(U), tm),
                                          _t(cands))
    np.testing.assert_allclose(_np(got), want, rtol=1e-12)


@pytest.mark.parametrize("link", ["linear", "sigmoid"])
def test_chunked_reconstruction_terms_match_reference(rng, link):
    A, J, T, M, B = _sig_case(rng)
    want = jlosses.reconstruction_term(J, jnp.asarray(M), jnp.asarray(B),
                                       link)
    got = tlosses.reconstruction_term(T, _t(M), _t(B), link)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-12)


# -- fits through the estimator --------------------------------------------

_FITS = {
    "mu": (dict(solver="mu"), False),
    "newton_linear": (dict(solver="newton"), False),
    "newton_sigmoid_y": (dict(solver="newton", y_link="sigmoid"), False),
    "sigmoid_x_gauss": (dict(solver="newton", x_link="sigmoid",
                             U_non_negative=False, V_non_negative=False),
                        True),
    "sigmoid_x_full": (dict(solver="newton", x_link="sigmoid",
                            hessian_form="full", U_non_negative=False,
                            V_non_negative=False), True),
    "sigmoid_x_and_y": (dict(solver="newton", x_link="sigmoid",
                             y_link="sigmoid", U_non_negative=False,
                             V_non_negative=False, Z_non_negative=False),
                        True),
}


def _fit_data(rng, name, n=61, m=40, r=7):
    kw, binary = _FITS[name]
    X, Y = make_problem(rng, n=n, m=m, r=r, sparse=True,
                        binary_y=kw.get("y_link") == "sigmoid")
    if binary:
        X = sp.csr_matrix((X > 0).astype(float))
    if kw.get("y_link") == "sigmoid":
        Y = sp.csr_matrix(Y)  # a sigmoid Y rides the chunked carrier
    return X, Y, kw


def _params(kw, **extra):
    return dict(dict(n_components=3, sparse_mode="chunked", random_state=3,
                     max_iter=10, eval_every=3, tol=1e-9, dtype="float64",
                     alpha=0.05, l1_ratio=0.3), **dict(kw, **extra))


@pytest.mark.parametrize("name", sorted(_FITS))
@pytest.mark.parametrize("use_pallas", [True, False])
def test_chunked_fit_matches_reference_f64(rng, chunk16, name, use_pallas):
    """The full form runs 3 iterations: its indefinite solves amplify the
    summation-order noise between the two packages (the reference's own
    chunked-vs-dense test runs it 2)."""
    X, Y, kw = _fit_data(rng, name)
    extra = dict(max_iter=3, eval_every=1) if "full" in name else {}
    j = JCMF(use_pallas=False, **_params(kw, **extra)).fit(X, Y)
    t = CMF(use_pallas=use_pallas, device="cpu", **_params(kw, **extra))
    t.fit(X, Y)
    assert t.n_iter_ == j.n_iter_ and t.loss_iters_ == j.loss_iters_
    np.testing.assert_allclose(t.loss_history_, j.loss_history_, rtol=1e-9)
    for f in ("U_", "V_", "Z_"):
        np.testing.assert_allclose(getattr(t, f), getattr(j, f), rtol=1e-7,
                                   atol=1e-10)


@pytest.mark.parametrize("name", ["newton_linear", "sigmoid_x_gauss",
                                  "newton_sigmoid_y"])
def test_sampled_chunked_fit_matches_reference_f64(rng, chunk16, name):
    """sg_sample_ratio=0.4 on the chunked layout: each term's draw as a
    mask (a sigmoid X's U update takes its U term's draw), both packages
    drawing their own columns under random_state=5."""
    X, Y, kw = _fit_data(rng, name)
    params = _params(kw, sg_sample_ratio=0.4, random_state=5)
    j = JCMF(use_pallas=False, **params).fit(X, Y)
    t = CMF(device="cpu", **params).fit(X, Y)
    assert t.n_iter_ == j.n_iter_ and t.loss_iters_ == j.loss_iters_
    np.testing.assert_allclose(t.loss_history_, j.loss_history_, rtol=1e-9)
    for f in ("U_", "V_", "Z_"):
        np.testing.assert_allclose(getattr(t, f), getattr(j, f), rtol=1e-9,
                                   atol=1e-12)


@pytest.mark.parametrize("name", ["mu", "sigmoid_x_gauss", "newton_linear"])
def test_chunked_transform_matches_reference(rng, chunk16, name):
    X, Y, kw = _fit_data(rng, name)
    j = JCMF(use_pallas=False, **_params(kw)).fit(X, Y)
    t = CMF(device="cpu", **_params(kw)).fit(X, Y)
    Xn = X[:23]
    np.testing.assert_allclose(t.transform(Xn), j.transform(Xn), rtol=1e-7,
                               atol=1e-10)


@pytest.mark.parametrize("name", sorted(_FITS))
def test_chunked_device_loop_stand_in_equals_host_loop(rng, chunk16, name):
    X, Y, kw = _fit_data(rng, name)
    params = _params(kw, tol=0.0, device="cpu")
    h = CMF(loop="host", **params).fit(X, Y)
    d = CMF(loop="device", **params).fit(X, Y)
    assert h.loss_history_ == d.loss_history_ and h.n_iter_ == d.n_iter_
    for f in ("U_", "V_", "Z_"):
        assert np.array_equal(getattr(h, f), getattr(d, f))


def test_sampled_chunked_device_loop_stand_in_equals_host_loop(rng, chunk16):
    X, Y, kw = _fit_data(rng, "sigmoid_x_gauss")
    params = _params(kw, tol=0.0, device="cpu", sg_sample_ratio=0.4)
    h = CMF(loop="host", **params).fit(X, Y)
    d = CMF(loop="device", **params).fit(X, Y)
    assert h.loss_history_ == d.loss_history_
    assert np.array_equal(h.U_, d.U_) and np.array_equal(h.V_, d.V_)


@pytest.mark.parametrize("name", ["mu", "newton_linear"])
def test_chunked_fit_launches_fused_passes_per_chunk(rng, chunk16, name,
                                                     monkeypatch):
    """Under use_pallas the chunked U leg calls the fused U pass once per
    chunk (the CPU takes its plain version: counted by a spy), with the
    chunk's true rows as n_valid on MU."""
    from pycmf_tpu_torch.ops.kernels import mu_fused, newton_fused

    X, Y, kw = _fit_data(rng, name)
    seen = []
    for mod, fn in ((mu_fused, "fused_mu_u_pass"),
                    (newton_fused, "fused_newton_linear_u_pass")):
        real = getattr(mod, fn)

        def spy(*a, _real=real, _fn=fn, **k):
            seen.append((_fn, a[0].shape[0], k.get("n_valid")))
            return _real(*a, **k)
        monkeypatch.setattr(mod, fn, spy)
    t = CMF(device="cpu", **_params(kw, max_iter=2, eval_every=1, tol=0.0))
    t.fit(X, Y)
    want = ("fused_mu_u_pass" if name == "mu"
            else "fused_newton_linear_u_pass")
    assert [s[0] for s in seen] == [want] * 8  # 4 chunks, 2 iterations
    assert all(s[1] == 16 for s in seen)
    if name == "mu":
        assert [s[2] for s in seen[:4]] == [16, 16, 16, 13]


# -- the estimator's rules --------------------------------------------------

def test_auto_streams_sigmoid_past_threshold_keeps_linear_csr(rng,
                                                              monkeypatch):
    """'auto' past the densify threshold: a sigmoid-linked sparse X under
    Newton is streamed (it has no other path), a linear-linked one stays
    CSR (the reference streams it too: ROADMAP A7). The threshold is cut
    to 64 bytes for the test."""
    from pycmf_tpu_torch.models import cmf as tcmf
    from pycmf_tpu_torch.ops.sparse import is_sparse

    X = _sparse(rng, binary=True)
    real, seen = tcmf.as_coupled, []

    def ingest(A, dtype, device, **kw):
        out = real(A, dtype, device, densify_threshold=64, **kw)
        seen.append(out.A)
        return out
    monkeypatch.setattr(tcmf, "as_coupled", ingest)
    base = dict(n_components=2, max_iter=2, device="cpu", random_state=0,
                dtype="float64")
    CMF(solver="newton", x_link="sigmoid", U_non_negative=False,
        V_non_negative=False, **base).fit(X)
    assert tchunked.is_chunked(seen[-1])
    CMF(solver="newton", **base).fit(X)
    assert is_sparse(seen[-1])
    CMF(solver="mu", **base).fit(X)
    assert is_sparse(seen[-1])
    m = CMF(solver="newton", x_link="sigmoid", **base)
    assert m._matrix_sparse_mode(X, "sigmoid") == "auto"
    assert m.set_params(sparse_mode="csr")._matrix_sparse_mode(
        X, "linear") == "csr"


def test_sigmoid_y_past_threshold_streams_linear_y_does_not(rng):
    X, Y, _ = _fit_data(rng, "newton_sigmoid_y")
    m = CMF(n_components=2, solver="newton", y_link="sigmoid", device="cpu",
            sparse_mode="chunked")
    assert m._matrix_sparse_mode(Y, "sigmoid", is_x=False) == "chunked"
    assert m._matrix_sparse_mode(Y, "linear", is_x=False) == "auto"
    assert m._matrix_sparse_mode(X, "linear") == "chunked"


def test_fp8_with_chunked_raises_naming_a9(rng):
    """fp8 storage (ROADMAP A9, ported) is dense only: the chunked layout
    raises the reference's ValueErrors, from the estimator, from
    as_coupled and from the layout's own builder."""
    from pycmf_tpu_torch.ops.chunked import chunked_from_scipy

    X = _sparse(rng)
    with pytest.raises(ValueError, match="dense device storage"):
        CMF(n_components=2, device="cpu", data_dtype="fp8",
            sparse_mode="chunked").fit(X)
    with pytest.raises(ValueError, match="dense device form"):
        as_coupled(X, torch.float8_e4m3fn, "cpu", sparse_mode="chunked")
    with pytest.raises(ValueError, match="dense device form"):
        chunked_from_scipy(X, torch.float8_e4m3fn)


def test_as_coupled_chunked_norms_match_reference(rng):
    A = _sparse(rng)
    from pycmf_tpu.utils.validation import as_coupled as j_as_coupled

    jc = j_as_coupled(A, jnp.float64, sparse_mode="chunked")
    tc = as_coupled(A, torch.float64, "cpu", sparse_mode="chunked")
    assert tchunked.is_chunked(tc.A)
    for f in ("row_sq", "row_sq_t", "a_sq"):
        np.testing.assert_allclose(_np(getattr(tc, f)),
                                   np.asarray(getattr(jc, f)), rtol=1e-14)


# -- K5's block and LU routes -----------------------------------------------

def _spd(rng, p, k):
    A = rng.randn(p, k, k)
    return np.einsum("pij,pkj->pik", A, A) / k + 0.5 * np.eye(k), \
        rng.randn(p, k)


def _indefinite(rng, p, k):
    """Symmetric systems Q diag(λ) Qᵀ whose eigenvalues λ have flipped
    signs at random, |λ| in [1, 3]: indefinite and well conditioned."""
    Q = np.linalg.qr(rng.randn(p, k, k))[0]
    lam = (1.0 + 2.0 * rng.rand(p, k)) * np.where(rng.rand(p, k) < 0.5,
                                                   -1.0, 1.0)
    lam[:, 0] = -np.abs(lam[:, 0])
    return np.einsum("pij,pj,pkj->pik", Q, lam, Q), rng.randn(p, k)


@pytest.mark.parametrize("k", [65, 100])
def test_batched_spd_solve_ref_large_k_matches_reference(rng, k):
    """k > 64, the card's block route: the plain version (Cholesky)
    against the reference (jnp.linalg.solve above 32), f64 rtol 1e-9."""
    H, G = _spd(rng, 5, k)
    Hs = _spd(rng, 1, k)[0][0]
    want = j_solve(jnp.asarray(H + Hs), jnp.asarray(G))
    got = batched_solve.batched_spd_solve(_t(H), _t(G), _t(Hs))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-9,
                               atol=1e-12)


@pytest.mark.parametrize("k", [3, 20, 40, 100])
def test_batched_lu_solve_ref_indefinite_matches_reference(rng, k):
    """The full form's systems may be indefinite: LU as the reference's
    jnp.linalg.solve (its _solve_direction with spd=False), f64 rtol
    1e-9; the plain Cholesky would give NaN on them."""
    H, G = _indefinite(rng, 6, k)
    Hs = 0.2 * np.eye(k)
    assert (np.linalg.eigvalsh(H + Hs).min(axis=1) < 0).any()
    want = jnewton._solve_direction(jnp.asarray(Hs), jnp.asarray(H),
                                    jnp.asarray(G), True, spd=False)
    got = batched_solve.batched_lu_solve(_t(H), _t(G), _t(Hs))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-9,
                               atol=1e-12)
    assert torch.equal(got, batched_solve.batched_lu_solve_ref(
        _t(H) + _t(Hs), _t(G)))
    got = tnewton._solve_direction(_t(Hs), _t(H), _t(G), True, spd=False)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-9,
                               atol=1e-12)


def test_batched_lu_solve_singular_row_nan_others_exact(rng):
    H, G = _spd(rng, 4, 5)
    H[1] = 0.0
    got = _np(batched_solve.batched_lu_solve(_t(H), _t(G)))
    assert not np.isfinite(got[1]).all()
    want = np.linalg.solve(H[[0, 2, 3]], G[[0, 2, 3]][..., None])[..., 0]
    np.testing.assert_allclose(got[[0, 2, 3]], want, rtol=1e-12)


@pytest.fixture
def fake_solve_lib(monkeypatch):
    """The batched solve's card routes on CPU tensors: a fake library whose
    entries record their symbol and arguments, with an H100's opt-in
    shared memory per CTA (227 KB) and 132 SMs."""
    import types

    calls = []

    def entry(name):
        return lambda *a: calls.append((name, a)) or 0

    monkeypatch.setattr(_build, "load", lambda name: types.SimpleNamespace(
        pycmf_batched_spd_solve=entry("spd"),
        pycmf_batched_wide_solve=entry("spd"),
        pycmf_batched_block_solve=entry("block"),
        pycmf_block_solve_optin=lambda dev: 232448,
        pycmf_error_string=lambda rc: b"fake"))
    monkeypatch.setattr(_build, "_functions", {})
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda dev: 0xBEEF, raising=False)
    monkeypatch.setattr(batched_solve, "on_card", lambda *t: True)
    monkeypatch.setattr(batched_solve, "_sm_count", lambda dev: 132)
    batched_solve.block_max_k.cache_clear()
    batched_solve.smem_optin.cache_clear()
    yield calls
    batched_solve.block_max_k.cache_clear()
    batched_solve.smem_optin.cache_clear()


@pytest.mark.parametrize("k", [20, 40, 65, 100, 239, 240])
@pytest.mark.parametrize("form", ["gauss", "full"])
@pytest.mark.parametrize("use_pallas", [True, False])
def test_solve_direction_route_by_k_form_and_use_pallas(fake_solve_lib, k,
                                                        form, use_pallas):
    """Under use_pallas every per-row system launches K5: the Gauss-Newton
    form its narrow (k <= 32), wide (<= 64) or block route, the full form
    its LU route (lu = 1), with the launch plan's threads, shared bytes
    and scratch (LU at k = 239 and 240 in global scratch
    slots; every SPD system here in one CTA's shared memory). use_pallas
    off launches nothing (the plain path's torch.linalg.solve_ex)."""
    p = 3
    H = torch.eye(k, dtype=torch.float32).expand(p, k, k).contiguous()
    G, Hs = torch.rand(p, k), torch.eye(k)
    policy.reset_launch_counts()
    out = tnewton._solve_direction(Hs, H, G, use_pallas,
                                   spd=form == "gauss")
    counts = {n: c for n, c in policy.launch_counts().items() if c}
    if not use_pallas:
        assert fake_solve_lib == [] and counts == {}
        torch.testing.assert_close(out, G / 2)
        return
    assert len(fake_solve_lib) == 1
    name, args = fake_solve_lib[0]
    if form == "full":
        want = "batched_lu_solve"
    else:
        want = ("batched_spd_solve" if k <= 32 else "batched_spd_solve_wide"
                if k <= 64 else "batched_spd_solve_block")
    assert counts == {want: 1}
    assert name == ("spd" if want in ("batched_spd_solve",
                                      "batched_spd_solve_wide") else "block")
    if name == "block":
        # (H, Hs, G, p, k, lu, out, scratch, slots, threads, smem, device,
        # stream)
        plan = batched_solve.solve_plan(p, k, form == "full", 232448, 132)
        assert args[4] == k and args[5] == int(form == "full")
        assert (args[7] is None) == (form == "gauss" or k <= 220)
        assert (args[7] is None) == (plan.slots == 0)
        assert args[8:11] == (plan.slots, plan.threads, plan.smem)


@pytest.mark.parametrize("kw,k", [
    (dict(y_link="sigmoid"), 100), (dict(x_link="sigmoid"), 100),
    (dict(y_link="sigmoid", hessian_form="full"), 100),
    (dict(x_link="sigmoid", hessian_form="full", use_pallas=False), 20)])
def test_captures_on_card_large_k_and_full_form(kw, k):
    want = kw.get("use_pallas", True)
    cfg = tcommon.SolverConfig(**dict(dict(use_pallas=True), **kw))
    assert tnewton.captures_on_card(cfg) is want
