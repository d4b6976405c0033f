"""The port's public surface against the reference's, on the CPU.

- the exports of ``ops``, ``solvers`` and the ``pycmf`` alias;
- ``csr_from_dense`` and ``CsrMatrix.astype`` (fields bit for bit, the
  reference's sq_norm dtypes), and the card as the CSR constructors'
  default device;
- ``ops.spmm`` and ``reconstruction_rmse`` (dense, CSR, chunked and
  BlockEll A; float64 at rtol 1e-9, bf16-stored data with float32
  factors at 1e-5);
- the precision control: names, ``matmul``/``gram`` at each setting
  against the reference's (float64, rtol 1e-12), whole fits under
  'default' equal to fits under 'highest', TF32 and bf16 rounding;
- the estimator's sklearn mixin surface: ``set_output``, metadata
  routing, the changed-only repr and the HTML hooks.
"""
import importlib
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sp
import sklearn
import torch

import pycmf
import pycmf_torch
import pycmf_tpu_torch
from pycmf_tpu import CMF as JCMF
from pycmf_tpu import ops as jops
from pycmf_tpu import solvers as jsolvers
from pycmf_tpu.ops import chunked as jchunked
from pycmf_tpu.ops import losses as jlosses
from pycmf_tpu.ops import sparse as jsparse
from pycmf_tpu.ops.pallas import bell as jbell
from pycmf_tpu_torch import CMF
from pycmf_tpu_torch import ops as tops
from pycmf_tpu_torch import solvers as tsolvers
from pycmf_tpu_torch.ops import chunked as tchunked
from pycmf_tpu_torch.ops import losses as tlosses
from pycmf_tpu_torch.ops import sparse as tsparse
from pycmf_tpu_torch.ops.kernels import bell as tbell
from pycmf_tpu_torch.ops.kernels import spmm as tspmm
from pycmf_tpu_torch.utils.datasets import block_sparse_matrix
from tests.conftest import make_problem

ROOT = Path(__file__).resolve().parents[1]
# the modules: each ops package's ``matmul`` is the function
jmatmul = importlib.import_module("pycmf_tpu.ops.matmul")
tmatmul = importlib.import_module("pycmf_tpu_torch.ops.matmul")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float64).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float64))


def _scattered(rng, p=60, q=40, density=0.15):
    return sp.random(p, q, density=density, format="csr", random_state=rng,
                     data_rvs=lambda n: rng.rand(n) + 0.5)


@pytest.fixture
def precision():
    """Both packages' default precision, put back to 'highest' after."""
    yield
    jmatmul.set_default_precision("highest")
    tmatmul.set_default_precision("highest")


# -- exports -----------------------------------------------------------------

@pytest.mark.parametrize("ref, port", [(jops, tops), (jsolvers, tsolvers),
                                       (pycmf, pycmf_torch)],
                         ids=["ops", "solvers", "pycmf"])
def test_exports_match_the_reference(ref, port):
    assert port.__all__ == ref.__all__
    for name in ref.__all__:
        assert hasattr(port, name), name


def test_exports_are_the_ports_objects():
    from pycmf_tpu_torch.solvers import common, mu, newton
    from pycmf_tpu_torch.utils import analysis

    assert pycmf_torch.CMF is pycmf_tpu_torch.CMF
    assert pycmf_torch.CsrMatrix is tsparse.CsrMatrix
    assert pycmf_torch.analysis is analysis
    assert pycmf_torch.top_component_samples is analysis.top_component_samples
    assert pycmf_torch.__version__ == pycmf.__version__
    assert (tsolvers.Coupled, tsolvers.Hyper, tsolvers.SolverConfig,
            tsolvers.make_hyper) == (common.Coupled, common.Hyper,
                                     common.SolverConfig, common.make_hyper)
    assert (tsolvers.make_mu_step, tsolvers.run_mu) == (mu.make_mu_step,
                                                         mu.run_mu)
    assert (tsolvers.make_newton_step, tsolvers.run_newton) == (
        newton.make_newton_step, newton.run_newton)
    assert tops.matmul is tmatmul.matmul and tops.gram is tmatmul.gram
    assert tops.csr_from_scipy is tsparse.csr_from_scipy


# -- csr_from_dense, astype, the default device ------------------------------

_PAIRS = {"float64": (jnp.float64, torch.float64),
          "float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "float16": (jnp.float16, torch.float16)}


def _assert_same_csr(J, T, jdt, tdt):
    assert T.shape == J.shape and T.dtype == tdt
    assert T.sq_norm.dtype == {jnp.dtype(jnp.float32): torch.float32,
                               jnp.dtype(jnp.float64): torch.float64,
                               jnp.dtype(jnp.float16): torch.float16,
                               jnp.dtype(jnp.bfloat16): torch.bfloat16}[
        jnp.dtype(J.sq_norm.dtype)]
    for f in ("data", "indices", "indptr", "row_ids", "sq_norm"):
        np.testing.assert_array_equal(_np(getattr(T, f)),
                                      _np(getattr(J, f)), err_msg=f)


@pytest.mark.parametrize("dtype", sorted(_PAIRS))
def test_csr_from_dense_and_astype_match_reference(rng, dtype):
    """csr_from_dense's fields bit for bit, and astype from float64 to
    ``dtype`` (sq_norm cast: float32 below 4 bytes, unlike csr_from_scipy's
    bf16-only rule, which leaves float16's at float16)."""
    jdt, tdt = _PAIRS[dtype]
    Ad = _scattered(rng).toarray()
    _assert_same_csr(jsparse.csr_from_dense(Ad, dtype=jdt),
                     tops.csr_from_dense(Ad, tdt, device="cpu"), jdt, tdt)
    J = jsparse.csr_from_dense(Ad, dtype=jnp.float64).astype(jdt)
    T = tops.csr_from_dense(Ad, torch.float64, device="cpu").astype(tdt)
    _assert_same_csr(J, T, jdt, tdt)
    assert T.sq_norm.dtype == (torch.float32 if tdt.itemsize < 4 else tdt)


@pytest.mark.parametrize("build", ["csr_from_scipy", "csr_from_dense",
                                   "csr_transpose_host"])
def test_csr_constructors_default_to_the_card(rng, monkeypatch, build):
    """Without a card the default device raises, naming device='cpu'."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    A = _scattered(rng)
    fn = getattr(tsparse, build)
    arg = A.toarray() if build == "csr_from_dense" else A
    with pytest.raises(ValueError, match="device='cpu'"):
        fn(arg)
    out = fn(arg, torch.float32, device="cpu")
    for C in (out if isinstance(out, tuple) else (out,)):
        assert C.device.type == "cpu"


@pytest.mark.parametrize("build", ["chunked_from_scipy", "bell_from_scipy"])
def test_layout_constructors_default_to_the_card(rng, monkeypatch, build):
    """chunked_from_scipy and bell_from_scipy place on the card by default,
    as the reference's land on its default device: without a card the
    default raises, naming device='cpu', and device='cpu' builds the
    reference's layout on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if build == "chunked_from_scipy":
        A = _scattered(rng)
        with pytest.raises(ValueError, match="device='cpu'"):
            tchunked.chunked_from_scipy(A, torch.float64, chunk_rows=16)
        T = tchunked.chunked_from_scipy(A, torch.float64, chunk_rows=16,
                                        device="cpu")
        J = jchunked.chunked_from_scipy(A, jnp.float64, chunk_rows=16)
        assert (T.n_chunks, T.chunk_rows, T.nnz, T.shape) == (
            J.n_chunks, J.chunk_rows, J.nnz, J.shape)
        for c in range(T.n_chunks):
            np.testing.assert_array_equal(
                _np(tchunked.densify_chunk(T, c)),
                np.asarray(jchunked._densify_chunk(J, J.data[c], J.cols[c],
                                                   J.rows[c])))
        tensors = (T.data, T.cols, T.rows, T.sq_norm, T.buffer)
    else:
        A = block_sparse_matrix(96, 64, 0.4, rng)
        with pytest.raises(ValueError, match="device='cpu'"):
            tbell.bell_from_scipy(A, torch.float64)
        T = tbell.bell_from_scipy(A, torch.float64, device="cpu")
        J = jbell.bell_from_scipy(A, jnp.float64)
        for f in ("brows", "bcols", "blocks"):
            np.testing.assert_array_equal(_np(getattr(T, f)),
                                          _np(getattr(J, f)))
        tensors = (T.blocks, T.brows, T.bcols)
    assert all(t.device.type == "cpu" for t in tensors)


# -- ops.spmm and reconstruction_rmse ----------------------------------------

def _spmm_operands(rng, data_dtype=torch.float64, b_dtype=torch.float64):
    A = _scattered(rng)
    B = rng.randn(40, 5)
    jd = {torch.float64: jnp.float64, torch.float32: jnp.float32,
          torch.bfloat16: jnp.bfloat16}
    return (jsparse.csr_from_scipy(A, dtype=jd[data_dtype]),
            jnp.asarray(B, jd[b_dtype]),
            tsparse.csr_from_scipy(A, data_dtype, device="cpu"),
            torch.from_numpy(B).to(b_dtype))


@pytest.mark.parametrize("data_dtype, b_dtype, rtol", [
    (torch.float64, torch.float64, 1e-12),
    (torch.bfloat16, torch.float32, 1e-6),
    (torch.float32, torch.float64, 1e-12)])
def test_ops_spmm_matches_reference(rng, data_dtype, b_dtype, rtol):
    """CPU tensors take the plain gather; the result dtype is the
    promotion of B's and the values' dtypes, as in the reference."""
    JA, JB, TA, TB = _spmm_operands(rng, data_dtype, b_dtype)
    want = jops.spmm(JA, JB)
    got = tops.spmm(TA, TB)
    assert got.dtype == torch.promote_types(data_dtype, b_dtype)
    assert str(want.dtype) == str(got.dtype).removeprefix("torch.")
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=1e-12)
    # the kernel's plain version is the plain gather, not ops.spmm
    np.testing.assert_array_equal(_np(tspmm.csr_spmm_ref(TA, TB)),
                                  _np(tsparse.spmm(TA, TB)))
    np.testing.assert_array_equal(_np(got), _np(tsparse.spmm(TA, TB)))


def _rmse_inputs(rng, layout, link, dtype):
    """(reference A, port A, M, B) for the term A ≈ f(M Bᵀ): data made
    from the seed, stored at ``dtype``; M, B float64 (float32 under bf16
    or fp8 data)."""
    p, q, k = 61, 40, 4
    A = _scattered(rng, p, q, 0.3)
    if link == "sigmoid":
        A.data[:] = 1.0
    fdt = np.float64 if dtype == "float64" else np.float32
    M = (0.4 * rng.randn(p, k)).astype(fdt)
    B = (0.4 * rng.randn(q, k)).astype(fdt)
    if link == "linear":
        M, B = np.abs(M), np.abs(B)
    jdt, tdt = _PAIRS.get(dtype, (jnp.float8_e4m3fn, torch.float8_e4m3fn))
    if layout == "dense":
        JA = jnp.asarray(A.toarray(), jdt)
        TA = torch.from_numpy(A.toarray()).to(tdt)
    elif layout == "csr":
        JA = jsparse.csr_from_scipy(A, dtype=jdt)
        TA = tsparse.csr_from_scipy(A, tdt, device="cpu")
    else:
        JA = jchunked.chunked_from_scipy(A, jdt, chunk_rows=16)
        TA = tchunked.chunked_from_scipy(A, tdt, chunk_rows=16, device="cpu")
    return JA, TA, M, B


@pytest.mark.parametrize("layout, link, dtype", [
    (lay, link, "float64") for lay in ("dense", "csr", "chunked")
    for link in ("linear", "sigmoid")] + [
    ("dense", "linear", "bfloat16"), ("csr", "linear", "bfloat16"),
    ("dense", "sigmoid", "bfloat16"), ("chunked", "linear", "bfloat16"),
    ("dense", "linear", "float8_e4m3fn")])
def test_reconstruction_rmse_matches_reference(rng, layout, link, dtype):
    JA, TA, M, B = _rmse_inputs(rng, layout, link, dtype)
    want = float(jlosses.reconstruction_rmse(JA, jnp.asarray(M),
                                             jnp.asarray(B), link))
    rtol = 1e-9 if dtype == "float64" else 1e-5
    for use_pallas in (None, False, True):
        got = tlosses.reconstruction_rmse(TA, torch.from_numpy(M),
                                          torch.from_numpy(B), link,
                                          use_pallas=use_pallas)
        assert got.dtype == torch.from_numpy(M).dtype
        np.testing.assert_allclose(float(got), want, rtol=rtol)


def test_reconstruction_rmse_of_block_ell(rng):
    """A BlockEll A takes bell_inner (the plain bell_spmm on the CPU) and
    equals the reference's RMSE of the same matrix as CSR."""
    A = block_sparse_matrix(384, 256, 0.4, rng)
    M, B = np.abs(rng.randn(384, 3)), np.abs(rng.randn(256, 3))
    want = float(jlosses.reconstruction_rmse(
        jsparse.csr_from_scipy(A, dtype=jnp.float64), jnp.asarray(M),
        jnp.asarray(B), "linear"))
    L = tbell.bell_from_scipy(A, torch.float64, device="cpu")
    got = tlosses.reconstruction_rmse(L, torch.from_numpy(M),
                                      torch.from_numpy(B), "linear")
    np.testing.assert_allclose(float(got), want, rtol=1e-9)


# -- precision ---------------------------------------------------------------

class _Named:
    """A stand-in of jax.lax.Precision: anything with a ``.name``."""

    def __init__(self, name):
        self.name = name


@pytest.mark.parametrize("given, name", [
    ("default", "default"), ("high", "high"), ("highest", "highest"),
    ("HIGH", "high"), (_Named("DEFAULT"), "default"),
    (jax.lax.Precision.HIGH, "high"), (jax.lax.Precision.HIGHEST, "highest")])
def test_default_precision_round_trips(precision, given, name):
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.get_float32_matmul_precision())
    tops.set_default_precision(given)
    assert tmatmul.get_default_precision() == name
    # no process-wide flag is read or set
    assert (torch.backends.cuda.matmul.allow_tf32,
            torch.get_float32_matmul_precision()) == flags
    assert torch.backends.cuda.matmul.allow_tf32 is False


@pytest.mark.parametrize("bad", ["bogus", 3, None, _Named("FAST")])
def test_unknown_precision_raises(precision, bad):
    """The reference stores any value and fails at its next product; the
    port raises at once."""
    with pytest.raises(ValueError, match="precision"):
        tops.set_default_precision(bad)
    if bad is not None:  # a product's precision=None is the default
        with pytest.raises(ValueError, match="precision"):
            tops.matmul(torch.ones(2, 2), torch.ones(2, 2), precision=bad)
    assert tmatmul.get_default_precision() == "highest"


@pytest.mark.parametrize("name", ["default", "high", "highest"])
def test_matmul_and_gram_match_reference_at_each_setting(rng, precision,
                                                         name):
    """On the CPU every setting is the float64 product, as in JAX."""
    a, b = rng.randn(30, 20), rng.randn(20, 7)
    jops.set_default_precision(name)
    tops.set_default_precision(name)
    for got, want in (
            (tops.matmul(torch.from_numpy(a), torch.from_numpy(b)),
             jops.matmul(jnp.asarray(a), jnp.asarray(b))),
            (tops.gram(torch.from_numpy(a)), jops.gram(jnp.asarray(a))),
            (tops.matmul(torch.from_numpy(a), torch.from_numpy(b),
                         precision=name),
             jops.matmul(jnp.asarray(a), jnp.asarray(b),
                         precision=getattr(jax.lax.Precision,
                                           name.upper())))):
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-12,
                                   atol=1e-13)


@pytest.mark.parametrize("solver", ["mu", "newton"])
def test_fits_under_default_equal_fits_under_highest(rng, precision, solver):
    """A MU fit and a path-A-shaped Newton fit (linear X, sigmoid Y) under
    'default' equal the same fits under 'highest' bit for bit on the CPU,
    and the reference's fit under 'default' at 1e-9."""
    X, Y = make_problem(rng, n=40, m=30, r=6, k=3,
                        binary_y=solver == "newton")
    kw = dict(n_components=3, solver=solver, random_state=0, max_iter=12,
              dtype="float64", tol=0.0)
    if solver == "newton":
        kw["y_link"] = "sigmoid"
    want = CMF(**kw, device="cpu").fit_transform(X, Y)
    tops.set_default_precision("default")
    jops.set_default_precision("default")
    got = CMF(**kw, device="cpu").fit_transform(X, Y)
    ref = JCMF(**kw).fit_transform(X, Y)
    for g, w, r in zip(got, want, ref):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_allclose(g, r, rtol=1e-9, atol=1e-12)


def test_operand_rounding(rng):
    """TF32 rounding keeps 10 mantissa bits, to nearest with ties away from
    zero, and leaves NaN and ±inf; CPU operands are never rounded."""
    x = torch.from_numpy(rng.randn(1000).astype(np.float32) * 1e3)
    x = torch.cat([x, torch.tensor([float("nan"), float("inf"),
                                    -float("inf"), 0.0, -0.0, 1 + 2 ** -11,
                                    -(1 + 2 ** -11), 3.4e38])])
    r = tmatmul._round_tf32(x)
    bits = r[torch.isfinite(r)].view(torch.int32)
    assert int((bits & 0x1FFF).abs().sum()) == 0
    finite = torch.isfinite(x[:-1])
    rel = ((r[:-1] - x[:-1]).abs() / x[:-1].abs().clamp_min(1e-30))[finite]
    assert float(rel.max()) <= 2.0 ** -11
    assert torch.isnan(r[1000]) and r[1001] == float("inf")
    assert r[1002] == -float("inf")
    assert float(r[1005]) == 1 + 2 ** -10 and float(r[1006]) == -(1 + 2 ** -10)
    for name in ("default", "high"):
        a, b = torch.ones(3, 2) / 3, torch.ones(2, 4) / 3
        ra, rb = tmatmul._rounded(a, b, name)
        assert ra is a and rb is b


# -- the estimator's sklearn surface -----------------------------------------

_KW = dict(n_components=3, random_state=0, max_iter=20, dtype="float64")


@pytest.mark.parametrize("indexed", [False, True])
def test_set_output_pandas_matches_reference(rng, indexed):
    X, Y = make_problem(rng, n=30, m=20, r=5, k=3)
    if indexed:
        X = pd.DataFrame(X, index=[f"doc{i}" for i in range(30)])
    ref = JCMF(**_KW).set_output(transform="pandas")
    est = CMF(**_KW, device="cpu").set_output(transform="pandas")
    want, got = ref.fit_transform(X, Y), est.fit_transform(X, Y)
    assert [type(v) for v in got] == [type(v) for v in want] == [
        pd.DataFrame, np.ndarray, np.ndarray]
    pd.testing.assert_frame_equal(got[0], want[0], rtol=1e-9)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w, rtol=1e-9)
    pd.testing.assert_frame_equal(est.transform(X), ref.transform(X),
                                  rtol=1e-9)


def test_set_output_default_and_errors(rng, monkeypatch):
    X, Y = make_problem(rng, n=30, m=20, r=5, k=3)
    est = CMF(**_KW, device="cpu")
    assert est.set_output() is est and est.set_output(
        transform="default") is est
    U, V, Z = est.fit_transform(X, Y)
    assert type(U) is np.ndarray and type(est.transform(X)) is np.ndarray
    for make in (JCMF, lambda **kw: CMF(**kw, device="cpu")):
        with pytest.raises(ValueError, match="output config must be in"):
            make(**_KW).set_output(transform="bogus").fit_transform(X, Y)
    monkeypatch.setitem(sys.modules, "polars", None)
    for make in (JCMF, lambda **kw: CMF(**kw, device="cpu")):
        with pytest.raises(ImportError, match="requires polars"):
            make(**_KW).set_output(transform="polars").fit_transform(X, Y)


def test_global_transform_output_is_honoured(rng):
    """With no setting of its own, transform follows sklearn's global
    ``transform_output`` as the reference does."""
    X, Y = make_problem(rng, n=30, m=20, r=5, k=3)
    est = CMF(**_KW, device="cpu").fit(X, Y)
    ref = JCMF(**_KW).fit(X, Y)
    with sklearn.config_context(transform_output="pandas"):
        pd.testing.assert_frame_equal(est.transform(X), ref.transform(X),
                                      rtol=1e-9)


def test_metadata_routing_matches_reference():
    ref, est = JCMF(n_components=3), CMF(n_components=3, device="cpu")
    assert (est.get_metadata_routing()._serialize()
            == ref.get_metadata_routing()._serialize()
            == {"transform": {"U": None}, "inverse_transform": {"U": None}})
    with pytest.raises(RuntimeError, match="metadata routing is enabled"):
        est.set_transform_request(U=True)
    with sklearn.config_context(enable_metadata_routing=True):
        for m in (ref, est):
            assert m.set_transform_request(U=True) is m
            m.set_inverse_transform_request(U="alias")
        assert (est.get_metadata_routing()._serialize()
                == ref.get_metadata_routing()._serialize())
        with pytest.raises(TypeError, match="Unexpected args"):
            est.set_transform_request(V=True)


@pytest.mark.parametrize("params", [
    dict(n_components=3), dict(),
    dict(solver="newton", n_components=5, alpha=0.1),
    dict(n_components=3, n_shards=(2, 2), shard_layout="grid"),
    dict(tol=1e-6, max_iter=50, random_state=0),
    dict(use_pallas=None, n_shards=None),
    dict(eps=float("nan")),
    dict(alpha=1, l1_ratio=0.5, U_non_negative=False),
    dict(x_link="sigmoid", y_link="sigmoid", solver="newton", n_components=4,
         random_state=0, sg_sample_ratio=0.5, hessian_form="full",
         use_pallas=False, data_dtype="bfloat16", dtype="float64")],
    ids=lambda p: ",".join(sorted(p)) or "none")
def test_repr_matches_reference(params):
    assert repr(CMF(**params)) == repr(JCMF(**params))


def test_repr_names_device_only_when_changed():
    assert repr(CMF(n_components=3)) == "CMF(n_components=3)"
    assert repr(CMF(n_components=3, device="cpu")) == (
        "CMF(device='cpu', n_components=3)")


def test_html_hooks_follow_sklearn():
    est, ref = CMF(n_components=3), JCMF(n_components=3)
    assert hasattr(est, "_repr_html_") and hasattr(est, "_repr_mimebundle_")
    got, want = est._repr_mimebundle_(), ref._repr_mimebundle_()
    assert sorted(got) == sorted(want)
    assert got["text/plain"] == want["text/plain"] == "CMF(n_components=3)"
    assert est._repr_html_().startswith("<style>")
    with sklearn.config_context(display="text"):
        assert not hasattr(est, "_repr_html_")
        assert est._repr_mimebundle_() == ref._repr_mimebundle_()


def test_sklearn_surface_without_sklearn():
    """With sklearn unimportable: set_output works, the HTML hooks are
    absent, and routing raises ImportError."""
    code = (
        "import sys; sys.modules['sklearn'] = None\n"
        "import numpy as np, pycmf_torch\n"
        "m = pycmf_torch.CMF(n_components=2, max_iter=5, random_state=0,"
        " device='cpu', dtype='float64').set_output(transform='pandas')\n"
        "X = np.abs(np.random.RandomState(0).randn(12, 8))\n"
        "U = m.fit_transform(X)[0]\n"
        "print(type(U).__name__, list(U.columns),"
        " hasattr(m, '_repr_html_'), hasattr(m, '_repr_mimebundle_'))\n"
        "try:\n    m.get_metadata_routing()\n"
        "except ImportError:\n    print('ImportError')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split("\n")[:2] == [
        "DataFrame ['cmf0', 'cmf1'] False False", "ImportError"]
