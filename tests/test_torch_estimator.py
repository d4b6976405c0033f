"""The port's estimator (pycmf_tpu_torch.CMF) against the reference's
(pycmf_tpu.CMF) on the CPU, plus the port's package boundary: no JAX at
import, the out-of-slice surface raising NotImplementedError, the CUDA
device refusing to run without a card.

Tolerances: float64 fits agree to rtol 1e-9 on the loss histories (the
reference's own bar for its sharded parity) and 1e-7 on the factors; a
bf16-stored fit (f32 factors) ends within an objective gap of 1e-4.
"""
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from pycmf_tpu import CMF as JCMF
from pycmf_tpu.utils.datasets import synthetic_20ng as j_synth
from pycmf_tpu.utils.init import initialize_factors as j_init
from pycmf_tpu_torch import CMF
from pycmf_tpu_torch.ops.kernels import policy
from pycmf_tpu_torch.utils.convert import (factors_from_numpy,
                                           factors_to_numpy)
from pycmf_tpu_torch.utils.datasets import synthetic_20ng as t_synth
from pycmf_tpu_torch.utils.init import initialize_factors as t_init
from tests.conftest import make_problem


def _pair(**kw):
    return JCMF(**kw), CMF(device="cpu", **kw)


def _assert_same_fit(j, t, rtol_f=1e-7):
    assert j.n_iter_ == t.n_iter_
    assert j.loss_iters_ == t.loss_iters_
    np.testing.assert_allclose(t.loss_history_, j.loss_history_, rtol=1e-9)
    for name in ("U_", "V_", "Z_"):
        a, b = getattr(j, name), getattr(t, name)
        if a is None:
            assert b is None
        else:
            np.testing.assert_allclose(b, a, rtol=rtol_f, atol=1e-12)


@pytest.mark.parametrize("solver", ["mu", "newton"])
@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("sparse", [False, True])
def test_fit_transform_matches_reference_f64(rng, solver, use_pallas,
                                             sparse):
    """Sparse X goes through the densify-on-device ingest in both."""
    X, Y = make_problem(rng, n=61, sparse=sparse)
    kw = dict(n_components=4, solver=solver, random_state=0, max_iter=20,
              eval_every=5, tol=1e-7, dtype="float64", use_pallas=use_pallas)
    if solver == "newton":
        kw.update(alpha=0.1, l1_ratio=0.5, max_iter=10)
    j, t = _pair(**kw)
    out_j = j.fit_transform(X, Y)
    out_t = t.fit_transform(X, Y)
    _assert_same_fit(j, t)
    for a, b in zip(out_j, out_t):
        np.testing.assert_allclose(b, a, rtol=1e-7, atol=1e-12)


@pytest.mark.parametrize("solver", ["mu", "newton"])
def test_transform_matches_reference_f64(rng, solver):
    """Fold-in from the same NumPy draw. Newton runs 3 iterations: a
    linear-link Newton fold-in converges in one step, after which the line
    search compares objectives equal up to rounding, and either package
    may take or refuse a zero-length step."""
    X, Y = make_problem(rng, n=61)
    kw = dict(n_components=4, solver=solver, random_state=3, dtype="float64",
              max_iter=30 if solver == "mu" else 3, eval_every=5, tol=1e-7)
    j, t = _pair(**kw)
    j.fit(X, Y)
    t.fit(X, Y)
    np.testing.assert_allclose(t.transform(X[:9]), j.transform(X[:9]),
                               rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("solver,max_iter", [("mu", 10), ("newton", 1)])
@pytest.mark.parametrize("use_pallas", [True, False])
def test_bf16_data_objective_gap(solver, max_iter, use_pallas):
    """data_dtype='bfloat16' with f32 factors: the objectives agree within
    1e-4 at every eval point. Both packages round X, V and U_new to bf16 at
    the same points and sum in f32 in different orders. The comparison is
    short (10 MU iterations, 1 Newton iteration): an f32 factor that
    differs in its last bit can round to a neighbouring bf16 value, and
    the iterations amplify such flips to ~1e-4 (MU, after 20-50
    iterations) and ~1e-3 (Newton, after 3) objective differences; the
    reference's own fused and unfused Newton branches differ as much. A
    wrong rounding point shows at ~1e-3 in the first iteration."""
    X, Y = make_problem(np.random.RandomState(1), n=61, noise=0.5)
    kw = dict(n_components=4, solver=solver, random_state=0,
              max_iter=max_iter, eval_every=max_iter,
              data_dtype="bfloat16", use_pallas=use_pallas)
    j, t = _pair(**kw)
    j.fit(X, Y)
    t.fit(X, Y)
    assert t.n_iter_ == j.n_iter_
    gap = np.abs(np.subtract(t.loss_history_, j.loss_history_)) \
        / np.asarray(j.loss_history_)
    assert gap.max() < 1e-4


@pytest.mark.parametrize("solver", ["mu", "newton"])
def test_from_reference_continues_identically(rng, solver):
    X, Y = make_problem(rng, n=61)
    # Newton: 3 iterations, for the fold-in (see the transform test above)
    j = JCMF(n_components=4, solver=solver, random_state=0,
             max_iter=8 if solver == "mu" else 3, eval_every=4,
             dtype="float64").fit(X, Y)
    t = CMF.from_reference(j, device="cpu")
    assert t.get_params() == dict(j.get_params(), device="cpu")
    np.testing.assert_array_equal(t.V_, j.V_)
    assert t.loss_history_ == j.loss_history_ and t.n_iter_ == j.n_iter_
    np.testing.assert_allclose(t.transform(X[:5]), j.transform(X[:5]),
                               rtol=1e-9)
    j.fit_transform(X, Y, U=j.U_, V=j.V_, Z=j.Z_)
    t.fit_transform(X, Y, U=t.U_, V=t.V_, Z=t.Z_)
    _assert_same_fit(j, t)


def test_from_reference_needs_a_fitted_estimator():
    with pytest.raises(ValueError, match="not fitted"):
        CMF.from_reference(JCMF(n_components=2), device="cpu")


def test_params_surface_is_the_reference_plus_device():
    ref = JCMF().get_params()
    port = CMF().get_params()
    assert port == dict(ref, device="cuda")
    est = CMF().set_params(alpha=0.5, device="cpu")
    assert est.alpha == 0.5 and est.device == "cpu"
    with pytest.raises(ValueError, match="invalid parameter"):
        est.set_params(alhpa=1.0)


def test_inits_and_surrogate_are_byte_identical():
    """Dense X for the SVD inits: scipy's sparse svds starts ARPACK from a
    random vector, so it differs from call to call in either package."""
    Xj, Yj = j_synth(n_docs=300, n_terms=900, random_state=5)
    Xt, Yt = t_synth(n_docs=300, n_terms=900, random_state=5)
    assert (Xj != Xt).nnz == 0 and np.array_equal(Yj, Yt)
    for x_init in ("random", "svd", "nndsvda", "nndsvdar"):
        a = j_init(Xj.toarray(), Yj, 5, x_init=x_init, y_init=x_init,
                   random_state=2)
        b = t_init(Xt.toarray(), Yt, 5, x_init=x_init, y_init=x_init,
                   random_state=2)
        for u, v in zip(a, b):
            assert np.array_equal(u, v)


def test_factor_conversion_round_trip(rng):
    U, V = rng.randn(5, 3), rng.randn(4, 3)
    tU, tV, tZ = factors_from_numpy(U, V, None, "cpu", torch.float64)
    assert tZ is None and tU.dtype == torch.float64
    back = factors_to_numpy(tU, tV, tZ)
    assert np.array_equal(back[0], U) and np.array_equal(back[1], V)
    assert back[2] is None


def test_cpu_fit_launches_no_kernel(rng):
    X, Y = make_problem(rng)
    policy.reset_launch_counts()
    CMF(n_components=3, max_iter=5, device="cpu").fit(X, Y)
    CMF(n_components=3, solver="newton", max_iter=5, device="cpu").fit(X, Y)
    assert set(policy.launch_counts().values()) == {0}


def test_import_pulls_in_no_jax():
    code = ("import sys\n"
            "import pycmf_tpu_torch, pycmf_tpu_torch.models.cmf\n"
            "import pycmf_tpu_torch.ops.kernels.mu_fused\n"
            "import pycmf_tpu_torch.ops.kernels.newton_fused\n"
            "import pycmf_tpu_torch.ops.kernels._build\n"
            "import pycmf_tpu_torch.utils.datasets\n"
            "import pycmf_tpu_torch.utils.convert\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib', 'pycmf_tpu.')) "
            "or m == 'pycmf_tpu']\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


@pytest.mark.parametrize("kw,match", [
    (dict(solver="newton", y_link="sigmoid"), "ROADMAP A3"),
    (dict(solver="newton", sg_sample_ratio=0.5), "ROADMAP A3"),
    (dict(n_shards=2), "ROADMAP A10"),
    (dict(data_dtype="fp8"), "ROADMAP A9"),
    (dict(sparse_mode="csr"), "ROADMAP A7"),
    (dict(sparse_mode="chunked"), "ROADMAP A8")])
def test_out_of_slice_requests_raise(rng, kw, match):
    X, Y = make_problem(rng)
    with pytest.raises(NotImplementedError, match=match):
        CMF(n_components=3, device="cpu", **kw).fit(sp.csr_matrix(X), Y)


def test_beyond_densify_threshold_raises(rng):
    from pycmf_tpu_torch.utils.validation import as_coupled

    X = sp.csr_matrix(np.eye(40))
    with pytest.raises(NotImplementedError, match="ROADMAP A7"):
        as_coupled(X, torch.float32, "cpu", densify_threshold=100)


def test_cuda_device_without_cuda_raises(rng, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, Y = make_problem(rng)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        CMF(n_components=3).fit(X, Y)


def test_bad_inputs_raise_value_error(rng):
    X, Y = make_problem(rng)
    with pytest.raises(ValueError, match="negative"):
        CMF(n_components=3, device="cpu").fit(-X, Y)
    with pytest.raises(ValueError, match="bfloat16"):
        CMF(n_components=3, dtype="bfloat16", device="cpu").fit(X, Y)
    with pytest.raises(ValueError, match="loop"):
        CMF(n_components=3, loop="gpu", device="cpu").fit(X, Y)
    with pytest.raises(RuntimeError, match="before fit"):
        CMF(n_components=3, device="cpu").transform(X)
