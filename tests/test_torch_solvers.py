"""The port's solvers (pycmf_tpu_torch/solvers) against the JAX reference's
(pycmf_tpu/solvers) on the CPU: the same NumPy problem and initial factors
through both, both branches (use_pallas True: the fused U pass, which in
JAX runs the Pallas kernels in interpret mode and in the port the kernels'
plain versions; use_pallas False: the unfused U → Z → V path).

Tolerances, float64: loss histories rtol 1e-9 (the reference's own bar for
its sharded parity), equal iteration counts, factors rtol 1e-7 (the
factors carry the summation-order differences of every iteration).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pycmf_tpu.solvers import common as jcommon
from pycmf_tpu.solvers import mu as jmu
from pycmf_tpu.solvers import newton as jnewton
from pycmf_tpu.utils.validation import as_coupled as j_as_coupled
from pycmf_tpu_torch.solvers import common as tcommon
from pycmf_tpu_torch.solvers import mu as tmu
from pycmf_tpu_torch.solvers import newton as tnewton
from pycmf_tpu_torch.utils.validation import as_coupled as t_as_coupled
from tests.conftest import make_problem


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float64).numpy()
    return np.asarray(x, dtype=np.float64)


def _setup(rng, n=61, with_y=True, k=4, non_negative=True):
    X, Y = make_problem(rng, n=n, k=k, non_negative=non_negative)
    U0 = np.abs(rng.randn(n, k))
    V0 = np.abs(rng.randn(X.shape[1], k))
    Z0 = np.abs(rng.randn(Y.shape[1], k)) if with_y else np.zeros((0, k))
    return X, (Y if with_y else None), U0, V0, Z0


def _run_pair(solver, X, Y, U0, V0, Z0, *, alpha=0.0, l1_ratio=0.0,
              max_iter=30, tol=1e-6, eval_every=5, **cfg_kw):
    jcfg = jcommon.SolverConfig(has_Y=Y is not None, **cfg_kw)
    tcfg = tcommon.SolverConfig(has_Y=Y is not None, **cfg_kw)
    jh = jcommon.make_hyper(alpha, l1_ratio, dtype=jnp.float64)
    th = tcommon.make_hyper(alpha, l1_ratio, dtype=torch.float64)
    Xj = j_as_coupled(X, jnp.float64)
    Yj = j_as_coupled(Y, jnp.float64) if Y is not None else None
    Xt = t_as_coupled(X, torch.float64, "cpu")
    Yt = t_as_coupled(Y, torch.float64, "cpu") if Y is not None else None
    kw = dict(max_iter=max_iter, tol=tol, eval_every=eval_every)
    jargs = (Xj, Yj, jnp.asarray(U0), jnp.asarray(V0), jnp.asarray(Z0), jcfg,
             jh)
    targs = (Xt, Yt, torch.from_numpy(U0), torch.from_numpy(V0),
             torch.from_numpy(Z0), tcfg, th)
    if solver == "mu":
        return jmu.run_mu(*jargs, **kw), tmu.run_mu(*targs, **kw)
    return (jnewton.run_newton(*jargs, jax.random.PRNGKey(0), **kw),
            tnewton.run_newton(*targs, None, **kw))


def _assert_same_run(j, t):
    assert j[3] == t[3], "n_iter"
    assert list(j[5]) == list(t[5]), "loss_iters"
    np.testing.assert_allclose(t[4], j[4], rtol=1e-9)
    for a, b in zip(j[:3], t[:3]):
        np.testing.assert_allclose(_np(b), _np(a), rtol=1e-7, atol=1e-12)


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("with_y", [True, False])
@pytest.mark.parametrize("alpha,l1_ratio", [(0.0, 0.0), (0.3, 0.4)])
def test_run_mu_trajectory(rng, use_pallas, with_y, alpha, l1_ratio):
    X, Y, U0, V0, Z0 = _setup(rng, with_y=with_y)
    j, t = _run_pair("mu", X, Y, U0, V0, Z0, alpha=alpha, l1_ratio=l1_ratio,
                     use_pallas=use_pallas)
    _assert_same_run(j, t)


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("with_y", [True, False])
@pytest.mark.parametrize("non_negative,trials", [(True, 8), (False, 3),
                                                 (True, 0)])
def test_run_newton_trajectory(rng, use_pallas, with_y, non_negative,
                               trials):
    X, Y, U0, V0, Z0 = _setup(rng, with_y=with_y)
    j, t = _run_pair("newton", X, Y, U0, V0, Z0, alpha=0.1, l1_ratio=0.5,
                     use_pallas=use_pallas, line_search_trials=trials,
                     U_non_negative=non_negative,
                     V_non_negative=non_negative,
                     Z_non_negative=non_negative, max_iter=12, eval_every=4)
    _assert_same_run(j, t)


@pytest.mark.parametrize("max_iter,eval_every,want", [
    (25, 10, [0, 10, 20, 25]), (6, 10, [0, 6]), (9, 3, [0, 3, 6, 9])])
def test_loop_remainder_block_and_eval_points(rng, max_iter, eval_every,
                                              want):
    X, Y, U0, V0, Z0 = _setup(rng)
    j, t = _run_pair("mu", X, Y, U0, V0, Z0, max_iter=max_iter, tol=0.0,
                     eval_every=eval_every, use_pallas=True)
    assert list(t[5]) == want
    _assert_same_run(j, t)


def test_tol_rule_stops_like_reference(rng):
    """A loose tol stops both loops at the same eval point."""
    X, Y, U0, V0, Z0 = _setup(rng)
    j, t = _run_pair("mu", X, Y, U0, V0, Z0, max_iter=200, tol=1e-2,
                     eval_every=5, use_pallas=True)
    assert t[3] < 200
    _assert_same_run(j, t)


def test_non_finite_loss_raises():
    def block(state, hyper, rng, n):
        return state, torch.tensor(float("nan")), rng

    with pytest.raises(FloatingPointError, match="non-finite loss"):
        tcommon.run_solver_loop(block, None, None, None, max_iter=5, tol=0.0,
                                eval_every=2,
                                initial_loss_fn=lambda s, h: 1.0)


@pytest.mark.parametrize("alpha,l1_ratio", [(0.0, 0.0), (0.5, 0.3)])
def test_single_steps_match(rng, alpha, l1_ratio):
    """One MU and one Newton step, unfused, against the reference's."""
    X, Y, U0, V0, Z0 = _setup(rng)
    jh = jcommon.make_hyper(alpha, l1_ratio, dtype=jnp.float64)
    th = tcommon.make_hyper(alpha, l1_ratio, dtype=torch.float64)
    Xj, Yj = jcommon.Coupled(jnp.asarray(X)), jcommon.Coupled(jnp.asarray(Y))
    Xt, Yt = tcommon.Coupled(torch.from_numpy(X)), \
        tcommon.Coupled(torch.from_numpy(Y))
    fj = [jnp.asarray(a) for a in (U0, V0, Z0)]
    ft = [torch.from_numpy(a) for a in (U0, V0, Z0)]
    cfg_j, cfg_t = jcommon.SolverConfig(), tcommon.SolverConfig()
    for a, b in zip(jmu.make_mu_step(cfg_j)(Xj, Yj, *fj, jh),
                    tmu.make_mu_step(cfg_t)(Xt, Yt, *ft, th)):
        np.testing.assert_allclose(_np(b), _np(a), rtol=1e-10)
    for a, b in zip(
            jnewton.make_newton_step(cfg_j)(Xj, Yj, *fj, jh,
                                            jax.random.PRNGKey(0)),
            tnewton.make_newton_step(cfg_t)(Xt, Yt, *ft, th)):
        np.testing.assert_allclose(_np(b), _np(a), rtol=1e-10, atol=1e-13)


def test_shared_gauss_hinv_matches(rng):
    V = rng.randn(40, 4)
    jh = jcommon.make_hyper(0.3, 0.2, 1e-10, 0.25, dtype=jnp.float64)
    th = tcommon.make_hyper(0.3, 0.2, 1e-10, 0.25, dtype=torch.float64)
    want = jnewton.shared_gauss_hinv(jnp.asarray(V), jh)
    got = tnewton.shared_gauss_hinv(torch.from_numpy(V), th)
    for a, b in zip(want[:2], got[:2]):
        np.testing.assert_allclose(_np(b), _np(a), rtol=1e-12)
    np.testing.assert_allclose(got[2:], [float(want[2]), float(want[3])],
                               rtol=1e-15)


def test_hyper_rounds_like_reference_f32():
    """l1 and l2 are derived in the factor dtype, as the reference's traced
    scalars are."""
    jh = jcommon.make_hyper(0.37, 0.61, 1e-10, 0.2, dtype=jnp.float32)
    th = tcommon.make_hyper(0.37, 0.61, 1e-10, 0.2, dtype=torch.float32)
    assert th.l1 == float(jh.alpha * jh.l1_ratio)
    assert th.l2 == float(jh.alpha * (1.0 - jh.l1_ratio))
    assert th.hessian_pertubation == float(jh.hessian_pertubation)


@pytest.mark.parametrize("kw,match", [
    (dict(y_link="sigmoid"), "ROADMAP A3"),
    (dict(x_link="sigmoid"), "ROADMAP A3"),
    (dict(sg_sample_ratio=0.5), "ROADMAP A3"),
    (dict(hessian_form="full"), "ROADMAP A3")])
def test_out_of_slice_configs_raise(kw, match):
    with pytest.raises(NotImplementedError, match=match):
        tcommon.SolverConfig(**kw)


def test_invalid_configs_raise_value_error():
    with pytest.raises(ValueError):
        tcommon.SolverConfig(x_link="relu")
    with pytest.raises(ValueError):
        tcommon.SolverConfig(sg_sample_ratio=0.0)
    with pytest.raises(ValueError):
        tmu.run_mu(None, None, None, None, None, tcommon.SolverConfig(),
                   None, loop="gpu")


def test_cholesky_of_non_pd_matrix_is_nan_like_reference():
    """Not positive definite: NaN factor in both packages (no host check),
    so the fit loop reports it as a non-finite loss."""
    H = np.array([[1.0, 2.0], [2.0, 1.0]])
    want = jax.scipy.linalg.cho_factor(jnp.asarray(H))[0]
    got = tnewton._cholesky(torch.from_numpy(H))
    assert np.isnan(np.asarray(want)).any() and torch.isnan(got).all()
    np.testing.assert_allclose(
        _np(tnewton._cholesky(torch.from_numpy(4.0 * np.eye(2)))),
        2.0 * np.eye(2))
