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


def _sig_setup(rng, x_link, y_link, n=61, k=4, with_y=True):
    X, Y = make_problem(rng, n=n, k=k, binary_y=y_link == "sigmoid")
    if x_link == "sigmoid":
        X = (X > np.median(X)).astype(float)
    U0 = np.abs(rng.randn(n, k))
    V0 = np.abs(rng.randn(X.shape[1], k))
    Z0 = np.abs(rng.randn(Y.shape[1], k)) if with_y else np.zeros((0, k))
    return X, (Y if with_y else None), U0, V0, Z0


_LINKS = [("linear", "sigmoid"), ("sigmoid", "linear"), ("sigmoid", "sigmoid")]


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("x_link,y_link", _LINKS)
@pytest.mark.parametrize("non_negative,trials", [(True, 8), (False, 3)])
def test_run_newton_sigmoid_trajectory(rng, use_pallas, x_link, y_link,
                                       non_negative, trials):
    """Sigmoid links through both branches: use_pallas runs the fused
    sigmoid updates (K3, K4, K5 in both packages, JAX's in interpret
    mode), and a sigmoid X link takes the φ eval loss."""
    X, Y, U0, V0, Z0 = _sig_setup(rng, x_link, y_link)
    j, t = _run_pair("newton", X, Y, U0, V0, Z0, alpha=0.1, l1_ratio=0.5,
                     use_pallas=use_pallas, line_search_trials=trials,
                     x_link=x_link, y_link=y_link,
                     U_non_negative=non_negative, V_non_negative=non_negative,
                     Z_non_negative=non_negative, max_iter=12, eval_every=4)
    _assert_same_run(j, t)


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("trials,with_y", [(0, True), (8, False)])
def test_run_newton_sigmoid_x_plain_steps_and_no_y(rng, use_pallas, trials,
                                                   with_y):
    """trials=0 (plain projected steps, no φ eval loss) and a sigmoid X
    without Y."""
    X, Y, U0, V0, Z0 = _sig_setup(rng, "sigmoid", "sigmoid", with_y=with_y)
    j, t = _run_pair("newton", X, Y, U0, V0, Z0, use_pallas=use_pallas,
                     line_search_trials=trials, x_link="sigmoid",
                     y_link="sigmoid", max_iter=8, eval_every=4)
    _assert_same_run(j, t)


def _sig_factor_problem(rng, y_link, n=37, m=50, k=4, r=7):
    X = (rng.rand(n, m) < 0.3).astype(np.float64)
    M, B = 0.5 * rng.randn(n, k), 0.5 * rng.randn(m, k)
    Yd = ((rng.rand(n, r) < 0.4).astype(np.float64) if y_link == "sigmoid"
          else np.abs(rng.randn(n, r)))
    return X, M, B, Yd, rng.randn(r, k)


@pytest.mark.parametrize("y_link", [None, "linear", "sigmoid"])
@pytest.mark.parametrize("trials,return_phi,non_negative",
                         [(8, False, False), (8, True, True), (0, False, True)])
def test_fused_sigmoid_update_matches_reference(rng, y_link, trials,
                                                return_phi, non_negative):
    X, M, B, Yd, Zf = _sig_factor_problem(rng, y_link)
    jh = jcommon.make_hyper(0.05, 0.3, 1e-9, 0.2, dtype=jnp.float64)
    th = tcommon.make_hyper(0.05, 0.3, 1e-9, 0.2, dtype=torch.float64)
    kw = dict(trials=trials, non_negative=non_negative, use_pallas=True,
              y_link=y_link or "linear", return_phi=return_phi)
    want = jnewton.fused_sigmoid_update(
        jnp.asarray(M), jnp.asarray(X), jnp.asarray(B), jh,
        yterm=(jnewton.Term(jnp.asarray(Yd), jnp.asarray(Zf))
               if y_link else None), **kw)
    got = tnewton.fused_sigmoid_update(
        torch.from_numpy(M), torch.from_numpy(X), torch.from_numpy(B), th,
        yterm=(tnewton.Term(torch.from_numpy(Yd), torch.from_numpy(Zf))
               if y_link else None), **kw)
    if return_phi:
        (want, wphi), (got, gphi) = want, got
        np.testing.assert_allclose(float(gphi.sum()), float(wphi),
                                   rtol=1e-12)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-10, atol=1e-13)


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("y_link", ["linear", "sigmoid"])
@pytest.mark.parametrize("return_phi", [True, False])
def test_newton_update_factor_sigmoid_matches_reference(rng, use_pallas,
                                                        y_link, return_phi):
    """V's update in the sigmoid-X orientation: a sigmoid term plus a
    linear or sigmoid Y term, per-row systems (K5 under use_pallas)."""
    X, M, B, Yd, Zf = _sig_factor_problem(rng, y_link)
    jh = jcommon.make_hyper(0.05, 0.3, 1e-9, 0.2, dtype=jnp.float64)
    th = tcommon.make_hyper(0.05, 0.3, 1e-9, 0.2, dtype=torch.float64)
    kw = dict(non_negative=True, trials=8, hessian_form="gauss",
              sample_ratio=1.0, use_pallas=use_pallas, return_phi=return_phi)
    links = ("sigmoid", y_link)
    want = jnewton.newton_update_factor(
        jax.random.PRNGKey(0), jnp.asarray(M),
        (jnewton.Term(jnp.asarray(X), jnp.asarray(B)),
         jnewton.Term(jnp.asarray(Yd), jnp.asarray(Zf))), links, jh, **kw)
    got = tnewton.newton_update_factor(
        None, torch.from_numpy(M),
        (tnewton.Term(torch.from_numpy(X), torch.from_numpy(B)),
         tnewton.Term(torch.from_numpy(Yd), torch.from_numpy(Zf))), links,
        th, **kw)
    if not return_phi:
        want, got = (want,), (got,)
    for a, b in zip(want, got):
        np.testing.assert_allclose(_np(b), _np(a), rtol=1e-10, atol=1e-13)


@pytest.mark.parametrize("kw", [
    dict(), dict(use_pallas=True), dict(x_link="sigmoid"),
    dict(x_link="sigmoid", use_pallas=True),
    dict(x_link="sigmoid", line_search_trials=0),
    dict(x_link="sigmoid", update_V=False),
    dict(y_link="sigmoid", use_pallas=True)])
@pytest.mark.parametrize("dtype", ["float64", "bfloat16"])
def test_aux_kind_matches_reference(rng, kw, dtype):
    X, Y, U0, _, _ = _setup(rng)
    jdt = {"float64": jnp.float64, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float64": torch.float64, "bfloat16": torch.bfloat16}[dtype]
    want = jnewton._aux_kind(jcommon.SolverConfig(**kw), j_as_coupled(X, jdt),
                             jnp.asarray(U0))
    got = tnewton._aux_kind(tcommon.SolverConfig(**kw),
                            t_as_coupled(X, tdt, "cpu"), torch.from_numpy(U0))
    assert got == want
