"""Stochastic minibatch Newton (``sg_sample_ratio`` < 1) and the full
Hessian form (``hessian_form='full'``) of the port against the reference,
on the CPU.

The port draws its columns as the reference does (``ops/random.py``:
Threefry-2x32 under ``PRNGKey(seed)``, the reference's key schedule
``fold_in(key, it)`` → ``split(·, 3)`` → ``fold_in(k, t)`` → ``choice``),
so nothing is injected: the two packages' sampled fits with one
``random_state`` are compared directly.

Tolerances: float64, the reference with use_pallas=False against both
of the port's paths, rtol 1e-9 (atol 1e-12) on loss histories, factors
and transforms (the reference's own bar for its sharded parity; a
gathered sum adds the drawn columns in ascending order where the
reference adds them in the draw's). The device loop's CPU stand-in and
the host loop agree bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from pycmf_tpu import CMF as JCMF
from pycmf_tpu.ops import sparse as jsparse
from pycmf_tpu.solvers import common as jcommon
from pycmf_tpu.solvers import newton as jnewton
from pycmf_tpu_torch import CMF
from pycmf_tpu_torch.models import cmf as tcmf
from pycmf_tpu_torch.ops import random as trandom
from pycmf_tpu_torch.ops import sparse as tsparse
from pycmf_tpu_torch.ops.kernels import bell as tbell
from pycmf_tpu_torch.solvers import common as tcommon
from pycmf_tpu_torch.solvers import newton as tnewton
from tests.conftest import make_problem


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.asarray(a, dtype=np.float64)).to(dtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float64).numpy()
    return np.asarray(x, dtype=np.float64)


def _key(seed):
    return trandom.prng_key(seed)


# -- masked row norms -------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16])
def test_masked_row_sq_norms_matches_reference(rng, dtype):
    """CSR against the reference's segment sum; bf16 data squares at the
    mask's dtype in both (rtol 1e-12: the same products, summed in order)."""
    A = sp.random(23, 31, density=0.3, random_state=rng, format="csr")
    A.data = np.round(A.data * 8) / 8  # exact in bf16
    mask = (rng.rand(31) < 0.4).astype(np.float64)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float64
    want = jsparse.masked_row_sq_norms(jsparse.csr_from_scipy(A, jdt),
                                       jnp.asarray(mask))
    for use_pallas in (False, True):
        got = tsparse.masked_row_sq_norms(
            tsparse.csr_from_scipy(A, dtype, device="cpu"), _t(mask),
            use_pallas)
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-12)


def test_masked_row_sq_norms_of_block_ell(rng):
    """A BlockEll (how the port holds a block-structured matrix under
    use_pallas) gives the CSR's masked norms; rows and columns off the
    128 grid, zero filler blocks included."""
    A = sp.random(300, 200, density=0.05, random_state=rng, format="csr")
    A[:128] = 0.0  # a row block with no stored entries
    A.eliminate_zeros()
    mask = _t((rng.rand(200) < 0.5).astype(np.float64))
    bell = tbell.bell_from_scipy(A, torch.float64, device="cpu")
    want = tsparse.masked_row_sq_norms(
        tsparse.csr_from_scipy(A, torch.float64, device="cpu"), mask)
    got = tsparse.masked_row_sq_norms(bell, mask)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-12, atol=0)


# -- one factor update ------------------------------------------------------

def _update_case(rng, case):
    """(M, port terms, reference terms, links, hessian_form)."""
    p, q, k = 17, 29, 3
    M = np.abs(rng.randn(p, k))
    B = np.abs(rng.randn(q, k))
    if case == "csr":
        D = sp.random(p, q, density=0.4, random_state=rng, format="csr")
        return (M, [tnewton.Term(tsparse.csr_from_scipy(D, torch.float64,
                                                         device="cpu"),
                                  _t(B))],
                [jnewton.Term(jsparse.csr_from_scipy(D, jnp.float64),
                              jnp.asarray(B))], ("linear",), "gauss")
    if case == "two_terms":
        D1 = np.abs(rng.randn(p, q))
        B2 = np.abs(rng.randn(11, k))
        D2 = (rng.rand(p, 11) > 0.5).astype(float)
        return (M, [tnewton.Term(_t(D1), _t(B)), tnewton.Term(_t(D2), _t(B2))],
                [jnewton.Term(jnp.asarray(D1), jnp.asarray(B)),
                 jnewton.Term(jnp.asarray(D2), jnp.asarray(B2))],
                ("linear", "sigmoid"), "gauss")
    link, form = {"linear": ("linear", "gauss"),
                  "sigmoid": ("sigmoid", "gauss"),
                  "sigmoid_full": ("sigmoid", "full")}[case]
    D = ((rng.rand(p, q) > 0.5).astype(float) if link == "sigmoid"
         else np.abs(rng.randn(p, q)))
    if link == "sigmoid":
        M, B = M - 0.5, B - 0.5
    return (M, [tnewton.Term(_t(D), _t(B))],
            [jnewton.Term(jnp.asarray(D), jnp.asarray(B))], (link,), form)


@pytest.mark.parametrize("case", ["linear", "sigmoid", "sigmoid_full",
                                  "csr", "two_terms"])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_newton_update_factor_sampled_matches_reference(rng, case,
                                                        use_pallas):
    """One sampled Newton update (ratio 0.4) under the same key in both
    packages, each term drawing under fold_in(key, t): dense terms gather,
    the CSR term is masked; the full form's systems take LU in both."""
    M, tterms, jterms, links, form = _update_case(rng, case)
    key = jax.random.PRNGKey(7)
    kw = dict(non_negative=case == "linear" or case == "csr", trials=6,
              hessian_form=form, sample_ratio=0.4)
    jh = jcommon.make_hyper(0.1, 0.3, dtype=jnp.float64)
    th = tcommon.make_hyper(0.1, 0.3, dtype=torch.float64)
    want = jnewton.newton_update_factor(key, jnp.asarray(M), tuple(jterms),
                                        links, jh, use_pallas=False, **kw)
    got = tnewton.newton_update_factor(_key(7), _t(M),
                                       tuple(tterms), links, th,
                                       use_pallas=use_pallas, **kw)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("link,form", [("linear", "gauss"),
                                       ("sigmoid", "gauss"),
                                       ("sigmoid", "full")])
def test_accumulate_term_with_mask_matches_reference(rng, link, form):
    """A column mask on a dense term (the reference's sharding padding;
    the port's sampled sparse terms): G, the Hessian parts and φ."""
    p, q, k = 9, 14, 3
    M, B = rng.randn(p, k), rng.randn(q, k)
    D = (rng.rand(p, q) > 0.5).astype(float)
    mask = (rng.rand(q) > 0.4).astype(float)
    jout = jnewton._accumulate_term(jnp.asarray(M), jnp.asarray(D),
                                    jnp.asarray(B), link, form,
                                    jnp.asarray(mask), False)
    tout = tnewton._accumulate_term(_t(M), tnewton.Term(_t(D), _t(B)), link,
                                    False, form, _t(mask))
    for a, b in zip(tout[:3], jout[:3]):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_allclose(_np(a), _np(b), rtol=1e-10,
                                       atol=1e-12)
    C = rng.randn(p, k)
    np.testing.assert_allclose(_np(tnewton._phi_term(_t(C), tout[3])),
                               _np(jnewton._phi_term(jnp.asarray(C),
                                                     jout[3])),
                               rtol=1e-10)


def test_sample_mask_equals_gather(rng):
    """The same draw as a mask gives the gathered term's G, H and φ; both
    take the reference's indices under the key."""
    p, q, k = 8, 21, 3
    M, B, D = rng.randn(p, k), rng.randn(q, k), np.abs(rng.randn(p, q))
    key = trandom.fold_in(_key(4), 2)
    mask = tnewton.sample_mask(key, q, 0.3, torch.float64)
    Ds, Bs, _ = tnewton._sample_columns(key, _t(D), _t(B), 0.3)
    assert int(mask.sum()) == tnewton.sample_size(q, 0.3) == Bs.shape[0]
    want = np.sort(np.asarray(jax.random.choice(
        jax.random.fold_in(jax.random.PRNGKey(4), 2), q,
        (tnewton.sample_size(q, 0.3),), replace=False)))
    np.testing.assert_array_equal(np.flatnonzero(mask.numpy()), want)
    np.testing.assert_array_equal(Bs.numpy(), B[want])
    a = tnewton._accumulate_term(_t(M), tnewton.Term(_t(D), _t(B)),
                                 "linear", mask=mask)
    b = tnewton._accumulate_term(_t(M), tnewton.Term(Ds, Bs), "linear")
    for x, y in zip(a[:2], b[:2]):
        np.testing.assert_allclose(_np(x), _np(y), rtol=1e-12, atol=1e-12)


def test_draw_is_uniform_without_replacement_and_static():
    """s = ceil(ratio q) distinct indices, ascending, the reference's set;
    every column is drawn about equally often over 400 keys; one key
    draws the same columns every time, another key others."""
    base = _key(3)
    seen = np.zeros(50)
    first = tnewton.draw_columns(base, 50, 13)
    for i in range(400):
        idx = tnewton.draw_columns(trandom.fold_in(base, i), 50, 13)
        assert idx.shape == (13,) and idx.dtype == torch.long
        assert torch.equal(idx, torch.unique(idx))  # distinct, ascending
        seen[idx.numpy()] += 1
    assert torch.equal(first, tnewton.draw_columns(base, 50, 13))
    assert not torch.equal(first, tnewton.draw_columns(
        trandom.fold_in(base, 0), 50, 13))
    np.testing.assert_array_equal(first.numpy(), np.sort(np.asarray(
        jax.random.choice(jax.random.PRNGKey(3), 50, (13,), replace=False))))
    assert seen.min() > 0.7 * seen.mean() and seen.max() < 1.3 * seen.mean()
    assert tnewton.sample_size(20, 0.25) == 5
    assert tnewton.sample_size(3, 0.01) == 1
    with pytest.raises(ValueError, match="int64 key"):
        tnewton.draw_columns(None, 5, 2)


# -- whole fits through the estimator --------------------------------------

_FITS = {
    "dense_linear": (dict(), False),
    "dense_sigmoid_y": (dict(y_link="sigmoid"), False),
    "csr_linear": (dict(sparse_mode="csr"), True),
    "csr_sigmoid_y": (dict(sparse_mode="csr", y_link="sigmoid"), True),
    "full_hessian": (dict(y_link="sigmoid", hessian_form="full"), False),
    "sigmoid_x": (dict(x_link="sigmoid", U_non_negative=False,
                       V_non_negative=False), False),
}


def _fit_data(rng, name):
    kw, sparse = _FITS[name]
    X, Y = make_problem(rng, n=37, m=26, r=9, sparse=sparse,
                        binary_y=kw.get("y_link") == "sigmoid")
    if kw.get("x_link") == "sigmoid":
        X = (X > np.median(X)).astype(float)
    return X, Y, kw


@pytest.mark.parametrize("name", sorted(_FITS))
@pytest.mark.parametrize("use_pallas", [False, True])
def test_sampled_fit_matches_reference_f64(rng, name, use_pallas):
    """CMF(solver='newton', sg_sample_ratio=0.4, random_state=5), f64,
    both packages, each drawing its own columns (the reference with
    use_pallas=False): n_iter, eval points, loss history, factors."""
    X, Y, kw = _fit_data(rng, name)
    params = dict(n_components=3, solver="newton", sg_sample_ratio=0.4,
                  random_state=5, max_iter=12, eval_every=3, tol=1e-9,
                  dtype="float64", alpha=0.05, l1_ratio=0.3, **kw)
    j = JCMF(use_pallas=False, **params).fit(X, Y)
    t = CMF(use_pallas=use_pallas, device="cpu", **params).fit(X, Y)
    assert t.n_iter_ == j.n_iter_ and t.loss_iters_ == j.loss_iters_
    np.testing.assert_allclose(t.loss_history_, j.loss_history_, rtol=1e-9)
    for f in ("U_", "V_", "Z_"):
        np.testing.assert_allclose(getattr(t, f), getattr(j, f), rtol=1e-9,
                                   atol=1e-12)


def test_sampled_transform_matches_reference(rng):
    """The fold-in draws under the fit's key (U's term only), as the
    reference's transform does."""
    X, Y = make_problem(rng, n=37, m=26, r=9)
    params = dict(n_components=3, solver="newton", sg_sample_ratio=0.5,
                  random_state=2, max_iter=4, eval_every=2, tol=0.0,
                  dtype="float64")
    j = JCMF(use_pallas=False, **params).fit(X, Y)
    t = CMF(device="cpu", **params)
    t.V_, t.n_components_ = j.V_, 3
    np.testing.assert_allclose(t.transform(X[:8]), j.transform(X[:8]),
                               rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("name", ["dense_linear", "dense_sigmoid_y",
                                  "csr_linear", "full_hessian"])
def test_sampled_fit_device_loop_stand_in_equals_host_loop(rng, name):
    """The device loop's CPU stand-in (a capture pass that leaves the key
    counter where it was, replays that advance it) ends where the host
    loop does, bit for bit: a frozen draw or one off by a block would
    still converge, to other bits. Each of the three fits (the key's
    first, the one that builds the cache entry, a hit) equals it."""
    X, Y, kw = _fit_data(rng, name)
    params = dict(n_components=3, solver="newton", sg_sample_ratio=0.4,
                  random_state=1, max_iter=14, eval_every=3, tol=0.0,
                  device="cpu", **kw)
    h = CMF(loop="host", **params).fit(X, Y)
    tcommon.clear_fit_cache()
    for hit in (False, False, True):
        d = CMF(loop="device", **params).fit(X, Y)
        assert tcommon.LAST_FIT["hit"] is hit
        assert h.loss_history_ == d.loss_history_ and h.n_iter_ == d.n_iter_
        for f in ("U_", "V_", "Z_"):
            assert np.array_equal(getattr(h, f), getattr(d, f))
    assert tcommon.LAST_FIT["graph_launches"] == 1
    assert tcommon.LAST_FIT["replays"] == 0
    tcommon.clear_fit_cache()


def test_device_loop_stand_in_capture_leaves_generator():
    """A capture draws nothing: after it the key stream's counter is where
    it was, and the replays draw what eager blocks from there draw, in
    turn, each advancing the counter."""
    ks = trandom.KeyStream.start(_key(4))
    out = torch.zeros(3, 2, dtype=torch.int64)

    def fn():
        out.copy_(ks.step_keys(0))
        ks.advance(5)

    graph = tcommon.EagerBlockGraph()
    graph.capture(fn, [out, *ks])
    assert int(ks.it) == 0 and not out.any()
    eager = trandom.KeyStream.start(_key(4))
    for _ in range(2):
        graph.replay()
        assert torch.equal(out, eager.step_keys(0))
        eager.advance(5)
    assert int(ks.it) == int(eager.it) == 10


def test_same_seed_same_fit_other_seed_other_fit(rng):
    X, Y = make_problem(rng, n=37, m=26, r=9)
    params = dict(n_components=3, solver="newton", sg_sample_ratio=0.3,
                  max_iter=6, eval_every=3, tol=0.0, device="cpu")
    a = CMF(random_state=11, **params).fit(X, Y)
    b = CMF(random_state=11, **params).fit(X, Y)
    c = CMF(random_state=12, **params).fit(X, Y)
    assert np.array_equal(a.U_, b.U_) and a.loss_history_ == b.loss_history_
    assert not np.array_equal(a.U_, c.U_)


def test_seed_rule_is_the_reference_rule():
    """None → 0, an int → itself, a RandomState → its state's first word
    (read, not consumed): the reference's _jax_seed."""
    from pycmf_tpu.models.cmf import _jax_seed

    rs = np.random.RandomState(9)
    for r in (None, 0, 17, np.int64(5), rs):
        assert tcmf._seed(r) == _jax_seed(r)
    state = rs.get_state()[1].copy()
    tcmf._seed(rs)
    assert np.array_equal(rs.get_state()[1], state)
    for r in (None, 17, rs):
        key = tcmf._key(r, torch.device("cpu"))
        assert key.dtype == torch.int64 and key.device.type == "cpu"
        np.testing.assert_array_equal(
            key.numpy(), np.asarray(jax.random.PRNGKey(_jax_seed(r))))


_SYNC = ("item", "cpu", "tolist", "numpy", "__float__", "__int__",
         "__bool__", "__index__")


@pytest.mark.parametrize("name", ["dense_linear", "dense_sigmoid_y",
                                  "csr_linear", "full_hessian"])
def test_sampled_step_makes_no_host_sync(rng, monkeypatch, name):
    """Inside a sampled step no tensor's value reaches the host: every
    conversion that would sync with a card fails."""
    from pycmf_tpu_torch.utils.validation import as_coupled

    X, Y, kw = _fit_data(rng, name)
    est = CMF(n_components=3, solver="newton", sg_sample_ratio=0.4,
              device="cpu", **kw)
    cfg = est._config(has_Y=True)
    sm = est._matrix_sparse_mode
    Xc = as_coupled(X, torch.float32, "cpu", use_pallas=True,
                    sparse_mode=sm(X, est.x_link))
    Yc = as_coupled(Y, torch.float32, "cpu", use_pallas=True,
                    sparse_mode=sm(Y, est.y_link, is_x=False))
    U, V, Z = (torch.rand(s, 3) for s in (X.shape[0], X.shape[1],
                                          Y.shape[1]))
    hyper = tcommon.make_hyper(0.05, 0.3)
    step = tnewton.make_newton_step(cfg)
    keys = trandom.KeyStream.start(_key(0)).step_keys(0)
    calls = []

    def refuse(name):
        def fn(self, *a, **k):
            calls.append(name)
            raise AssertionError(f"host sync: Tensor.{name}")
        return fn

    for attr in _SYNC:
        monkeypatch.setattr(torch.Tensor, attr, refuse(attr))
    U2, V2, Z2 = step(Xc, Yc, U, V, Z, hyper, keys)
    monkeypatch.undo()
    assert calls == []
    assert all(bool(torch.isfinite(t).all()) for t in (U2, V2, Z2))
