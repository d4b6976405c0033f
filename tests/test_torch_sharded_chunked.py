"""The per-shard chunked layouts: the port's rows, cols and grid fits on
chunked blocks and cells (``sparse_mode='chunked'``, and 'auto''s chunked
routes: a sigmoid-linked sparse X or Y past the densify threshold) against
the reference's chunked ``n_shards`` fits, on the CPU; then the masked
chunk passes against the reference's in this process.

Both packages' chunk rows are cut to 8 (the reference's
``pick_chunk_rows``, the port's in its ranks), so every block or cell takes
several chunks, and the ranks' padding rows sit inside a chunk; the 'auto'
cases cut both densify thresholds to 8 bytes (the reference's
``utils.validation.DENSIFY_THRESHOLD``, the port's ``parallel.sharded``
one). A sigmoid-linked X under 'auto' is densified by both estimators
under shards, so its case calls run_sharded / run_grid directly. The
sampled case draws the reference's columns on every rank, nothing
injected. The port's ranks run in two spawned gloo
groups (``tests/_torch_dist.py``): 2 ranks for rows and cols, 4 for the
grid (2, 2); n = 31, m = 41 pad both axes.

Tolerances: float64 rtol 1e-9 on factors (atol 1e-12) and loss histories,
equal n_iter_ and loss_iters_, every rank's result equal bit for bit; the
chunk passes at rtol 1e-12 (1e-9 after a line search).
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from pycmf_tpu import CMF as JCMF
from pycmf_tpu.ops import chunked as jchunked
from pycmf_tpu.ops import losses as jlosses
from pycmf_tpu.parallel.grid import run_grid as j_run_grid
from pycmf_tpu.parallel.sharded import run_sharded as j_run_sharded
from pycmf_tpu.solvers import common as jcommon
from pycmf_tpu.solvers import newton_chunked as jnc
from pycmf_tpu.utils import validation as jvalidation
from pycmf_tpu_torch.ops import chunked as tchunked
from pycmf_tpu_torch.ops import losses as tlosses
from pycmf_tpu_torch.parallel.sharded import x_mode
from pycmf_tpu_torch.solvers import common as tcommon
from pycmf_tpu_torch.solvers import newton_chunked as tnc
from tests._torch_dist import run_cases, spawn
from tests.conftest import make_problem

K = 3
N, M = 31, 41
ROWS = 8          # rows per chunk, in both packages
THRESHOLD = 8     # bytes: every sparse block past it
BASE = dict(n_components=K, tol=1e-7, eval_every=3, dtype="float64",
            random_state=0, use_pallas=True)
SIGNED = dict(U_non_negative=False, V_non_negative=False,
              Z_non_negative=False)


def _data():
    rng = np.random.RandomState(51)
    X, Y = make_problem(rng, n=N, m=M)
    Xs = make_problem(np.random.RandomState(52), n=N, m=M, sparse=True)[0]
    Xbs = sp.csr_matrix((Xs.toarray() > np.median(Xs.data)).astype(float))
    Yb = (Y > np.median(Y)).astype(float)
    init = dict(U=np.abs(rng.randn(N, K)), V=np.abs(rng.randn(M, K)),
                Z=np.abs(rng.randn(Y.shape[1], K)))
    Xn = make_problem(np.random.RandomState(53), n=11, m=M, sparse=True)[0]
    return dict(X=X, Y=Y, Xs=Xs, Xbs=Xbs, Yb=Yb, Ybs=sp.csr_matrix(Yb),
                Xn=Xn, Un=np.abs(rng.randn(11, K)), init=init)


DATA = _data()

# name: (estimator kwargs, X, Y, densify threshold patched, direct run)
CASES = {
    "mu": (dict(solver="mu", max_iter=6, sparse_mode="chunked"), "Xs", "Y",
           False, False),
    "newton_linear_x": (dict(solver="newton", y_link="sigmoid", max_iter=6,
                             sparse_mode="chunked"), "Xs", "Yb", False,
                        False),
    "sigmoid_x_auto": (dict(solver="newton", x_link="sigmoid", max_iter=4,
                            **SIGNED), "Xbs", "Y", True, True),
    "sigmoid_y_auto": (dict(solver="newton", y_link="sigmoid", max_iter=4,
                            **SIGNED), "X", "Ybs", True, False),
    "sampled": (dict(solver="newton", y_link="sigmoid", max_iter=6,
                     sparse_mode="chunked", sg_sample_ratio=0.5), "Xs",
                "Yb", False, False),
}
# mesh name: (layout, mesh)
MESHES = {"rows_d2": ("rows", (2,)), "cols_d2": ("cols", (2,)),
          "grid_2x2": ("grid", (2, 2))}


def _world(mesh):
    return int(np.prod(MESHES[mesh][1]))


def _kw(mesh, case):
    layout, shape = MESHES[mesh]
    return dict(BASE, **CASES[case][0], shard_layout=layout,
                n_shards=shape if layout == "grid" else shape[0])


def _args(case):
    _, x, y, _, _ = CASES[case]
    return DATA[x], DATA[y]


def _run_parts(mesh, case):
    """A direct run's (solver, SolverConfig fields, run keywords)."""
    kw = _kw(mesh, case)
    cfg = {f: kw[f] for f in ("x_link", "U_non_negative", "V_non_negative",
                              "Z_non_negative") if f in kw}
    run = dict(max_iter=kw["max_iter"], tol=kw["tol"],
               eval_every=kw["eval_every"], sparse_mode="auto")
    return kw["solver"], dict(cfg, use_pallas=True), run


def _port_case(mesh, case):
    _, _, _, patched, direct = CASES[case]
    X, Y = _args(case)
    layout, shape = MESHES[mesh]
    c = dict(X=X, Y=Y, init=DATA["init"], chunk_rows=ROWS)
    if patched:
        c["threshold"] = THRESHOLD
    kw = _kw(mesh, case)
    if not direct:
        if case == "mu":   # and the fold-in of 11 sparse rows after it
            c.update(Xn=DATA["Xn"], Un=DATA["Un"])
        return dict(c, kind="fit", kw=kw)
    solver, cfg, run = _run_parts(mesh, case)
    if layout == "grid":
        c["grid"] = shape
    else:
        run.update(n_shards=shape[0], layout=layout)
    return dict(c, kind="run", solver=solver, cfg=cfg, run=run)


def _ref(mesh, case):
    """The reference's fit of the case: (n_iter, losses, iters, U, V, Z)."""
    _, _, _, _, direct = CASES[case]
    X, Y = _args(case)
    kw = _kw(mesh, case)
    if not direct:
        est = JCMF(**kw).fit(X, Y, **DATA["init"])
        out = dict(n_iter=est.n_iter_, losses=est.loss_history_,
                   iters=list(est.loss_iters_), U=est.U_, V=est.V_,
                   Z=est.Z_)
        if case == "mu":
            out["transform"] = est.transform(DATA["Xn"], U=DATA["Un"])
        return out
    solver, cfg, run = _run_parts(mesh, case)
    cfg = jcommon.SolverConfig(**dict(cfg, use_pallas=False))
    hyper = jcommon.make_hyper(dtype=jnp.float64)
    init = DATA["init"]
    layout, shape = MESHES[mesh]
    rng = jax.random.PRNGKey(0)
    args = (X, Y, init["U"], init["V"], init["Z"], cfg, hyper)
    if layout == "grid":
        out = j_run_grid(*args, grid=shape, dtype=jnp.float64, solver=solver,
                         rng=rng, **run)
    else:
        out = j_run_sharded(solver, *args, rng, n_shards=shape[0],
                            layout=layout, dtype=jnp.float64, **run)
    U, V, Z, n_iter, losses, iters, _ = out
    return dict(n_iter=int(n_iter), losses=[float(v) for v in losses],
                iters=list(iters), U=np.asarray(U), V=np.asarray(V),
                Z=np.asarray(Z))


_RESULTS = {}


def _run_all(tmp_path_factory):
    """Both spawns at once, the reference's fits while they run (its chunk
    rows, and for the 'auto' cases its threshold, patched): {world: (the
    reference's results, each rank's results)}, once per module."""
    if _RESULTS:
        return _RESULTS
    spawns = {}
    for w in (2, 4):
        cases = {f"{mesh}/{case}": _port_case(mesh, case)
                 for mesh in MESHES if _world(mesh) == w for case in CASES}
        spawns[w] = spawn(run_cases, w,
                          tmp_path_factory.mktemp(f"chunked{w}"), cases)
    ref = {}
    try:
        with warnings.catch_warnings(), pytest.MonkeyPatch.context() as mp:
            warnings.simplefilter("ignore", UserWarning)
            mp.setattr(jchunked, "pick_chunk_rows", lambda *a, **k: ROWS)
            for mesh in MESHES:
                for case in CASES:
                    with pytest.MonkeyPatch.context() as mt:
                        if CASES[case][3]:
                            mt.setattr(jvalidation, "DENSIFY_THRESHOLD",
                                       THRESHOLD)
                        ref[f"{mesh}/{case}"] = _ref(mesh, case)
    finally:
        ports = {w: s.join() for w, s in spawns.items()}
    _RESULTS.update({w: (ref, ports[w]) for w in ports})
    return _RESULTS


@pytest.fixture(params=[2, 4], ids=["ranks2", "ranks4"])
def chunked(request, tmp_path_factory):
    """(world, the reference's results, each rank's results)."""
    ref, ports = _run_all(tmp_path_factory)[request.param]
    return request.param, ref, ports


_FITS = [(_world(mesh), mesh, case) for mesh in MESHES for case in CASES]


@pytest.mark.parametrize("chunked,mesh,case", _FITS, indirect=["chunked"],
                         ids=[f"{m}-{c}" for _, m, c in _FITS])
def test_chunked_fit_matches_reference_f64(chunked, mesh, case):
    """MU and Newton on a chunked linear X (K1 or K2 per chunk on a rows
    shard), a sigmoid-linked sparse X or Y past the threshold under 'auto',
    and sampled Newton on chunked blocks (the draw as a column mask)."""
    _, ref, ports = chunked
    got, want = ports[0][f"{mesh}/{case}"], ref[f"{mesh}/{case}"]
    assert got["n_iter"] == want["n_iter"]
    assert got["iters"] == want["iters"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-9)
    for name in ("U", "V", "Z"):
        np.testing.assert_allclose(got[name], want[name], rtol=1e-9,
                                   atol=1e-12)


@pytest.mark.parametrize("chunked,mesh", [(_world(m), m) for m in MESHES],
                         indirect=["chunked"], ids=list(MESHES))
def test_chunked_transform_matches_reference_f64(chunked, mesh):
    """transform after a chunked fit folds 11 sparse rows in by rows over
    every rank, each rank's block of them chunked."""
    _, ref, ports = chunked
    np.testing.assert_allclose(ports[0][f"{mesh}/mu"]["transform"],
                               ref[f"{mesh}/mu"]["transform"], rtol=1e-9,
                               atol=1e-12)


def _local_shape(mesh, rows, cols):
    layout, shape = MESHES[mesh]
    if layout == "rows":
        return (-(-rows // shape[0]), cols)
    if layout == "cols":
        return (rows, -(-cols // shape[0]))
    return (-(-rows // shape[0]), -(-cols // shape[1]))


@pytest.mark.parametrize("chunked,mesh,case", _FITS, indirect=["chunked"],
                         ids=[f"{m}-{c}" for _, m, c in _FITS])
def test_each_rank_builds_its_own_chunked_layout(chunked, mesh, case):
    """Every rank streams its own zero-padded block or cell of X (and under
    'rows' the whole Y, else its row block j, for a sigmoid-linked sparse
    Y past the threshold), not a densified copy."""
    _, _, ports = chunked
    X, Y = _args(case)
    want = ([_local_shape(mesh, *X.shape)] if sp.issparse(X) else [])
    if sp.issparse(Y):
        layout, shape = MESHES[mesh]
        want.append(Y.shape if layout == "rows" else
                    (-(-Y.shape[0] // shape[-1]), Y.shape[1]))
    if case == "mu":   # and the transform's block of the new rows
        want.append((-(-DATA["Xn"].shape[0] // _world(mesh)), M))
    for port in ports:
        assert port[f"{mesh}/{case}"]["chunked"] == want


def test_every_rank_returns_the_same_result(chunked):
    world, _, ports = chunked
    assert len(ports) == world
    for name, a in ports[0].items():
        for other in ports[1:]:
            b = other[name]
            assert a["n_iter"] == b["n_iter"] and a["losses"] == b["losses"]
            for key in ("U", "V", "Z", "transform"):
                if key in a:
                    np.testing.assert_array_equal(a[key], b[key])


# -- in this process ----------------------------------------------------------

@pytest.mark.parametrize("where,local", [("shard", 16 * M),
                                         ("cell", 16 * 21)])
def test_auto_past_the_threshold_streams_sigmoid_keeps_linear_csr(
        monkeypatch, where, local):
    """ROADMAP C4 under shards: past the threshold 'auto' streams a
    sigmoid-linked X under Newton (the reference's chunked block or cell)
    and keeps a linear-linked one CSR, as on one device; below it both
    densify; 'chunked' by name streams either, 'csr' refuses a sigmoid X
    under Newton."""
    from pycmf_tpu_torch.parallel import sharded
    from pycmf_tpu_torch.solvers.common import SolverConfig

    lin, sig = SolverConfig(), SolverConfig(x_link="sigmoid")
    f64 = torch.float64
    Xs = DATA["Xs"]
    assert x_mode(Xs, local, f64, sig, "newton", "auto", where) == "dense"
    monkeypatch.setattr(sharded, "DENSIFY_THRESHOLD", THRESHOLD)
    assert x_mode(Xs, local, f64, lin, "newton", "auto", where) == "csr"
    assert x_mode(Xs, local, f64, lin, "mu", "auto", where) == "csr"
    assert x_mode(Xs, local, f64, sig, "newton", "auto", where) == "chunked"
    for cfg in (lin, sig):
        assert x_mode(Xs, local, f64, cfg, "newton", "chunked",
                      where) == "chunked"
    assert x_mode(DATA["X"], local, f64, sig, "newton", "chunked",
                  where) == "dense"
    with pytest.raises(ValueError, match="cannot hold a sigmoid-linked X"):
        x_mode(Xs, local, f64, sig, "newton", "csr", where)
    with pytest.raises(ValueError, match="requires dense device"):
        x_mode(Xs, local, torch.float8_e4m3fn, lin, "mu", "chunked", where)


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


def _pair(A, R=ROWS):
    return (jchunked.chunked_from_scipy(A, jnp.float64, chunk_rows=R),
            tchunked.chunked_from_scipy(A, torch.float64, chunk_rows=R,
                                        device="cpu"))


def _shard_block(rng, n_valid=13, n_loc=16, m=20, binary=False):
    """A rows shard's block: n_valid real rows, zero padding to n_loc, and
    its (n_loc,) mask."""
    A = sp.random(n_loc, m, density=0.3, format="lil", random_state=rng)
    A[n_valid:] = 0.0
    A = sp.csr_matrix(A)
    A.eliminate_zeros()
    if binary:
        A.data[:] = 1.0
    mask = np.zeros(n_loc)
    mask[:n_valid] = 1.0
    return A, mask


def test_valid_rows_with_a_row_mask_matches_reference(rng):
    A, mask = _shard_block(rng, n_loc=19)
    J, T = _pair(A)
    for rm in (None, mask):
        want = jchunked.valid_rows(J, jnp.float64,
                                   None if rm is None else jnp.asarray(rm))
        got = tchunked.valid_rows(T, torch.float64,
                                  None if rm is None else _t(rm))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("l1,eps", [(0.01, 1e-10), (0.0, 0.0)])
def test_chunked_mu_u_pass_with_n_valid_matches_row_mask(rng, use_pallas, l1,
                                                         eps):
    """A rows shard's padding rows cut by n_valid (K1's, per chunk) against
    the reference's row_mask: exact zeros there, also at l1 = ε = 0."""
    A, mask = _shard_block(rng)
    J, T = _pair(A)
    U, V = np.abs(rng.randn(16, 4)), np.abs(rng.randn(20, 4))
    U[13:] = 0.0
    VtV = V.T @ V
    want = jchunked.chunked_mu_u_pass(J, jnp.asarray(U), jnp.asarray(V),
                                      jnp.asarray(VtV), l1, 0.02, eps,
                                      row_mask=jnp.asarray(mask))
    got = tchunked.chunked_mu_u_pass(T, _t(U), _t(V), _t(VtV), l1, 0.02, eps,
                                     use_pallas, n_valid=13)
    assert not got[0][13:].any()
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12)


@pytest.mark.parametrize("use_pallas", [True, False])
def test_chunked_newton_linear_u_pass_with_n_valid_matches_reference(
        rng, use_pallas):
    """The padding rows (zero data, U and norm) stay exact zeros."""
    A, _ = _shard_block(rng)
    J, T = _pair(A)
    U, V = rng.randn(16, 4), rng.randn(20, 4)
    U[13:] = 0.0
    BtB = V.T @ V
    Hinv = np.linalg.inv(BtB + 0.3 * np.eye(4))
    row_sq = np.asarray(A.multiply(A).sum(axis=1)).ravel()
    want = jchunked.chunked_newton_linear_u_pass(
        J, jnp.asarray(U), jnp.asarray(V), jnp.asarray(BtB),
        jnp.asarray(Hinv), jnp.asarray(row_sq), 0.01, 0.1, trials=8,
        non_negative=False)
    got = tchunked.chunked_newton_linear_u_pass(
        T, _t(U), _t(V), _t(BtB), _t(Hinv), _t(row_sq), 0.01, 0.1, trials=8,
        non_negative=False, use_pallas=use_pallas, n_valid=13)
    assert not got[0][13:].any()
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-9,
                                   atol=1e-12)


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("col_masked", [False, True])
def test_chunked_sigmoid_row_update_row_mask_matches_reference(
        rng, use_pallas, col_masked):
    """A rows shard's sigmoid U update (row_mask: its padding rows, whose
    σ(0) = ½ residuals would move them) with and without a sampled column
    mask."""
    A, mask = _shard_block(rng, binary=True)
    J, T = _pair(A)
    M, B = 0.5 * rng.randn(16, 4), 0.5 * rng.randn(20, 4)
    M[13:] = 0.0
    cm = (rng.rand(20) < 0.5).astype(float) if col_masked else None
    jh = jcommon.make_hyper(0.05, 0.3, dtype=jnp.float64)
    th = tcommon.make_hyper(0.05, 0.3, dtype=torch.float64)
    want = jnc.chunked_sigmoid_row_update(
        J, jnp.asarray(M), jnp.asarray(B), jh, trials=8, non_negative=False,
        hessian_form="gauss", use_pallas=False, row_mask=jnp.asarray(mask),
        col_mask=None if cm is None else jnp.asarray(cm))
    got = tnc.chunked_sigmoid_row_update(
        T, _t(M), _t(B), th, trials=8, non_negative=False,
        hessian_form="gauss", use_pallas=use_pallas, row_mask=_t(mask),
        col_mask=None if cm is None else _t(cm))
    assert not got[13:].any()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9,
                               atol=1e-12)


@pytest.mark.parametrize("masks", ["row", "col", "both"])
def test_chunked_sigmoid_term_masks_match_reference(rng, masks):
    """The chunked sigmoid residual with a shard's row mask, a cell's
    column mask or both (the grid's chunked cell)."""
    A, rmask = _shard_block(rng, binary=True)
    J, T = _pair(A)
    M, B = 0.5 * rng.randn(16, 4), 0.5 * rng.randn(20, 4)
    cmask = np.ones(20)
    cmask[-3:] = 0.0
    rm = rmask if masks in ("row", "both") else None
    cm = cmask if masks in ("col", "both") else None
    want = jlosses._sigmoid_term(J, jnp.asarray(M), jnp.asarray(B),
                                 None if rm is None else jnp.asarray(rm),
                                 col_mask=None if cm is None
                                 else jnp.asarray(cm))
    got = tlosses.reconstruction_term(
        T, _t(M), _t(B), "sigmoid", row_mask=None if rm is None else _t(rm),
        col_mask=None if cm is None else _t(cm))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-12)
