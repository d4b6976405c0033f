"""The port's column-sharded CMF (``n_shards=d, shard_layout='cols'``, one
process per shard on torch.distributed) against the reference's (``shard_map``
over JAX's virtual CPU devices), on the CPU.

As in ``test_torch_sharded.py``: the reference runs in this process, the port
in d spawned gloo ranks (``tests/_torch_dist.py``), one spawn per d, started
before the reference's fits and joined after them, with the same NumPy data
and the same U0, V0, Z0. m = 41 shared columns leave 1 padding column on the
last shard for d = 2 and 3 for d = 4 (X's padding columns, Y's and V's
padding rows).

Tolerances: float64 rtol 1e-9 on factors (atol 1e-12), loss histories and
transforms, equal n_iter_ and loss_iters_; every rank's result equal bit for
bit. The device loop (``loop='device'``, Newton with its factored eval
loss) runs in the two-rank spawn: the key's first fit, the fit that builds
the cache entry and a hit, each against the reference's ``loop='device'``
cols fit and, bit for bit, the port's host loop.
"""
import warnings

import numpy as np
import pytest
import scipy.sparse as sp

from pycmf_tpu import CMF as JCMF
from pycmf_tpu_torch import CMF
from pycmf_tpu_torch.parallel.sharded import col_block
from tests._torch_dist import run_cases, spawn
from tests.conftest import make_problem

K = 4
N, M = 30, 41
BASE = dict(n_components=K, tol=1e-7, eval_every=5, dtype="float64",
            random_state=0, use_pallas=True, shard_layout="cols")
SIGNED = dict(U_non_negative=False, V_non_negative=False,
              Z_non_negative=False)


def _data():
    rng = np.random.RandomState(17)
    X, Y = make_problem(rng, n=N, m=M)
    Xs = make_problem(np.random.RandomState(18), n=N, m=M, sparse=True)[0]
    Xn = make_problem(np.random.RandomState(19), n=13, m=M)[0]
    init = dict(U=np.abs(rng.randn(N, K)), V=np.abs(rng.randn(M, K)),
                Z=np.abs(rng.randn(Y.shape[1], K)))
    Yb = (Y > np.median(Y)).astype(float)
    return dict(X=X, Y=Y, Xs=Xs, Xb=(X > np.median(X)).astype(float),
                Yb=Yb, Ybs=sp.csr_matrix(Yb), Ys=sp.csr_matrix(
                    Y * (np.random.RandomState(20).rand(*Y.shape) > 0.6)),
                Xn=Xn, Un=np.abs(rng.randn(13, K)), init=init)


DATA = _data()

# name: (estimator kwargs, X, Y); every case fits from DATA["init"]
CASES = {
    "mu_dense": (dict(solver="mu", max_iter=20), "X", "Y"),
    "mu_csr": (dict(solver="mu", max_iter=20, sparse_mode="csr"), "Xs", "Y"),
    "mu_sparse_linear_y": (dict(solver="mu", max_iter=10), "X", "Ys"),
    "newton_linear": (dict(solver="newton", max_iter=10), "X", "Y"),
    "newton_sigmoid_y": (dict(solver="newton", y_link="sigmoid",
                              max_iter=10), "X", "Yb"),
    "newton_sparse_sigmoid_y": (dict(solver="newton", y_link="sigmoid",
                                     max_iter=6, **SIGNED), "X", "Ybs"),
    "newton_sigmoid_x": (dict(solver="newton", x_link="sigmoid", max_iter=6,
                              **SIGNED), "Xb", "Y"),
    "newton_sigmoid_x_plain": (dict(solver="newton", x_link="sigmoid",
                                    max_iter=6, use_pallas=False, **SIGNED),
                               "Xb", "Y"),
    "newton_csr": (dict(solver="newton", max_iter=10, sparse_mode="csr"),
                   "Xs", "Y"),
    "newton_elastic_net": (dict(solver="newton", y_link="sigmoid",
                                max_iter=10, alpha=0.1, l1_ratio=0.4,
                                **SIGNED), "X", "Yb"),
}
# held to the port's single-device fit too (padding, l1 > 0, signed)
SINGLE = ("newton_elastic_net",)


def _kw(name):
    kw, _, _ = CASES[name]
    return dict(BASE, **kw)


def _fit_args(name):
    _, x, y = CASES[name]
    return DATA[x], DATA[y]


# requests the cols port refused and now fits in the two ranks, each held to
# the reference's fit of the same request: fp8 data, sampled Newton (each
# rank drawing the reference's columns) and the chunked layout (a sparse X)
REQUEST = dict(n_components=2, max_iter=2, random_state=0,
               shard_layout="cols")
FP8_REQUEST = dict(REQUEST, data_dtype="fp8", dtype="float32")
# the device loop: Newton on a linear X (cols_aux_kind 'factored': V's
# update hands over the eval loss's terms), three fits from an emptied fit
# cache beside its host-loop twin
DEVICE_KW = dict(REQUEST, n_components=K, solver="newton", max_iter=9,
                 eval_every=2, tol=1e-7, dtype="float64", use_pallas=True)
NOW_FIT = {
    "device_loop": (dict(DEVICE_KW, loop="device"), "X"),
    "fp8": (FP8_REQUEST, "X"),
    "sampled": (dict(REQUEST, solver="newton", sg_sample_ratio=0.5,
                     dtype="float64"), "X"),
    "chunked": (dict(REQUEST, sparse_mode="chunked", dtype="float64"), "Xs"),
}


def _request_case(name):
    kw, x = NOW_FIT[name]
    return dict(kind="fit", kw=dict(kw, n_shards=2), X=DATA[x], Y=DATA["Y"])


def _port_cases(d):
    cases = {}
    for name in CASES:
        X, Y = _fit_args(name)
        case = dict(kind="fit", kw=dict(_kw(name), n_shards=d), X=X, Y=Y,
                    init=DATA["init"])
        if name == "mu_dense":  # and the fold-in of new rows after it
            case.update(Xn=DATA["Xn"], Un=DATA["Un"])
        cases[name] = case
    if d == 2:
        for name in NOW_FIT:
            if name != "device_loop":   # that request is device_device's
                cases["request_" + name] = _request_case(name)
        for loop in ("device", "host"):
            cases["device_" + loop] = dict(
                kind="fit", kw=dict(DEVICE_KW, n_shards=2, loop=loop),
                X=DATA["X"], Y=DATA["Y"], init=DATA["init"], repeat=3)
    return cases


@pytest.fixture(scope="module", params=[2, 4], ids=["d2", "d4"])
def sharded(request, tmp_path_factory):
    """(d, the reference's results, each rank's results): the port's
    ranks run while the reference fits."""
    d = request.param
    ranks = spawn(run_cases, d, tmp_path_factory.mktemp(f"cols{d}"),
                  _port_cases(d))
    ref = {}
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            for name in CASES:
                est = JCMF(n_shards=d, **_kw(name))
                est.fit(*_fit_args(name), **DATA["init"])
                ref[name] = est
        ref["transformed"] = ref["mu_dense"].transform(DATA["Xn"],
                                                       U=DATA["Un"])
        if d == 2:
            for name, (kw, x) in NOW_FIT.items():
                init = DATA["init"] if name == "device_loop" else {}
                ref["request_" + name] = JCMF(n_shards=2, **kw).fit(
                    DATA[x], DATA["Y"], **init)
    finally:
        ports = ranks.join()
    return d, ref, ports


def _assert_fit(got, want):
    assert got["n_iter"] == want.n_iter_
    assert got["iters"] == list(want.loss_iters_)
    np.testing.assert_allclose(got["losses"], want.loss_history_, rtol=1e-9)
    for name in ("U", "V", "Z"):
        np.testing.assert_allclose(got[name], getattr(want, name + "_"),
                                   rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("case", list(CASES))
def test_cols_fit_matches_reference_f64(sharded, case):
    d, ref, ports = sharded
    _assert_fit(ports[0][case], ref[case])


def test_cols_transform_matches_reference_f64(sharded):
    """transform after a cols fit folds in by rows (U's update alone), as
    the reference's does whatever the fit's layout: 13 new rows."""
    d, ref, ports = sharded
    np.testing.assert_allclose(ports[0]["mu_dense"]["transform"],
                               ref["transformed"], rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("case", SINGLE)
def test_cols_fit_matches_port_single_device(sharded, case):
    d, _, ports = sharded
    est = CMF(device="cpu", **_kw(case))
    est.fit(*_fit_args(case), **DATA["init"])
    _assert_fit(ports[0][case], est)


def test_every_rank_returns_the_same_result(sharded):
    d, _, ports = sharded
    assert len(ports) == d
    for name in CASES:
        for other in ports[1:]:
            a, b = ports[0][name], other[name]
            assert a["n_iter"] == b["n_iter"] and a["losses"] == b["losses"]
            for key in ("U", "V", "Z", "transform"):
                if key in a:
                    np.testing.assert_array_equal(a[key], b[key])


def test_col_block_pads_like_the_reference():
    """Rank r's block: columns r·⌈m/d⌉ on, zero columns past m; CSR and
    dense alike."""
    X = DATA["Xs"]
    for rank in range(4):
        blk, m_valid = col_block(X, 11, rank)
        want = np.zeros((N, 11))
        cols = X.toarray()[:, rank * 11:rank * 11 + 11]
        want[:, :cols.shape[1]] = cols
        assert sp.isspmatrix_csr(blk) and blk.shape == (N, 11)
        np.testing.assert_array_equal(blk.toarray(), want)
        assert m_valid == cols.shape[1]
        dense, mv = col_block(X.toarray(), 11, rank)
        np.testing.assert_array_equal(dense, want)
        assert mv == m_valid
    assert col_block(X, 11, 3)[1] == M - 33


# -- in this process: refusals, and a one-rank group ------------------------

def _est(**kw):
    return CMF(device="cpu", n_components=2, max_iter=2, shard_layout="cols",
               **kw)


@pytest.mark.parametrize("sharded", [2], indirect=True, ids=["d2"])
@pytest.mark.parametrize("kw", [
    "device_loop",
    "sampled",
    "chunked",
    "fp8",
], ids=["device_loop", "sampled", "chunked", "fp8"])
def test_cols_unported_requests_raise_naming_a10c(sharded, kw):
    """Requests earlier slices refused naming A10c fit in the two ranks:
    the device loop (Newton, its factored eval loss), sampled Newton (each
    rank drawing the reference's columns) and the chunked layout (a sparse X) as the
    reference's cols fits of the same request do (f64 rtol 1e-9), and fp8
    data with its objective within 1e-4 of the reference's cols fp8 fit
    (test_torch_fp8.py's bar)."""
    d, ref, ports = sharded
    want = ref["request_" + kw]
    if kw == "device_loop":   # from DATA["init"]: the device_device case
        _assert_fit(ports[0]["device_device"], want)
        return
    got = ports[0]["request_" + kw]
    assert got["n_iter"] == want.n_iter_ == 2
    if kw != "fp8":
        _assert_fit(got, want)
        return
    np.testing.assert_allclose(got["losses"], want.loss_history_, rtol=1e-4)


@pytest.mark.parametrize("sharded", [2], indirect=True, ids=["d2"])
def test_cols_device_loop_matches_host_loop_bit_for_bit(sharded):
    """The cols device loop's first fit, the fit that builds the cache
    entry and a hit (one launch of the fit graph's stand-in) each equal
    the port's host-loop cols fit bit for bit, with the same COMM calls
    and bytes, on every rank, and every rank takes the same branch with
    the same all-reduces per captured block."""
    d, ref, ports = sharded
    for port in ports:
        host = port["device_host"]
        fits = port["device_device"]["fits"]
        _assert_fit(fits[0], ref["request_device_loop"])
        for f in fits:
            assert f["n_iter"] == host["n_iter"]
            assert f["losses"] == host["losses"]
            for key in ("U", "V", "Z"):
                np.testing.assert_array_equal(f[key], host[key])
            assert f["comm"][:2] == host["comm"][:2]
        first, build, hit = (f["info"] for f in fits)
        assert (first["eager_blocks"], build["graph_launches"],
                hit["hit"], hit["graph_launches"]) == (1, 1, True, 1)
        assert first["collectives"] == hit["collectives"] > 0
    assert [f["info"] for f in ports[1]["device_device"]["fits"]] == [
        f["info"] for f in ports[0]["device_device"]["fits"]]


@pytest.fixture
def world1(tmp_path):
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_cols_one_rank_equals_single_device(world1):
    """At one rank the cols fit is the single-device fit's arithmetic up to
    the order of sums: equal n_iter and f64 agreement."""
    kw = dict(_kw("newton_sigmoid_y"))
    a = CMF(device="cpu", n_shards=-1, **kw).fit(
        *_fit_args("newton_sigmoid_y"), **DATA["init"])
    kw.pop("shard_layout")
    b = CMF(device="cpu", **kw).fit(*_fit_args("newton_sigmoid_y"),
                                    **DATA["init"])
    assert a.n_iter_ == b.n_iter_
    np.testing.assert_allclose(a.loss_history_, b.loss_history_, rtol=1e-9)
    np.testing.assert_allclose(a.V_, b.V_, rtol=1e-9, atol=1e-12)


def test_cols_sigmoid_sparse_y_past_threshold_raises(world1, monkeypatch):
    """A sigmoid-linked sparse Y past the densify threshold, which earlier
    slices refused (hence the name), now takes the per-shard chunked
    carrier: the one-rank cols fit builds it (Y's padded row block) and
    equals the reference's cols fit at n_shards=1 with the same threshold
    (f64 rtol 1e-9); the reference's linear-Y warning stays."""
    import jax
    import jax.numpy as jnp
    import torch

    from pycmf_tpu.parallel.sharded import run_sharded as j_run_sharded
    from pycmf_tpu.solvers import common as jcommon
    from pycmf_tpu.utils import validation as jvalidation
    from pycmf_tpu_torch.parallel import sharded
    from pycmf_tpu_torch.solvers.common import SolverConfig, make_hyper
    from pycmf_tpu_torch.utils import validation

    monkeypatch.setattr(sharded, "DENSIFY_THRESHOLD", 8)
    monkeypatch.setattr(jvalidation, "DENSIFY_THRESHOLD", 8)
    built, make = [], validation.chunked_from_scipy
    monkeypatch.setattr(validation, "chunked_from_scipy", lambda A, *a, **k: (
        built.append(A.shape), make(A, *a, **k))[1])
    U, V, Z = (DATA["init"][c] for c in "UVZ")
    flags = dict(y_link="sigmoid", U_non_negative=False,
                 V_non_negative=False, Z_non_negative=False)
    run = dict(n_shards=1, layout="cols", max_iter=4, tol=1e-7,
               eval_every=2)
    got = sharded.run_sharded(
        "newton", DATA["X"], DATA["Ybs"], U, V, Z,
        SolverConfig(use_pallas=True, **flags),
        make_hyper(dtype=torch.float64), dtype=torch.float64, device="cpu",
        **run)
    assert built == [DATA["Ybs"].shape]
    want = j_run_sharded(
        "newton", DATA["X"], DATA["Ybs"], U, V, Z,
        jcommon.SolverConfig(**flags), jcommon.make_hyper(dtype=jnp.float64),
        jax.random.PRNGKey(0), dtype=jnp.float64, **run)
    assert got[3] == int(want[3]) and list(got[5]) == list(want[5])
    np.testing.assert_allclose(got[4], np.asarray(want[4]), rtol=1e-9)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-9,
                                   atol=1e-12)
    with pytest.warns(UserWarning, match="LINEAR-linked sparse Y"):
        sharded.run_sharded("mu", DATA["X"], DATA["Ys"], U, V, Z,
                            SolverConfig(), make_hyper(dtype=torch.float64),
                            n_shards=1, layout="cols", dtype=torch.float64,
                            device="cpu", max_iter=1)


def test_torchrun_demo_runs_two_cols_ranks():
    """The README's command with --layout cols: two processes under
    torchrun (a localhost rendezvous on a free port), gloo, on the CPU."""
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "pycmf_tpu_torch.parallel.demo",
         "--backend", "gloo", "--device", "cpu", "--docs", "300",
         "--terms", "400", "--max-iter", "10", "--layout", "cols"],
        cwd=root, capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stderr[-2000:]
    line = [s for s in out.stdout.splitlines() if "shards:" in s]
    assert len(line) == 1 and line[0].startswith("2 shards: n_iter 10")
    assert line[0].endswith("layout cols")
    loss, single = (float(p.split("loss ")[1].split(";")[0])
                    for p in line[0].split("one device"))
    assert abs(loss - single) <= 1e-4 * single
