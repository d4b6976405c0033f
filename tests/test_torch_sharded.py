"""The port's row-sharded CMF (``n_shards``, one process per shard on
torch.distributed) against the reference's (``shard_map`` over JAX's
virtual CPU devices), on the CPU.

The reference runs in this process; the port runs in d spawned gloo ranks
(``tests/_torch_dist.py``; the ranks never import JAX), one spawn per d for
every case, started before the reference's fits and joined after them. Both
get the same NumPy data and the same U0, V0, Z0 (and U0 of the fold-in).
n = 61 rows (23 in the fold-in) leave a
padding row on the last shard for d = 2 and 3 for d = 4.

Tolerances: float64 rtol 1e-9 on factors (atol 1e-12), loss histories and
transforms, and equal n_iter_ (the reference's own sharded-vs-single bar,
MULTICHIP_r05.json); every rank's result equal bit for bit.

The device loop under shards (``loop='device'``) runs in the two-rank
spawn: each case's fits from an emptied fit cache (the key's first fit,
the fit that builds the cache entry, a hit) against the reference's
``loop='device'`` fit of the same request and, bit for bit, against the
port's own host loop, with the same COMM counts.
"""
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import scipy.sparse as sp
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

from pycmf_tpu import CMF as JCMF
from pycmf_tpu.parallel.mesh import AXIS as J_AXIS
from pycmf_tpu.parallel.mesh import make_mesh as j_make_mesh
from pycmf_tpu.solvers.common import make_hyper as j_make_hyper
from pycmf_tpu.solvers.newton import Term as JTerm
from pycmf_tpu.solvers.newton import \
    fused_sigmoid_update as j_fused_sigmoid_update
from pycmf_tpu.solvers.newton import \
    newton_update_factor as j_newton_update_factor
from pycmf_tpu_torch import CMF
from pycmf_tpu_torch.parallel import mesh as tmesh
from pycmf_tpu_torch.parallel.sharded import row_block, run_sharded
from pycmf_tpu_torch.solvers.common import SolverConfig
from pycmf_tpu_torch.solvers.common import make_hyper as t_make_hyper
from pycmf_tpu_torch.solvers.newton import \
    fused_sigmoid_update as t_fused_sigmoid_update
from tests._torch_dist import run_cases, spawn
from tests.conftest import make_problem

K = 4
BASE = dict(n_components=K, tol=1e-7, eval_every=5, dtype="float64",
            random_state=0, use_pallas=True)
SIGNED = dict(U_non_negative=False, V_non_negative=False,
              Z_non_negative=False)


def _data():
    rng = np.random.RandomState(7)
    X, Y = make_problem(rng, n=61, m=40)
    Xs = make_problem(np.random.RandomState(8), n=61, m=40, sparse=True)[0]
    Xn = make_problem(np.random.RandomState(9), n=23, m=40)[0]
    init = dict(U=np.abs(rng.randn(61, K)), V=np.abs(rng.randn(40, K)),
                Z=np.abs(rng.randn(Y.shape[1], K)))
    return dict(X=X, Y=Y, Xs=Xs, Xb=(X > np.median(X)).astype(float),
                Yb=(Y > np.median(Y)).astype(float), Xn=Xn,
                Un=np.abs(rng.randn(23, K)), init=init)


DATA = _data()

# name: (estimator kwargs, X, Y); every case fits from DATA["init"]
CASES = {
    "mu_dense": (dict(solver="mu", max_iter=20), "X", "Y"),
    "mu_csr": (dict(solver="mu", max_iter=20, sparse_mode="csr"), "Xs", "Y"),
    "newton_sigmoid_y": (dict(solver="newton", y_link="sigmoid",
                              max_iter=10), "X", "Yb"),
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
# the port's n_shards=-1 / 'all', held to the reference's n_shards=d fit of
# the same case (the reference's -1 would take all 8 virtual devices)
ALL_SHARDS = {"all_minus_1": -1, "all_str": "all"}
# held to the port's single-device fit too; the elastic-net case keeps
# padding rows with l1 > 0 and signed factors (the reference's own sharded
# fit equals its single-device one there)
SINGLE = ("mu_dense", "newton_sigmoid_y", "newton_elastic_net")


def _kw(name):
    kw, _, _ = CASES[name]
    return dict(BASE, **kw)


def _fit_args(name):
    _, x, y = CASES[name]
    return DATA[x], DATA[y]


# -- the forms of the solvers' distributed pieces (d = 2) --------------------

def _sigmoid_form_case():
    rng = np.random.RandomState(3)
    p, q, k, r = 13, 30, K, 6
    X = (rng.rand(p, q) > 0.5).astype(float)
    B = rng.randn(q, k)
    # the layout's padding columns: zero data against zero factor rows
    X[:, -2:] = 0.0
    B[-2:] = 0.0
    mask = np.ones(p)
    mask[-3:] = 0.0
    return dict(kind="sigmoid", M=rng.randn(p, k) * 0.5, X=X, B=B,
                Y=rng.randn(p, r), Z=rng.randn(r, k) * 0.5,
                row_mask=mask, trials=8, non_negative=False,
                return_phi=True, hyper=(0.1, 0.4, 1e-10, 0.2))


def _newton_factor_case(link):
    rng = np.random.RandomState(4)
    p, q, q2, k = 11, 30, 9, K
    D = ((rng.rand(p, q) > 0.5).astype(float) if link == "sigmoid"
         else np.abs(rng.randn(p, q)))
    mask = np.ones(q)
    mask[-2:] = 0.0  # padding columns
    D[:, -2:] = 0.0
    B = rng.randn(q, k) * 0.5
    B[-2:] = 0.0
    return dict(kind="newton_factor", M=rng.randn(p, k) * 0.3, D=D, B=B,
                D2=np.abs(rng.randn(p, q2)), B2=np.abs(rng.randn(q2, k)),
                link=link, link2="linear",
                mask=mask if link == "sigmoid" else None, trials=8,
                non_negative=False, hyper=(0.1, 0.4, 1e-10, 0.2))


FORMS = {"sigmoid_group": _sigmoid_form_case(),
         "newton_factor_sigmoid": _newton_factor_case("sigmoid"),
         "newton_factor_linear": _newton_factor_case("linear")}

# requests earlier slices refused and this one fits (the grid layout in
# both spellings, fp8 data, sampled Newton drawing the reference's
# columns, the chunked layout on a sparse X), in the two-rank spawn: held
# to the reference's fit of the same request
REQUEST = dict(n_components=2, max_iter=2, random_state=0)
NOW_FIT = {
    "grid": dict(n_shards=2, shard_layout="grid", dtype="float64"),
    "grid_tuple": dict(n_shards=(2, 1), shard_layout="grid",
                       dtype="float64"),
    "fp8": dict(n_shards=2, data_dtype="fp8", dtype="float32"),
    "sampled": dict(n_shards=2, solver="newton", sg_sample_ratio=0.5,
                    dtype="float64"),
    "chunked": dict(n_shards=2, sparse_mode="chunked", dtype="float64"),
}
REQUEST_X = {"chunked": "Xs"}   # else X

# the device loop under shards in the two-rank spawn: name: (estimator
# kwargs, X, Y); each fits from DATA["init"] three times from an emptied
# fit cache (first fit, build, hit), beside its host-loop twin; the sampled
# case drawing the reference's columns itself
DEVICE = {
    "device_mu": (dict(BASE, solver="mu", max_iter=13, eval_every=3),
                  "X", "Y"),
    "device_sampled": (dict(BASE, solver="newton", y_link="sigmoid",
                            sg_sample_ratio=0.5, max_iter=7, eval_every=2,
                            tol=0.0), "X", "Yb"),
}
# run_sharded's own loop='device' on device_mu's request (two runs: first
# fit, build), then a run on a new group of the same ranks, which must not
# find the cache entry
RUN_DEVICE = dict(solver="mu", cfg=dict(use_pallas=True),
                  run=dict(n_shards=2, loop="device", max_iter=13, tol=1e-7,
                           eval_every=3))


def _device_case(name, loop="device"):
    kw, x, y = DEVICE[name]
    return dict(kind="fit", kw=dict(kw, n_shards=2, loop=loop), X=DATA[x],
                Y=DATA[y], init=DATA["init"], repeat=3)


def _device_cases():
    cases = {}
    for name in DEVICE:
        cases[name] = _device_case(name)
        cases[name + "_host"] = _device_case(name, "host")
    # fit_cache_limit 0 on rank 1 alone: its second fit may not build, so
    # neither rank does
    cases["device_mu_no_cache_rank1"] = dict(_device_case("device_mu"),
                                             repeat=2, no_cache_rank=1)
    init = DATA["init"]
    cases["run_device"] = dict(kind="run", X=DATA["X"], Y=DATA["Y"],
                               init=init, repeat=2, new_group=True,
                               **RUN_DEVICE)
    return cases


def _request_case(name):
    X = DATA[REQUEST_X.get(name, "X")]
    return dict(kind="fit", kw=dict(REQUEST, **NOW_FIT[name]), X=X,
                Y=DATA["Y"])


def _port_cases(d):
    cases = {}
    for name in CASES:
        X, Y = _fit_args(name)
        case = dict(kind="fit", kw=dict(_kw(name), n_shards=d), X=X, Y=Y,
                    init=DATA["init"])
        if name == "mu_dense":  # and the fold-in of new rows after it
            case.update(Xn=DATA["Xn"], Un=DATA["Un"])
        cases[name] = case
    for name, ns in ALL_SHARDS.items():
        X, Y = _fit_args("mu_dense")
        cases[name] = dict(kind="fit", kw=dict(_kw("mu_dense"), n_shards=ns),
                           X=X, Y=Y, init=DATA["init"])
    if d == 2:
        cases.update(FORMS)
        for name in NOW_FIT:
            cases["request_" + name] = _request_case(name)
        cases.update(_device_cases())
    return cases


def _ref_sigmoid_form(case):
    hyper = j_make_hyper(*case["hyper"], dtype=jax.numpy.float64)

    def f(M, X, B, Y, Z, mask):
        return j_fused_sigmoid_update(
            M, X, B, hyper, trials=case["trials"],
            non_negative=case["non_negative"], use_pallas=True,
            yterm=JTerm(Y, Z), row_mask=mask, axis_name=J_AXIS,
            return_phi=True)

    sm = jax.jit(jax.shard_map(f, mesh=j_make_mesh(2), in_specs=(
        P(), P(None, J_AXIS), P(J_AXIS, None), P(), P(), P()),
        out_specs=(P(), P()), check_vma=False))
    out, phi = sm(case["M"], case["X"], case["B"], case["Y"], case["Z"],
                  case["row_mask"])
    return np.asarray(out), float(phi)


def _ref_newton_factor(case):
    hyper = j_make_hyper(*case["hyper"], dtype=jax.numpy.float64)
    masked = case["mask"] is not None

    def f(M, D, B, D2, B2, mask):
        return j_newton_update_factor(
            jax.random.PRNGKey(0), M, (JTerm(D, B), JTerm(D2, B2)),
            (case["link"], case["link2"]), hyper,
            non_negative=case["non_negative"], trials=case["trials"],
            hessian_form="gauss", sample_ratio=1.0, use_pallas=False,
            distributed=(True, False),
            masks=(mask if masked else None, None), axis_name=J_AXIS,
            return_phi=True)

    mask = case["mask"] if masked else np.ones(case["D"].shape[1])
    sm = jax.jit(jax.shard_map(f, mesh=j_make_mesh(2), in_specs=(
        P(), P(None, J_AXIS), P(J_AXIS, None), P(), P(), P(J_AXIS)),
        out_specs=(P(), P()), check_vma=False))
    out, phi = sm(case["M"], case["D"], case["B"], case["D2"], case["B2"],
                  mask)
    return np.asarray(out), np.asarray(phi)


@pytest.fixture(scope="module", params=[2, 4], ids=["d2", "d4"])
def sharded(request, tmp_path_factory):
    """(d, the reference's results, each rank's results): the port's
    ranks run while the reference fits."""
    d = request.param
    ranks = spawn(run_cases, d, tmp_path_factory.mktemp(f"ranks{d}"),
                  _port_cases(d))
    ref = {}
    try:
        for name in CASES:
            est = JCMF(n_shards=d, **_kw(name))
            est.fit(*_fit_args(name), **DATA["init"])
            ref[name] = est
        ref["transformed"] = ref["mu_dense"].transform(DATA["Xn"],
                                                       U=DATA["Un"])
        if d == 2:
            ref["sigmoid_group"] = _ref_sigmoid_form(FORMS["sigmoid_group"])
            for name in ("newton_factor_sigmoid", "newton_factor_linear"):
                ref[name] = _ref_newton_factor(FORMS[name])
            for name, kw in NOW_FIT.items():
                ref["request_" + name] = JCMF(**REQUEST, **kw).fit(
                    DATA[REQUEST_X.get(name, "X")], DATA["Y"])
            for name, (kw, x, y) in DEVICE.items():
                ref[name] = JCMF(n_shards=2, loop="device", **kw).fit(
                    DATA[x], DATA[y], **DATA["init"])
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
def test_sharded_fit_matches_reference_f64(sharded, case):
    d, ref, ports = sharded
    _assert_fit(ports[0][case], ref[case])


def test_sharded_transform_matches_reference_f64(sharded):
    """transform under n_shards (the rows layout, U's update alone) of 23
    new rows after the mu_dense fit."""
    d, ref, ports = sharded
    np.testing.assert_allclose(ports[0]["mu_dense"]["transform"],
                               ref["transformed"], rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("case", list(ALL_SHARDS))
def test_all_shards_resolves_to_the_group(sharded, case):
    """n_shards=-1 and 'all' take the group's size: the fit of n_shards=d."""
    d, ref, ports = sharded
    _assert_fit(ports[0][case], ref["mu_dense"])


@pytest.mark.parametrize("case", SINGLE)
def test_sharded_fit_matches_port_single_device(sharded, case):
    d, _, ports = sharded
    est = CMF(device="cpu", **_kw(case))
    est.fit(*_fit_args(case), **DATA["init"])
    _assert_fit(ports[0][case], est)


def test_every_rank_returns_the_same_result(sharded):
    d, _, ports = sharded
    assert len(ports) == d
    for name in list(CASES) + list(ALL_SHARDS):
        for other in ports[1:]:
            a, b = ports[0][name], other[name]
            assert a["n_iter"] == b["n_iter"] and a["losses"] == b["losses"]
            for key in ("U", "V", "Z", "transform"):
                if key in a:
                    np.testing.assert_array_equal(a[key], b[key])


@pytest.mark.parametrize("sharded", [2], indirect=True, ids=["d2"])
def test_fused_sigmoid_update_group_form_matches_reference(sharded):
    """The group form (K3's G/H and K4's φ summed over 2 ranks, the
    elastic-net terms added once, the Y term local) with a row mask and
    two padding columns, whose φ constant (0.125 per padding column and
    unmasked row) both keep. (The forms run in the 2-rank spawn.)"""
    d, ref, ports = sharded
    want_M, want_phi = ref["sigmoid_group"]
    for rank in ports:
        got_M, got_phi = rank["sigmoid_group"]
        np.testing.assert_allclose(got_M, want_M, rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(got_phi.sum(), want_phi, rtol=1e-9)
        assert np.all(got_M[-3:] == 0) and np.all(got_phi[-3:] == 0)


@pytest.mark.parametrize("sharded", [2], indirect=True, ids=["d2"])
@pytest.mark.parametrize("link", ["sigmoid", "linear"])
def test_newton_update_factor_distributed_form_matches_reference(sharded,
                                                                 link):
    """A term sharded over 2 ranks by column (distributed, with the
    padding-column mask under a sigmoid link) beside a local one."""
    d, ref, ports = sharded
    want_M, want_phi = ref[f"newton_factor_{link}"]
    for rank in ports:
        got_M, got_phi = rank[f"newton_factor_{link}"]
        np.testing.assert_allclose(got_M, want_M, rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(got_phi, want_phi, rtol=1e-9)


def test_fused_sigmoid_update_row_mask_form_matches_reference():
    """The row-mask form alone (U's update on a shard), in this process."""
    case = _sigmoid_form_case()
    j_hyper = j_make_hyper(*case["hyper"], dtype=jax.numpy.float64)
    want, want_phi = j_fused_sigmoid_update(
        case["M"], case["X"], case["B"], j_hyper, trials=8,
        non_negative=True, use_pallas=True, row_mask=case["row_mask"],
        return_phi=True)
    t = torch.from_numpy
    got, got_phi = t_fused_sigmoid_update(
        t(case["M"]), t(case["X"]), t(case["B"]),
        t_make_hyper(*case["hyper"], dtype=torch.float64), trials=8,
        non_negative=True, use_pallas=True, row_mask=t(case["row_mask"]),
        return_phi=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(float(got_phi.sum()), float(want_phi),
                               rtol=1e-9)
    assert np.all(got.numpy()[-3:] == 0)


def test_row_block_pads_like_the_reference():
    """Rank r's block: rows r·⌈n/d⌉ on, zero rows past n; CSR and dense
    alike."""
    X = DATA["Xs"]
    for rank in range(4):
        blk, n_valid = row_block(X, 16, rank)
        want = np.zeros((16, X.shape[1]))
        rows = X.toarray()[rank * 16:rank * 16 + 16]
        want[:rows.shape[0]] = rows
        assert sp.issparse(blk) and blk.shape == (16, X.shape[1])
        np.testing.assert_array_equal(blk.toarray(), want)
        assert n_valid == rows.shape[0]
        dense, nv = row_block(X.toarray(), 16, rank)
        np.testing.assert_array_equal(dense, want)
        assert nv == n_valid
    assert row_block(X, 16, 3)[1] == 61 - 48


# -- refusals, in this process ----------------------------------------------

def _est(**kw):
    return CMF(device="cpu", n_components=2, max_iter=2, **kw)


@pytest.mark.parametrize("kw", [dict(n_shards=2), dict(n_shards=-1),
                                dict(n_shards="all")],
                         ids=["2", "minus_1", "all"])
def test_shards_without_a_process_group_raise(kw):
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="no torch.distributed process "
                                         "group is initialized"):
        _est(**kw).fit(DATA["X"], DATA["Y"])


def test_group_of_the_wrong_size_raises(tmp_path):
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        with pytest.raises(ValueError, match="requested 2 devices but the "
                                             "process group has 1"):
            _est(n_shards=2).fit(DATA["X"], DATA["Y"])
        # -1 takes the group's size, 1: the single-device fit
        a = _est(n_shards=-1, random_state=0).fit(DATA["X"], DATA["Y"])
        b = _est(random_state=0).fit(DATA["X"], DATA["Y"])
        np.testing.assert_array_equal(a.U_, b.U_)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("sharded", [2], indirect=True, ids=["d2"])
@pytest.mark.parametrize("kw,want", [
    (None, "grid"),
    (None, "grid_tuple"),
    (dict(n_shards=(2, 1)), (ValueError, "requires shard_layout='grid'")),
    (None, "device_loop"),
    (None, "sampled"),
    (None, "chunked"),
    (None, "fp8"),
], ids=["grid", "grid_tuple", "tuple", "device_loop", "sampled",
        "chunked", "fp8"])
def test_unported_shard_requests_raise_naming_their_item(sharded, kw, want):
    """What is still refused raises (a tuple under the rows layout: the
    reference's ValueError); the grid layout (an int n_shards or a
    tuple), sampled Newton (each rank drawing the reference's columns), the
    chunked
    layout (a sparse X), fp8 data and the device loop (loop='device',
    which earlier slices refused naming ROADMAP A10c) now fit in the two
    ranks, as the reference's fits of the same request do (f64 rtol 1e-9;
    fp8: the objective within 1e-4, test_torch_fp8.py's bar)."""
    if isinstance(want, tuple):
        error, match = want
        with pytest.raises(error, match=match):
            _est(**kw).fit(DATA["X"], DATA["Y"])
        return
    d, ref, ports = sharded
    if want == "device_loop":
        _assert_fit(ports[0]["device_mu"], ref["device_mu"])
        return
    got, ref = ports[0]["request_" + want], ref["request_" + want]
    if want != "fp8":
        _assert_fit(got, ref)
        return
    assert got["n_iter"] == ref.n_iter_ == 2
    np.testing.assert_allclose(got["losses"], ref.loss_history_, rtol=1e-4)


@pytest.mark.parametrize("n_shards", [0, "two", (2, 0), True])
def test_malformed_n_shards_raise_value_error(n_shards):
    with pytest.raises(ValueError, match="not understood"):
        _est(n_shards=n_shards).fit(DATA["X"], DATA["Y"])


@pytest.mark.parametrize("kw,error,match", [
    # the grid layout is run_grid's (parallel/grid.py), not run_sharded's
    (dict(layout="grid"), ValueError, "layout must be 'rows' or 'cols'")])
def test_run_sharded_refuses_unported_layouts_and_loops(kw, error, match):
    cfg = SolverConfig(use_pallas=True)
    with pytest.raises(error, match=match):
        run_sharded("mu", DATA["X"], DATA["Y"], DATA["init"]["U"],
                    DATA["init"]["V"], DATA["init"]["Z"], cfg,
                    t_make_hyper(), n_shards=2, device="cpu", **kw)


@pytest.mark.parametrize("sharded", [2], indirect=True, ids=["d2"])
def test_run_sharded_device_loop_matches_reference(sharded):
    """run_sharded(loop='device'), which earlier slices refused naming
    ROADMAP A10c, in two ranks: its first fit and the fit that builds the
    cache entry equal the reference's CMF(loop='device', n_shards=2) fit
    of the same request (device_mu's; f64 rtol 1e-9) and each other bit
    for bit; a run
    on a new group of the same ranks finds no cache entry (the key names
    the group) and runs the key's first-fit schedule to the same result."""
    d, ref, ports = sharded
    want = ref["device_mu"]   # the same request through the estimator
    for port in ports:
        got = port["run_device"]
        first, build = got["fits"]
        assert not first["info"]["hit"] and first["info"]["eager_blocks"] == 1
        assert build["info"]["graph_launches"] == 1
        _assert_fit(first, want)
        _assert_bits(build, first)
        again, info = got["new_group"]
        assert not info["hit"] and info["eager_blocks"] == 1, info
        _assert_bits(again, first)


def _assert_bits(got, want):
    assert got["n_iter"] == want["n_iter"]
    assert got["losses"] == want["losses"]
    assert got["iters"] == want["iters"]
    for name in ("U", "V", "Z"):
        np.testing.assert_array_equal(got[name], want[name])


@pytest.mark.parametrize("sharded", [2], indirect=True, ids=["d2"])
@pytest.mark.parametrize("case", list(DEVICE))
def test_device_loop_under_shards_matches_reference_and_host_loop(sharded,
                                                                  case):
    """loop='device' over two ranks (rows): the key's first fit, the fit
    that builds the cache entry and a hit each equal the reference's
    loop='device' sharded fit (f64 rtol 1e-9, equal n_iter_) and, bit for
    bit, the port's host-loop fit, with the same COMM calls and bytes; the
    ranks take the same branch in every fit and end with the same
    factors. The sampled case draws the reference's columns itself, and
    its build and hit are one launch of the fit graph too, each block's
    keys read off the entry's device counter."""
    d, ref, ports = sharded
    for port in ports:
        host = port[case + "_host"]
        fits = port[case]["fits"]
        _assert_fit(fits[0], ref[case])
        for f in fits:
            _assert_bits(f, host)
            assert f["comm"][:2] == host["comm"][:2], (f["comm"],
                                                       host["comm"])
        first, build, hit = (f["info"] for f in fits)
        assert not first["hit"] and first["eager_blocks"] == 1
        assert first["captures"] == 1 and not build["hit"]
        assert hit["hit"] and hit["captures"] == 0 and \
            hit["eager_blocks"] == 0
        assert (hit["graph_launches"], hit["replays"]) == (1, 0)
        assert (build["graph_launches"], build["replays"]) == (1, 0)
    for other in ports[1:]:
        assert [f["info"] for f in other[case]["fits"]] == [
            f["info"] for f in ports[0][case]["fits"]]
        _assert_bits(other[case], ports[0][case])


@pytest.mark.parametrize("sharded", [2], indirect=True, ids=["d2"])
def test_ranks_agree_on_the_cache_branch(sharded):
    """fit_cache_limit 0 on rank 1 alone: rank 0 could build the cache
    entry on the key's second fit, but the ranks agree on each branch, so
    both run the first-fit schedule twice (LAST_FIT equal on every rank)
    and the results are those of the unpatched fits, bit for bit."""
    d, _, ports = sharded
    infos = [[f["info"] for f in p["device_mu_no_cache_rank1"]["fits"]]
             for p in ports]
    assert infos[0] == infos[1]
    for info in infos[0]:
        assert not info["hit"] and info["eager_blocks"] == 1 \
            and info["graph_launches"] == 0, info
    for port in ports:
        for f in port["device_mu_no_cache_rank1"]["fits"]:
            _assert_bits(f, port["device_mu"])


def test_rank_device_rule(monkeypatch):
    """cpu stays cpu, an explicit card index is kept, else LOCAL_RANK, else
    the rank modulo the visible cards."""
    assert tmesh.rank_device(3, "cpu") == torch.device("cpu")
    assert tmesh.rank_device(3, "cuda:1") == torch.device("cuda", 1)
    monkeypatch.setenv("LOCAL_RANK", "2")
    assert tmesh.rank_device(5, "cuda") == torch.device("cuda", 2)
    monkeypatch.delenv("LOCAL_RANK")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert tmesh.rank_device(5, "cuda") == torch.device("cuda", 1)


def test_torchrun_demo_runs_two_ranks():
    """The README's command: two processes under torchrun (a localhost
    rendezvous on a free port), gloo, on the CPU."""
    root = Path(__file__).resolve().parents[1]
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "pycmf_tpu_torch.parallel.demo",
         "--backend", "gloo", "--device", "cpu", "--docs", "300",
         "--terms", "400", "--max-iter", "10"],
        cwd=root, capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stderr[-2000:]
    line = [s for s in out.stdout.splitlines() if "shards:" in s]
    assert len(line) == 1 and line[0].startswith("2 shards: n_iter 10")
