"""The port's grid-sharded CMF (``n_shards=(r, c), shard_layout='grid'``, one
process per cell on torch.distributed) against the reference's (``shard_map``
over a 2-D mesh of JAX's virtual CPU devices), on the CPU; then fp8 data
under every sharded layout.

As in ``test_torch_sharded_cols.py``: the reference runs in this process,
the port in r·c spawned gloo ranks (``tests/_torch_dist.py``), one spawn per
mesh, started before the reference's fits and joined after them, with the
same NumPy data and the same U0, V0, Z0. n = 31 rows and m = 41 columns pad
both axes: one padding row on the last row block of a (2, ·) mesh, one
padding column on the last column block of a (·, 2) mesh. The (2, 1) spawn
also fits ``n_shards=2`` as an int (the mesh (1, 2)) and the fp8 cases.

Tolerances: float64 rtol 1e-9 on factors (atol 1e-12), loss histories and
transforms, equal n_iter_ and loss_iters_; every rank's result equal bit for
bit. fp8 (float32 factors, e4m3 X): the objective within 1e-4 of the
reference's sharded fp8 fit at every eval point (the bar of
``test_torch_fp8.py``), and the port's fp8 fit equal bit for bit to its bf16
fit of X quantized to e4m3.
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from pycmf_tpu import CMF as JCMF
from pycmf_tpu.parallel.grid import _prepare_grid as j_prepare_grid
from pycmf_tpu_torch import CMF
from pycmf_tpu_torch.parallel.grid import factor_grid, grid_cell
from pycmf_tpu_torch.utils.validation import as_coupled
from tests._torch_dist import run_cases, spawn
from tests.conftest import make_problem

K = 4
N, M = 31, 41
BASE = dict(n_components=K, tol=1e-7, eval_every=5, dtype="float64",
            random_state=0, use_pallas=True, shard_layout="grid")
SIGNED = dict(U_non_negative=False, V_non_negative=False,
              Z_non_negative=False)


def _quantized(A):
    return torch.from_numpy(np.asarray(A, dtype=np.float64)).to(
        torch.float8_e4m3fn).to(torch.float64).numpy()


def _data():
    rng = np.random.RandomState(27)
    X, Y = make_problem(rng, n=N, m=M)
    Xs = make_problem(np.random.RandomState(28), n=N, m=M, sparse=True)[0]
    Xn = make_problem(np.random.RandomState(29), n=13, m=M)[0]
    init = dict(U=np.abs(rng.randn(N, K)), V=np.abs(rng.randn(M, K)),
                Z=np.abs(rng.randn(Y.shape[1], K)))
    Yb = (Y > np.median(Y)).astype(float)
    return dict(X=X, Y=Y, Xs=Xs, Xb=(X > np.median(X)).astype(float),
                Xq=_quantized(X), Yb=Yb, Ybs=sp.csr_matrix(Yb),
                Ys=sp.csr_matrix(
                    Y * (np.random.RandomState(30).rand(*Y.shape) > 0.6)),
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
GRIDS = {"g2x2": (2, 2), "g2x1": (2, 1)}

# fp8 X under every sharded layout in the two-rank spawn, each against the
# reference's fit of the same request (float32 factors, the depths of
# test_torch_fp8.py's objective-gap test): name: (layout kwargs, solver
# kwargs)
FP8_BASE = dict(n_components=K, tol=0.0, dtype="float32", random_state=0,
                data_dtype="fp8")
FP8 = {
    "fp8_rows_mu": (dict(n_shards=2), dict(solver="mu", max_iter=10,
                                           eval_every=5)),
    "fp8_rows_newton": (dict(n_shards=2), dict(solver="newton", max_iter=1,
                                               eval_every=1)),
    "fp8_cols_mu": (dict(n_shards=2, shard_layout="cols"),
                    dict(solver="mu", max_iter=10, eval_every=5)),
    "fp8_grid_mu": (dict(n_shards=(2, 1), shard_layout="grid"),
                    dict(solver="mu", max_iter=10, eval_every=5)),
}


def _kw(name):
    kw, _, _ = CASES[name]
    return dict(BASE, **kw)


def _fit_args(name):
    _, x, y = CASES[name]
    return DATA[x], DATA[y]


def _fp8_kw(name, use_pallas=True):
    layout, solver = FP8[name]
    return dict(FP8_BASE, use_pallas=use_pallas, **layout, **solver)


def _port_cases(grid):
    cases = {}
    for name in CASES:
        X, Y = _fit_args(name)
        case = dict(kind="fit", kw=dict(_kw(name), n_shards=grid), X=X, Y=Y,
                    init=DATA["init"])
        if name == "mu_dense":  # and the fold-in of new rows after it
            case.update(Xn=DATA["Xn"], Un=DATA["Un"])
        cases[name] = case
    if grid == (2, 1):
        cases["grid_meshes"] = dict(kind="grid_meshes",
                                    shapes=[(2, 1), (1, 2)])
        cases["mu_dense_int"] = dict(
            kind="fit", kw=dict(_kw("mu_dense"), n_shards=2), X=DATA["X"],
            Y=DATA["Y"], init=DATA["init"])
        for name in FP8:
            cases[name] = dict(kind="fit", kw=_fp8_kw(name), X=DATA["X"],
                               Y=DATA["Y"], init=DATA["init"])
        # the bf16 fit of the quantized X, for the fp8 fit's bit equality
        kw = dict(_fp8_kw("fp8_rows_mu"), data_dtype="bfloat16")
        cases["bf16_rows_mu_quantized"] = dict(
            kind="fit", kw=kw, X=DATA["Xq"], Y=DATA["Y"], init=DATA["init"])
    return cases


@pytest.fixture(scope="module", params=list(GRIDS))
def gridded(request, tmp_path_factory):
    """(grid, the reference's results, each rank's results): the port's
    ranks run while the reference fits."""
    grid = GRIDS[request.param]
    r, c = grid
    ranks = spawn(run_cases, r * c,
                  tmp_path_factory.mktemp(f"grid{r}x{c}"), _port_cases(grid))
    ref = {}
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            for name in CASES:
                est = JCMF(n_shards=grid, **_kw(name))
                est.fit(*_fit_args(name), **DATA["init"])
                ref[name] = est
            if grid == (2, 1):
                est = JCMF(n_shards=2, **_kw("mu_dense"))
                ref["mu_dense_int"] = est.fit(*_fit_args("mu_dense"),
                                              **DATA["init"])
                for name in FP8:
                    # the reference's default branch on the CPU
                    ref[name] = JCMF(**_fp8_kw(name, None)).fit(
                        DATA["X"], DATA["Y"], **DATA["init"])
        ref["transformed"] = ref["mu_dense"].transform(DATA["Xn"],
                                                       U=DATA["Un"])
    finally:
        ports = ranks.join()
    return grid, ref, ports


def _assert_fit(got, want):
    assert got["n_iter"] == want.n_iter_
    assert got["iters"] == list(want.loss_iters_)
    np.testing.assert_allclose(got["losses"], want.loss_history_, rtol=1e-9)
    for name in ("U", "V", "Z"):
        np.testing.assert_allclose(got[name], getattr(want, name + "_"),
                                   rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("case", list(CASES))
def test_grid_fit_matches_reference_f64(gridded, case):
    grid, ref, ports = gridded
    _assert_fit(ports[0][case], ref[case])


def test_grid_transform_matches_reference_f64(gridded):
    """transform after a grid fit folds in by rows over every rank (U's
    update alone), as the reference's does: 13 new rows."""
    grid, ref, ports = gridded
    np.testing.assert_allclose(ports[0]["mu_dense"]["transform"],
                               ref["transformed"], rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("case", SINGLE)
def test_grid_fit_matches_port_single_device(gridded, case):
    grid, _, ports = gridded
    kw = dict(_kw(case))
    kw.pop("shard_layout")
    est = CMF(device="cpu", **kw)
    est.fit(*_fit_args(case), **DATA["init"])
    _assert_fit(ports[0][case], est)


def test_every_rank_returns_the_same_result(gridded):
    """Every rank ends with the same factors: U gathered over the mesh
    columns, V over the mesh rows, and Z, which each mesh row computes
    from its own sums, identical on all of them."""
    grid, _, ports = gridded
    assert len(ports) == grid[0] * grid[1]
    fits = [name for name, got in ports[0].items() if "losses" in got]
    assert len(fits) >= len(CASES)
    for name in fits:
        for other in ports[1:]:
            a, b = ports[0][name], other[name]
            assert a["n_iter"] == b["n_iter"] and a["losses"] == b["losses"]
            for key in ("U", "V", "Z", "transform"):
                if key in a:
                    np.testing.assert_array_equal(a[key], b[key])


@pytest.mark.parametrize("gridded", ["g2x1"], indirect=True)
def test_int_n_shards_resolves_through_factor_grid(gridded):
    """n_shards=2 under the grid layout is the mesh factor_grid(2) = (1, 2),
    as in the reference."""
    assert factor_grid(2) == (1, 2) and factor_grid(12) == (3, 4)
    assert CMF(n_shards=6, shard_layout="grid")._resolve_grid() == (2, 3)
    grid, ref, ports = gridded
    _assert_fit(ports[0]["mu_dense_int"], ref["mu_dense_int"])


@pytest.mark.parametrize("gridded", ["g2x1"], indirect=True)
def test_axis_groups_kept_per_shape_and_one_rank_axes_call_nothing(gridded):
    """Two ranks switching between the meshes (2, 1) and (1, 2) of one
    group get each shape's first axis groups back (no new communicators
    per switch); on (2, 1) the ROW axis sums the two ranks and the COL
    axis, of one rank, returns the rank's own tensor with no collective."""
    _, _, ports = gridded
    for rank, port in enumerate(ports):
        got = port["grid_meshes"]
        assert got["reused"] == [True, True]
        assert got["sums"] == {"row": [3.0] * 3, "col": [rank + 1.0] * 3}
        assert got["by_axis"] == {"rows": [1, 24]}


@pytest.mark.parametrize("gridded", ["g2x1"], indirect=True)
@pytest.mark.parametrize("case", list(FP8))
def test_fp8_sharded_fit_matches_reference(gridded, case):
    """data_dtype='fp8' in the rows (K1's and K2's e4m3 forms per shard),
    cols and grid layouts: objective within 1e-4 of the reference's
    sharded fp8 fit at every eval point."""
    grid, ref, ports = gridded
    got, want = ports[0][case], ref[case]
    assert got["n_iter"] == want.n_iter_
    assert all(np.isfinite(got["losses"]))
    gap = np.abs(np.subtract(got["losses"], want.loss_history_)) \
        / np.asarray(want.loss_history_)
    assert gap.max() < 1e-4


@pytest.mark.parametrize("gridded", ["g2x1"], indirect=True)
def test_fp8_rows_fit_equals_bf16_fit_of_quantized_x(gridded):
    """Each shard stores e4m3 X, its norms those of the stored values: the
    sharded fp8 fit is the sharded bf16 fit of X quantized, bit for bit."""
    grid, _, ports = gridded
    a, b = ports[0]["fp8_rows_mu"], ports[0]["bf16_rows_mu_quantized"]
    assert a["losses"] == b["losses"] and a["n_iter"] == b["n_iter"]
    for key in ("U", "V", "Z"):
        np.testing.assert_array_equal(a[key], b[key])


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "csr"])
def test_grid_cells_pad_like_the_reference(sparse):
    """Cell (i, j) of a 2×2 mesh on 31×41 (both axes padded): its values,
    real rows and columns, and the partial norms as_coupled gives it,
    against the reference's _prepare_grid (its padded X, masks, rsq_u,
    rsq_v)."""
    X = DATA["Xs"] if sparse else DATA["X"]
    U0, V0 = DATA["init"]["U"], DATA["init"]["V"]
    ops, _, _, n, m = j_prepare_grid(X, None, U0, V0, 2, 2, jnp.float64)
    Xd = np.asarray(X.toarray() if sparse else X)
    n_loc, m_loc = 16, 21
    want_x = np.zeros((2 * n_loc, 2 * m_loc))
    want_x[:N, :M] = Xd
    if not sparse:
        np.testing.assert_array_equal(np.asarray(ops.X), want_x)
    nmask, mmask = np.asarray(ops.nmask), np.asarray(ops.mmask)
    for i in range(2):
        for j in range(2):
            cell, n_valid, m_valid = grid_cell(X, n_loc, m_loc, i, j)
            assert sp.issparse(cell) == sparse and cell.shape == (n_loc,
                                                                  m_loc)
            dense = cell.toarray() if sparse else cell
            rows, cols = slice(i * n_loc, (i + 1) * n_loc), \
                slice(j * m_loc, (j + 1) * m_loc)
            np.testing.assert_array_equal(dense, want_x[rows, cols])
            assert n_valid == nmask[rows].sum() and m_valid == mmask[
                cols].sum()
            c = as_coupled(cell, torch.float64, "cpu", sparse_mode="csr")
            np.testing.assert_allclose(c.row_sq.numpy(),
                                       np.asarray(ops.rsq_u)[rows, j],
                                       rtol=1e-12, atol=1e-14)
            np.testing.assert_allclose(c.row_sq_t.numpy(),
                                       np.asarray(ops.rsq_v)[cols, i],
                                       rtol=1e-12, atol=1e-14)
    assert (n_valid, m_valid) == (N - n_loc, M - m_loc)


# -- in this process: refusals ------------------------------------------------

def _est(**kw):
    return CMF(device="cpu", n_components=2, max_iter=2, shard_layout="grid",
               **kw)


# requests earlier slices refused and this one fits on the mesh (2, 1), each
# held to the reference's fit of the same request: sampled Newton (each
# rank drawing the reference's columns), the chunked layout (a sparse X) and the
# device loop (MU on the chunked layout, its first fit, the fit that builds
# the cache entry and a hit, beside its host-loop twin)
REQUEST = dict(n_components=2, max_iter=2, random_state=0, n_shards=(2, 1),
               shard_layout="grid", dtype="float64")
DEVICE_KW = dict(REQUEST, sparse_mode="chunked", max_iter=9, eval_every=2,
                 tol=1e-7)
NOW_FIT = {"sampled": (dict(REQUEST, solver="newton", sg_sample_ratio=0.5),
                       "X"),
           "chunked": (dict(REQUEST, sparse_mode="chunked"), "Xs"),
           "device_loop": (dict(DEVICE_KW, loop="device"), "Xs")}
_NOW_FIT_RESULTS = {}


def _now_fit(tmp_path_factory):
    """{name: (every rank's result, the reference's fit)}: one two-rank
    spawn for the requests (and the device loop's host-loop twin), the
    reference's fits while it runs; once per module."""
    if _NOW_FIT_RESULTS:
        return _NOW_FIT_RESULTS
    cases = {}
    for name, (kw, x) in NOW_FIT.items():
        cases[name] = dict(kind="fit", kw=kw, X=DATA[x], Y=DATA["Y"])
    cases["device_loop"]["repeat"] = 3
    cases["device_host"] = dict(cases["device_loop"],
                                kw=dict(DEVICE_KW, loop="host"))
    ranks = spawn(run_cases, 2, tmp_path_factory.mktemp("grid_requests"),
                  cases)
    try:
        ref = {name: JCMF(**kw).fit(DATA[x], DATA["Y"])
               for name, (kw, x) in NOW_FIT.items()}
    finally:
        ports = ranks.join()
    for name in NOW_FIT:
        assert ports[0][name]["losses"] == ports[1][name]["losses"]
        _NOW_FIT_RESULTS[name] = ([p[name] for p in ports], ref[name])
    _NOW_FIT_RESULTS["device_host"] = ([p["device_host"] for p in ports],
                                       None)
    return _NOW_FIT_RESULTS


@pytest.mark.parametrize("kw", [
    "device_loop",
    "sampled",
    "chunked",
], ids=["device_loop", "sampled", "chunked"])
def test_grid_unported_requests_raise_naming_a10c(kw, tmp_path_factory):
    """Requests earlier slices refused naming A10c fit on the mesh (2, 1)
    in two ranks as the reference's grid fits of the same request do (f64
    rtol 1e-9, every rank's losses equal): sampled Newton, the chunked
    layout, and the device loop (loop='device', MU on chunked cells,
    against the reference's loop='device' grid fit)."""
    got, want = _now_fit(tmp_path_factory)[kw]
    assert want.n_iter_ == (2 if kw != "device_loop" else got[0]["n_iter"])
    _assert_fit(got[0], want)


def test_grid_device_loop_matches_host_loop_bit_for_bit(tmp_path_factory):
    """On the mesh (2, 1), chunked MU: the device loop's first fit, the fit
    that builds the cache entry and a hit each equal the port's host-loop
    grid fit bit for bit, with the same COMM calls and bytes per axis; the
    ranks take the same branch, and a captured block holds the same
    all-reduces on every rank (the ROW axis's sums and the world loss; the
    one-rank COL axis makes none)."""
    ports, _ = _now_fit(tmp_path_factory)["device_loop"]
    hosts, _ = _now_fit(tmp_path_factory)["device_host"]
    for port, host in zip(ports, hosts):
        for f in port["fits"]:
            assert f["n_iter"] == host["n_iter"]
            assert f["losses"] == host["losses"]
            for key in ("U", "V", "Z"):
                np.testing.assert_array_equal(f[key], host[key])
            assert f["comm"] == host["comm"]
        first, build, hit = (f["info"] for f in port["fits"])
        assert (first["eager_blocks"], first["captures"],
                build["graph_launches"], hit["hit"],
                hit["graph_launches"]) == (1, 1, 1, True, 1)
        assert set(host["comm"][2]) == {"grid", "rows"}
    infos = [[f["info"] for f in p["fits"]] for p in ports]
    assert infos[0] == infos[1] and infos[0][0]["collectives"] > 0


@pytest.mark.parametrize("layout", ["rows", "cols"])
def test_tuple_under_another_layout_raises_the_reference_error(layout):
    """The reference's ValueError, from both packages."""
    for cls in (lambda **kw: CMF(device="cpu", **kw), JCMF):
        with pytest.raises(ValueError, match="requires shard_layout='grid'"):
            cls(n_components=2, max_iter=2, n_shards=(2, 1),
                shard_layout=layout).fit(DATA["X"], DATA["Y"])


@pytest.fixture
def world1(tmp_path):
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        yield dist
    finally:
        dist.destroy_process_group()


def test_grid_mesh_axis_groups_made_once(world1):
    """make_grid_mesh on a one-rank group: the world and both axis meshes
    at (0, 0), each axis named for COMM; the axis subgroups made once per
    parent group and shape (a fit does not make new communicators); an
    all-reduce on a one-rank axis returns its tensor and calls nothing;
    the group's size held to rows·cols as make_mesh holds it."""
    from pycmf_tpu_torch.parallel import mesh as tmesh

    a = tmesh.make_grid_mesh(1, 1, device="cpu")
    b = tmesh.make_grid_mesh(1, 1, device="cpu")
    assert (a.i, a.j, a.rows, a.cols) == (0, 0, 1, 1)
    assert (a.world.axis, a.row.axis, a.col.axis) == (
        tmesh.GRID_AXIS, tmesh.ROW_AXIS, tmesh.COL_AXIS)
    assert a.row.group is b.row.group and a.col.group is b.col.group
    assert a.row.group is not a.col.group
    # an axis of one rank sums nothing: no collective, nothing counted;
    # the world mesh keeps its call
    tmesh.COMM.reset()
    x = torch.ones(3, dtype=torch.float64)
    assert tmesh.all_reduce(a.row, x)[0] is x
    assert torch.equal(tmesh.all_reduce(a.col, torch.ones(2))[0],
                       torch.ones(2))
    tmesh.all_reduce(a.world, torch.ones(1))
    assert tmesh.COMM.by_axis == {"grid": [1, 4]} and tmesh.COMM.calls == 1
    with pytest.raises(ValueError, match="requested 2 devices but the "
                                         "process group has 1"):
        tmesh.make_grid_mesh(2, 1, device="cpu")


def test_grid_one_rank_equals_single_device(world1):
    """run_grid at (1, 1) on a one-rank group is the single-device fit's
    arithmetic up to the order of sums: equal n_iter and f64 agreement.
    (The estimator takes n_shards = 1 as the single-device fit.)"""
    from pycmf_tpu_torch.parallel.grid import run_grid
    from pycmf_tpu_torch.solvers.common import make_hyper

    kw = dict(_kw("newton_sigmoid_y"))
    kw.pop("shard_layout")
    b = CMF(device="cpu", **kw)
    b.fit(*_fit_args("newton_sigmoid_y"), **DATA["init"])
    U, V, Z, n_iter, losses, _, _ = run_grid(
        "newton", *_fit_args("newton_sigmoid_y"),
        *(DATA["init"][c] for c in "UVZ"), b._config(has_Y=True),
        make_hyper(dtype=torch.float64), grid=(1, 1), dtype=torch.float64,
        device="cpu", max_iter=b.max_iter, tol=b.tol,
        eval_every=b.eval_every)
    assert n_iter == b.n_iter_
    np.testing.assert_allclose(losses, b.loss_history_, rtol=1e-9)
    for got, want in ((U, b.U_), (V, b.V_), (Z, b.Z_)):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-9, atol=1e-12)


def test_grid_refusals_past_the_threshold(world1, monkeypatch):
    """A cell past the densify threshold: a sigmoid-linked X under Newton,
    which earlier slices refused there, takes a chunked cell under 'auto',
    and a sigmoid-linked sparse Y its chunked carrier; each (1, 1) fit
    builds its chunked layout and equals the reference's run_grid at the
    same threshold (f64 rtol 1e-9). Still refused: fp8 data on a cell that
    stays sparse (the reference's ValueError); a linear-linked sparse Y is
    densified with the reference's warning."""
    import jax

    from pycmf_tpu.parallel.grid import run_grid as j_run_grid
    from pycmf_tpu.solvers import common as jcommon
    from pycmf_tpu.utils import validation as jvalidation
    from pycmf_tpu_torch.parallel import grid, sharded
    from pycmf_tpu_torch.solvers.common import SolverConfig, make_hyper
    from pycmf_tpu_torch.utils import validation

    U, V, Z = (DATA["init"][c] for c in "UVZ")
    hyper = make_hyper(dtype=torch.float64)
    kw = dict(grid=(1, 1), dtype=torch.float64, device="cpu", max_iter=1)
    monkeypatch.setattr(sharded, "DENSIFY_THRESHOLD", 8)
    monkeypatch.setattr(jvalidation, "DENSIFY_THRESHOLD", 8)
    built, make = [], validation.chunked_from_scipy
    monkeypatch.setattr(validation, "chunked_from_scipy", lambda A, *a, **k: (
        built.append(A.shape), make(A, *a, **k))[1])
    signed = dict(U_non_negative=False, V_non_negative=False,
                  Z_non_negative=False)
    run = dict(max_iter=4, tol=1e-7, eval_every=2)
    for X, Y, link, shape in (
            (sp.csr_matrix(DATA["Xb"]), DATA["Y"], dict(x_link="sigmoid"),
             (N, M)),
            (DATA["X"], DATA["Ybs"], dict(y_link="sigmoid"),
             DATA["Ybs"].shape)):
        built.clear()
        got = grid.run_grid("newton", X, Y, U, V, Z, SolverConfig(
            use_pallas=True, **link, **signed), hyper, grid=(1, 1),
            dtype=torch.float64, device="cpu", **run)
        assert built == [shape]
        want = j_run_grid(X, Y, U, V, Z, jcommon.SolverConfig(
            **link, **signed), jcommon.make_hyper(dtype=jnp.float64),
            grid=(1, 1), dtype=jnp.float64, solver="newton",
            rng=jax.random.PRNGKey(0), **run)
        assert got[3] == int(want[3]) and list(got[5]) == list(want[5])
        np.testing.assert_allclose(got[4], np.asarray(want[4]), rtol=1e-9)
        for g, w in zip(got[:3], want[:3]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-9,
                                       atol=1e-12)
    with pytest.raises(ValueError, match="dense device cells"):
        grid.run_grid("mu", DATA["Xs"], DATA["Y"], U, V, Z, SolverConfig(),
                      hyper, data_dtype=torch.float8_e4m3fn, **kw)
    with pytest.warns(UserWarning, match="LINEAR-linked sparse Y"):
        grid.run_grid("mu", DATA["X"], DATA["Ys"], U, V, Z, SolverConfig(),
                      hyper, **kw)


def test_torchrun_demo_runs_a_2x2_grid():
    """The README's command with --layout grid --grid 2 2: four processes
    under torchrun (a localhost rendezvous on a free port), gloo, on the
    CPU, against the single-device fit."""
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m", "pycmf_tpu_torch.parallel.demo",
         "--backend", "gloo", "--device", "cpu", "--docs", "300",
         "--terms", "400", "--max-iter", "10", "--layout", "grid",
         "--grid", "2", "2"],
        cwd=root, capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stderr[-2000:]
    line = [s for s in out.stdout.splitlines() if "shards:" in s]
    assert len(line) == 1 and line[0].startswith("4 shards: n_iter 10")
    assert line[0].endswith("layout grid 2x2")
    loss, single = (float(p.split("loss ")[1].split(";")[0])
                    for p in line[0].split("one device"))
    assert abs(loss - single) <= 1e-4 * single
