"""Sampled Newton (``sg_sample_ratio`` < 1) under shards: the port's rows,
cols and grid fits against the reference's ``n_shards`` fits, on the CPU.

The reference draws its columns with ``jax.random.choice`` on a key
schedule torch cannot reproduce; the port draws through one seam,
``solvers/newton.draw_columns``, from the streams of
``parallel/sharded.Draws``. The reference's draws of every rank are
computed here from its key schedule (``tests/_shard_draws.py``) and handed
to the ranks as NumPy arrays, one list per stream (``_torch_dist.
StreamDraws``). The port's ranks run in spawned gloo groups
(``tests/_torch_dist.py``, no JAX), one spawn of 2 ranks (rows and cols at
d = 2, the grid (2, 1)) and one of 4 (rows and cols at d = 4, the grid
(2, 2)), started before the reference's fits and joined after them. n = 31
and m = 41 pad both axes.

Tolerances: float64 rtol 1e-9 on factors (atol 1e-12), loss histories and
transforms, equal n_iter_ and loss_iters_, every rank's result equal bit
for bit. Without injected draws: the same seed gives the same fit bit for
bit, another seed another fit; two ranks' own-stream draws differ and
their shared-stream draws are equal.
"""
import warnings

import numpy as np
import pytest
import torch

from pycmf_tpu import CMF as JCMF
from pycmf_tpu_torch.parallel.sharded import make_draws, stream_seed
from tests._shard_draws import rank_draws
from tests._torch_dist import run_cases, spawn
from tests.conftest import make_problem

K = 3
N, M = 31, 41
RATIO = 0.5
BASE = dict(n_components=K, tol=1e-7, eval_every=3, dtype="float64",
            random_state=0, use_pallas=True, solver="newton",
            sg_sample_ratio=RATIO)


def _data():
    rng = np.random.RandomState(41)
    X, Y = make_problem(rng, n=N, m=M)
    Xs = make_problem(np.random.RandomState(42), n=N, m=M, sparse=True)[0]
    Xn = make_problem(np.random.RandomState(43), n=9, m=M)[0]
    init = dict(U=np.abs(rng.randn(N, K)), V=np.abs(rng.randn(M, K)),
                Z=np.abs(rng.randn(Y.shape[1], K)))
    return dict(X=X, Y=Y, Xs=Xs, Yb=(Y > np.median(Y)).astype(float), Xn=Xn,
                Un=np.abs(rng.randn(9, K)), init=init)


DATA = _data()

# name: (estimator kwargs, X, Y)
CASES = {
    "dense": (dict(max_iter=6), "X", "Y"),
    "csr": (dict(max_iter=6, sparse_mode="csr"), "Xs", "Y"),
    "sigmoid_y": (dict(max_iter=6, y_link="sigmoid"), "X", "Yb"),
}
# mesh name: (layout, mesh, ranks of its spawn)
MESHES = {
    "rows_d2": ("rows", (2,)), "cols_d2": ("cols", (2,)),
    "grid_2x1": ("grid", (2, 1)),
    "rows_d4": ("rows", (4,)), "cols_d4": ("cols", (4,)),
    "grid_2x2": ("grid", (2, 2)),
}


def _world(mesh):
    return int(np.prod(MESHES[mesh][1]))


def _kw(mesh, case, **extra):
    layout, shape = MESHES[mesh]
    kw = dict(BASE, **CASES[case][0], shard_layout=layout,
              n_shards=shape if layout == "grid" else shape[0])
    return dict(kw, **extra)


def _args(case):
    _, x, y = CASES[case]
    return DATA[x], DATA[y]


def _draws(mesh, case, transform=False):
    layout, shape = MESHES[mesh]
    kw = _kw(mesh, case)
    X, Y = _args(case)
    return rank_draws(layout, shape, seed=kw["random_state"],
                      n_iter=kw["max_iter"], n=N, m=M, ry=Y.shape[1],
                      ratio=RATIO,
                      transform_iters=kw["max_iter"] if transform else 0)


def _port_cases(world):
    cases = {}
    for mesh in MESHES:
        if _world(mesh) != world:
            continue
        for case in CASES:
            X, Y = _args(case)
            transform = world == 2 and case == "dense"
            c = dict(kind="fit", kw=_kw(mesh, case), X=X, Y=Y,
                     init=DATA["init"], seed=BASE["random_state"],
                     rank_draws=_draws(mesh, case, transform))
            if transform:
                c.update(Xn=DATA["Xn"], Un=DATA["Un"])
            cases[f"{mesh}/{case}"] = c
    if world == 2:
        # the port's own draws, recorded: rows and the grid (2, 1), and the
        # same fit again and under another seed
        for mesh in ("rows_d2", "grid_2x1"):
            for tag, seed in (("seed0", 0), ("seed0_again", 0),
                              ("seed1", 1)):
                cases[f"{mesh}/record/{tag}"] = dict(
                    kind="fit", kw=_kw(mesh, "sigmoid_y", random_state=seed),
                    X=DATA["X"], Y=DATA["Yb"], init=DATA["init"],
                    record=True)
    return cases


_RESULTS = {}


def _run_all(tmp_path_factory):
    """Both spawns at once, the reference's fits while they run: {world:
    (the reference's results, each rank's results)}. Computed once per
    module, whatever order pytest takes the parametrized tests in."""
    if _RESULTS:
        return _RESULTS
    spawns = {w: spawn(run_cases, w, tmp_path_factory.mktemp(f"sampled{w}"),
                       _port_cases(w)) for w in (2, 4)}
    ref = {}
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            for mesh in MESHES:
                for case in CASES:
                    est = JCMF(**_kw(mesh, case))
                    est.fit(*_args(case), **DATA["init"])
                    ref[f"{mesh}/{case}"] = est
                    if _world(mesh) == 2 and case == "dense":
                        ref[f"{mesh}/transform"] = est.transform(
                            DATA["Xn"], U=DATA["Un"])
    finally:
        ports = {w: s.join() for w, s in spawns.items()}
    _RESULTS.update({w: (ref, ports[w]) for w in ports})
    return _RESULTS


@pytest.fixture(params=[2, 4], ids=["ranks2", "ranks4"])
def sampled(request, tmp_path_factory):
    """(world, the reference's results, each rank's results)."""
    ref, ports = _run_all(tmp_path_factory)[request.param]
    return request.param, ref, ports


def _assert_fit(got, want):
    assert got["n_iter"] == want.n_iter_
    assert got["iters"] == list(want.loss_iters_)
    np.testing.assert_allclose(got["losses"], want.loss_history_, rtol=1e-9)
    for name in ("U", "V", "Z"):
        np.testing.assert_allclose(got[name], getattr(want, name + "_"),
                                   rtol=1e-9, atol=1e-12)


_FITS = [(_world(mesh), mesh, case) for mesh in MESHES for case in CASES]


@pytest.mark.parametrize("sampled,mesh,case", _FITS, indirect=["sampled"],
                         ids=[f"{m}-{c}" for _, m, c in _FITS])
def test_sampled_fit_matches_reference_f64(sampled, mesh, case):
    """Each layout and mesh on dense, CSR (masked draws) and sigmoid-Y data,
    with every rank's reference draws injected."""
    _, ref, ports = sampled
    _assert_fit(ports[0][f"{mesh}/{case}"], ref[f"{mesh}/{case}"])


@pytest.mark.parametrize("sampled", [2], indirect=True, ids=["ranks2"])
@pytest.mark.parametrize("mesh", ["rows_d2", "cols_d2", "grid_2x1"])
def test_sampled_transform_matches_reference_f64(sampled, mesh):
    """transform after a sampled fit folds in by rows over every rank, its
    U terms drawn from each rank's own stream as the reference folds kU
    with the shard index: 9 new rows."""
    _, ref, ports = sampled
    np.testing.assert_allclose(ports[0][f"{mesh}/dense"]["transform"],
                               ref[f"{mesh}/transform"], rtol=1e-9,
                               atol=1e-12)


def test_every_rank_returns_the_same_result(sampled):
    """Replicated factors stay bit for bit equal on every rank: the ranks
    sharing a replica draw alike from their common stream."""
    world, _, ports = sampled
    assert len(ports) == world
    for name, a in ports[0].items():
        for other in ports[1:]:
            b = other[name]
            assert a["n_iter"] == b["n_iter"] and a["losses"] == b["losses"]
            for key in ("U", "V", "Z", "transform"):
                if key in a:
                    np.testing.assert_array_equal(a[key], b[key])


@pytest.mark.parametrize("sampled", [2], indirect=True, ids=["ranks2"])
@pytest.mark.parametrize("mesh", ["rows_d2", "grid_2x1"])
def test_same_seed_same_fit_other_seed_another(sampled, mesh):
    """The port's own draws (no injection): random_state 0 twice gives the
    same fit bit for bit, random_state 1 (the same initial factors)
    another."""
    _, _, ports = sampled
    a, b, c = (ports[0][f"{mesh}/record/{t}"]
               for t in ("seed0", "seed0_again", "seed1"))
    assert a["losses"] == b["losses"]
    for key in ("U", "V", "Z"):
        np.testing.assert_array_equal(a[key], b[key])
    assert a["losses"] != c["losses"] and not np.array_equal(a["U"], c["U"])


@pytest.mark.parametrize("sampled", [2], indirect=True, ids=["ranks2"])
@pytest.mark.parametrize("mesh", ["rows_d2", "grid_2x1"])
def test_own_draws_differ_shared_draws_equal(sampled, mesh):
    """Two ranks draw the same columns from the stream they share (rows:
    Z's term and V's Y term; the grid (2, 1), one mesh column: U's and
    Z's terms and V's Y term) and different ones from their own (U's and
    V's X terms; V's X term)."""
    _, _, ports = sampled
    calls = [p[f"{mesh}/record/seed0"]["draws"] for p in ports]
    shared = stream_seed(0) if mesh == "rows_d2" else stream_seed(0, 1, 0)
    own = ([stream_seed(0, 0, r) for r in (0, 1)] if mesh == "rows_d2"
           else [stream_seed(0, 2, i, 0) for i in (0, 1)])
    per = [{s: [idx for seed, idx in c if seed == s] for s in (shared, o)}
           for c, o in zip(calls, own)]
    assert len(per[0][shared]) == len(per[1][shared]) > 0
    for a, b in zip(per[0][shared], per[1][shared]):
        np.testing.assert_array_equal(a, b)
    a, b = per[0][own[0]], per[1][own[1]]
    assert len(a) == len(b) > 0
    assert any(not np.array_equal(x, y) for x, y in zip(a, b))


def test_stream_seeds_and_generators():
    """The shared stream is the single device's seed; keyed streams get
    distinct 63-bit seeds, the same on every call; make_draws seeds its
    two generators with them."""
    assert stream_seed(7) == 7
    keys = [(0, 0), (0, 1), (1, 0), (2, 0, 0), (2, 1, 0), (2, 0, 1)]
    seeds = [stream_seed(7, *k) for k in keys]
    assert len(set(seeds)) == len(keys) and all(0 <= s < 2 ** 63
                                                for s in seeds)
    assert seeds == [stream_seed(7, *k) for k in keys]
    assert stream_seed(8, 0, 0) != seeds[0]
    d = make_draws(7, "cpu", (1, 0), (2, 1, 0))
    assert d.common.initial_seed() == stream_seed(7, 1, 0)
    assert d.own.initial_seed() == stream_seed(7, 2, 1, 0)
    assert d.own.device == torch.device("cpu")
