"""Sampled Newton (``sg_sample_ratio`` < 1) under shards: the port's rows,
cols and grid fits against the reference's ``n_shards`` fits, on the CPU.

Both packages draw the reference's columns (``jax.random``'s Threefry key
schedule; the port's ``ops/random.py``), each rank's keys folded with its
mesh coordinates as the reference folds them (``parallel/sharded.
rank_keys``, ``solvers/newton.term_key``), so the fits are compared with
nothing injected. The port's ranks run in spawned gloo groups
(``tests/_torch_dist.py``, no JAX), one spawn of 2 ranks (rows and cols at
d = 2, the grid (2, 1)) and one of 4 (rows and cols at d = 4, the grid
(2, 2)), started before the reference's fits and joined after them. n = 31
and m = 41 pad both axes.

Tolerances: float64 rtol 1e-9 on factors (atol 1e-12), loss histories and
transforms, equal n_iter_ and loss_iters_, every rank's result equal bit
for bit; the same seed gives the same fit bit for bit, another seed
another fit. The per-rank key folds are held to the reference's key
schedule here in the test process: every term's key of every rank equal.
"""
import warnings

import jax
import numpy as np
import pytest
import torch

from pycmf_tpu import CMF as JCMF
from pycmf_tpu_torch.ops import random as trandom
from pycmf_tpu_torch.parallel.sharded import key_stream, rank_keys
from pycmf_tpu_torch.solvers.common import SolverConfig
from pycmf_tpu_torch.solvers.newton import term_key
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


def _port_cases(world):
    cases = {}
    for mesh in MESHES:
        if _world(mesh) != world:
            continue
        for case in CASES:
            X, Y = _args(case)
            transform = world == 2 and case == "dense"
            c = dict(kind="fit", kw=_kw(mesh, case), X=X, Y=Y,
                     init=DATA["init"])
            if transform:
                c.update(Xn=DATA["Xn"], Un=DATA["Un"])
            cases[f"{mesh}/{case}"] = c
    if world == 2:
        # rows and the grid (2, 1): the same fit again and under another
        # seed
        for mesh in ("rows_d2", "grid_2x1"):
            for tag, seed in (("seed0", 0), ("seed0_again", 0),
                              ("seed1", 1)):
                cases[f"{mesh}/record/{tag}"] = dict(
                    kind="fit", kw=_kw(mesh, "sigmoid_y", random_state=seed),
                    X=DATA["X"], Y=DATA["Yb"], init=DATA["init"])
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
    every rank drawing its own columns: the reference's."""
    _, ref, ports = sampled
    _assert_fit(ports[0][f"{mesh}/{case}"], ref[f"{mesh}/{case}"])


@pytest.mark.parametrize("sampled", [2], indirect=True, ids=["ranks2"])
@pytest.mark.parametrize("mesh", ["rows_d2", "cols_d2", "grid_2x1"])
def test_sampled_transform_matches_reference_f64(sampled, mesh):
    """transform after a sampled fit folds in by rows over every rank, its
    U term's key folded with the rank as the reference folds kU with the
    shard index: 9 new rows."""
    _, ref, ports = sampled
    np.testing.assert_allclose(ports[0][f"{mesh}/dense"]["transform"],
                               ref[f"{mesh}/transform"], rtol=1e-9,
                               atol=1e-12)


def test_every_rank_returns_the_same_result(sampled):
    """Replicated factors stay bit for bit equal on every rank: the ranks
    sharing a replica draw alike under one key."""
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
    """random_state 0 twice gives the same fit bit for bit, random_state 1
    (the same initial factors) another."""
    _, _, ports = sampled
    a, b, c = (ports[0][f"{mesh}/record/{t}"]
               for t in ("seed0", "seed0_again", "seed1"))
    assert a["losses"] == b["losses"]
    for key in ("U", "V", "Z"):
        np.testing.assert_array_equal(a[key], b[key])
    assert a["losses"] != c["losses"] and not np.array_equal(a["U"], c["U"])


# the terms each layout's step draws, in order: (factor, term t, the mesh
# coordinate a distributed term folds its key with, or None); the
# reference's folds (pycmf_tpu/parallel/sharded.py:1288, 1498,
# pycmf_tpu/parallel/grid.py:479, pycmf_tpu/solvers/newton.py:363-369)
TERMS = {
    "rows": (("U", 0, None), ("Z", 0, None), ("V", 0, "rank"),
             ("V", 1, None)),
    "cols": (("U", 0, "rank"), ("Z", 0, "rank"), ("V", 0, None),
             ("V", 1, None)),
    "grid": (("U", 0, "j"), ("Z", 0, "j"), ("V", 0, "i"), ("V", 1, None)),
}
# the folds of the reference's key of factor f before its update
PRE = {"rows": {"U": "rank"}, "cols": {"V": "rank"}, "grid": {"V": "j"}}


def _coords(mesh, rank):
    layout, shape = MESHES[mesh]
    i, j = divmod(rank, shape[1]) if layout == "grid" else (None, None)
    return dict(rank=rank, i=i, j=j)


def _ref_key(layout, it, coords, f, t, axis, seed=0):
    """The reference's key of one term (jax.random on its key schedule)."""
    keys = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(seed), it),
                            3)
    k = keys["UZV".index(f)]
    if f in PRE[layout]:
        k = jax.random.fold_in(k, coords[PRE[layout][f]])
    k = jax.random.fold_in(k, t)
    if axis is not None:
        k = jax.random.fold_in(k, coords[axis])
    return np.asarray(k)


def _port_key(layout, stream, it, coords, f, t, axis):
    keys = rank_keys(layout, stream.step_keys(it),
                     coords["j"] if layout == "grid" else coords["rank"])
    return term_key(keys["UZV".index(f)], t,
                    None if axis is None else coords[axis]).numpy()


@pytest.mark.parametrize("sampled", [2], indirect=True, ids=["ranks2"])
@pytest.mark.parametrize("mesh", ["rows_d2", "grid_2x1"])
def test_own_draws_differ_shared_draws_equal(sampled, mesh):
    """Every term's key on each rank of the mesh, over the fit's
    iterations, is the reference's; two ranks draw under one key where
    they hold one replica (rows: Z's term and V's Y term; the grid (2, 1),
    one mesh column: U's and Z's terms and V's Y term) and under different
    keys where the term is their own (U's and V's X terms; V's X term).
    And the spawned fits of both ranks end equal."""
    layout, _ = MESHES[mesh]
    stream = key_stream("newton", SolverConfig(sg_sample_ratio=RATIO), 0,
                        "cpu")
    for it in range(_kw(mesh, "sigmoid_y")["max_iter"]):
        for f, t, axis in TERMS[layout]:
            got = [_port_key(layout, stream, it, _coords(mesh, r), f, t,
                             axis) for r in (0, 1)]
            for r in (0, 1):
                np.testing.assert_array_equal(got[r], _ref_key(
                    layout, it, _coords(mesh, r), f, t, axis))
            own = (axis is not None and axis != "j") or (
                PRE[layout].get(f) == "rank")
            assert np.array_equal(got[0], got[1]) is not own, (f, t, axis)
    _, _, ports = sampled
    for key in ("U", "V", "Z"):
        np.testing.assert_array_equal(ports[0][f"{mesh}/record/seed0"][key],
                                      ports[1][f"{mesh}/record/seed0"][key])


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_stream_seeds_and_generators(mesh):
    """The per-rank key folds of every layout and mesh (d = 2 and 4, the
    grids (2, 1) and (2, 2)) over three iterations, from a seed past 2³²:
    every term's key on every rank is the reference's; the stream is
    PRNGKey(seed) from iteration 0, none for a full-batch or MU fit."""
    layout, shape = MESHES[mesh]
    seed = 2 ** 33 + 7
    cfg = SolverConfig(sg_sample_ratio=RATIO)
    stream = key_stream("newton", cfg, seed, "cpu")
    np.testing.assert_array_equal(stream.key.numpy(),
                                  np.asarray(jax.random.PRNGKey(seed)))
    assert int(stream.it) == 0
    assert key_stream("newton", SolverConfig(), seed, "cpu") is None
    assert key_stream("mu", cfg, seed, "cpu") is None
    for it in range(3):
        for rank in range(_world(mesh)):
            c = _coords(mesh, rank)
            for f, t, axis in TERMS[layout]:
                np.testing.assert_array_equal(
                    _port_key(layout, stream, it, c, f, t, axis),
                    _ref_key(layout, it, c, f, t, axis, seed=seed))
    assert rank_keys(layout, None, 0) == (None, None, None)
    assert trandom.prng_key(seed).device == torch.device("cpu")
