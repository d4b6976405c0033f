"""The port's one-dispatch fit (``loop='device'``) and its cache, on the CPU.

On the card a key's first device fit replays a graph of one eval block per
block; its next fit builds the cache's one entry, and that fit and every
later one of the key are one launch of a CUDA graph
(``solvers/common.run_device_fit``, ``ops/kernels/fit_loop.py``); on the
CPU the same schedule runs eagerly, the stop rule by its plain version.
Here: the port against the reference's ``loop='device'`` (JAX on the CPU)
in float64 at rtol 1e-9 at the stops and remainders the while loop must get
right; ``step_times_`` and the history's finish against the reference's
``amortize_step_times`` and ``finish_device_fit``; divergence; the plain
stop rule against the host loop's on crafted sequences; the cache's key,
its bound of one entry and its byte limit, its hits (bit for bit a fresh
fit) and misses; results that never alias an entry; a sampled fit on a
hit; and the card's entry points with a fake library (a refused node type
named, a failure raised, the rule's nodes counted).
"""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from pycmf_tpu import CMF as JCMF
from pycmf_tpu.solvers import common as jcommon
from pycmf_tpu_torch import CMF
from pycmf_tpu_torch.ops.kernels import _build
from pycmf_tpu_torch.ops.kernels import fit_loop as kfit
from pycmf_tpu_torch.ops.kernels import policy
from pycmf_tpu_torch.ops.random import prng_key
from pycmf_tpu_torch.solvers import common as tcommon
from pycmf_tpu_torch.solvers.common import Coupled, SolverConfig, make_hyper
from pycmf_tpu_torch.solvers.mu import run_mu
from pycmf_tpu_torch.solvers.newton import run_newton
from tests.conftest import make_problem


@pytest.fixture(autouse=True)
def empty_cache():
    tcommon.clear_fit_cache()
    yield
    tcommon.clear_fit_cache()


def _factors(rng, n, m, r, k):
    return (np.abs(rng.randn(n, k)), np.abs(rng.randn(m, k)),
            np.abs(rng.randn(r, k)))


def _pair(rng, kw):
    X, Y = make_problem(rng, n=45, m=30, r=8)
    U0, V0, Z0 = _factors(rng, 45, 30, 8, 3)
    kw = dict(dict(n_components=3, dtype="float64"), **kw)
    j = JCMF(loop="device", **kw).fit(X, Y, U=U0, V=V0, Z=Z0)
    t = CMF(loop="device", device="cpu", **kw).fit(X, Y, U=U0, V=V0, Z=Z0)
    return j, t


def _assert_matches(j, t):
    assert t.n_iter_ == j.n_iter_
    assert t.loss_iters_ == j.loss_iters_
    np.testing.assert_allclose(t.loss_history_, j.loss_history_, rtol=1e-9)
    for name in ("U_", "V_", "Z_"):
        np.testing.assert_allclose(getattr(t, name), getattr(j, name),
                                   rtol=1e-9, atol=1e-12)
    assert len(t.step_times_) == len(t.loss_history_) - 1


STOPS = {
    # tol = 1: every decrease is below L0, so the first block stops
    "stop_first_block": (dict(max_iter=40, eval_every=5, tol=1.0),
                         lambda n: n == 5),
    "tol_zero": (dict(max_iter=20, eval_every=5, tol=0.0),
                 lambda n: n == 20),
    "max_iter_below_eval_every": (dict(max_iter=3, eval_every=10,
                                       tol=1e-12), lambda n: n == 3),
    "remainder_runs": (dict(max_iter=17, eval_every=5, tol=1e-12),
                       lambda n: n == 17),
}


@pytest.mark.parametrize("solver", ["mu", "newton"])
@pytest.mark.parametrize("case", sorted(STOPS))
def test_stops_and_remainders_match_reference_device_loop(rng, case,
                                                          solver):
    kw, n_iter_ok = STOPS[case]
    j, t = _pair(rng, dict(kw, solver=solver))
    _assert_matches(j, t)
    assert n_iter_ok(t.n_iter_)


@pytest.mark.parametrize("solver", ["mu", "newton"])
def test_stop_at_last_full_block_with_remainder_pending(rng, solver):
    """Where the rule stops at the last full block, the remainder block
    (the reference's lax.cond, the fit graph's if node) does not run."""
    X, Y = make_problem(rng, n=45, m=30, r=8)
    U0, V0, Z0 = _factors(rng, 45, 30, 8, 3)
    kw = dict(n_components=3, dtype="float64", solver=solver, eval_every=4,
              tol=1e-3)
    probe = CMF(loop="host", device="cpu", max_iter=400, **kw).fit(
        X, Y, U=U0, V=V0, Z=Z0)
    stop = probe.n_iter_
    assert stop < 400 and stop % 4 == 0
    kw["max_iter"] = stop + 3
    j = JCMF(loop="device", **kw).fit(X, Y, U=U0, V=V0, Z=Z0)
    t = CMF(loop="device", device="cpu", **kw).fit(X, Y, U=U0, V=V0, Z=Z0)
    _assert_matches(j, t)
    assert t.n_iter_ == stop and t.loss_iters_[-1] == stop


def test_step_times_amortize_the_fit_as_the_reference_does(rng):
    j, t = _pair(rng, dict(solver="mu", max_iter=17, eval_every=5,
                           tol=0.0))
    spans = np.diff(t.loss_iters_)
    got = np.asarray(t.step_times_)
    np.testing.assert_allclose(got / got.sum(), spans / spans.sum(),
                               rtol=1e-12)
    for iters in ([0, 5, 10, 15, 17], [0, 3], [0], [0, 10, 10]):
        assert tcommon.amortize_step_times(2.5, iters) == pytest.approx(
            jcommon.amortize_step_times(2.5, iters), rel=1e-15)


@pytest.mark.parametrize("n_iter,hist", [
    (10, [3.0, 2.0, 1.5, np.nan]),
    (12, [3.0, 2.0, 1.5, 1.25]),
    (5, [3.0, 2.0, np.nan, np.nan]),
    (10, [3.0, 2.0, np.inf, np.nan]),
    (5, [np.nan, 2.0, np.nan, np.nan]),
])
def test_finish_matches_reference_finish(n_iter, hist):
    """max_iter 12 at eval_every 5: the written prefix from n_iter, a
    non-finite value in it raising FloatingPointError in both."""
    h = np.asarray(hist)
    try:
        want = jcommon.finish_device_fit(
            (None, None, None, n_iter, h), 5, 12)[4:]
    except FloatingPointError:
        with pytest.raises(FloatingPointError, match="non-finite"):
            tcommon.finish_device_fit(n_iter, h, 5, 12)
        return
    assert tcommon.finish_device_fit(n_iter, h, 5, 12) == tuple(want)


def test_divergent_fit_raises_where_the_reference_does(rng):
    """A Newton fit built to overflow float32 raises FloatingPointError
    from both packages' device loops (the port's after its one readback,
    from the written history)."""
    X, Y = make_problem(rng, n=24, m=16, non_negative=False)
    kw = dict(n_components=3, solver="newton", loop="device",
              dtype="float32", max_iter=6, tol=0.0, random_state=0,
              U_non_negative=False, V_non_negative=False,
              Z_non_negative=False, line_search_trials=0,
              hessian_pertubation=0.0, eps=0.0)
    with pytest.raises(FloatingPointError):
        JCMF(**kw).fit(X * 1e30, Y * 1e30)
    with pytest.raises(FloatingPointError, match="device-resident"):
        CMF(device="cpu", **kw).fit(X * 1e30, Y * 1e30)


# -- the stop rule against the host loop's -------------------------------

def _host_rule(L0, losses, tol):
    """The host loop's rule (run_solver_loop) on a loss sequence: the
    block at which it stops (a non-finite loss stops it too: the fit
    raises) or None."""
    prev = L0
    for j, loss in enumerate(losses):
        if not np.isfinite(loss):
            return j
        if L0 > 0 and (prev - loss) / L0 < tol:
            return j
        prev = loss
    return None


SEQUENCES = {
    "falling": (10.0, [8.0, 6.5, 6.4, 6.39], 0.01),
    "nan": (10.0, [8.0, float("nan"), 5.0], 0.0),
    "plus_inf": (10.0, [8.0, float("inf"), 5.0], 0.0),
    "minus_inf": (10.0, [8.0, float("-inf"), 5.0], 0.0),
    "nan_L0": (float("nan"), [8.0, 7.0, 6.0], 0.5),
    "L0_zero": (0.0, [0.0, 0.0, 0.0], 0.5),
    "L0_negative": (-1.0, [-2.0, -2.0, -2.0], 0.5),
    "equal_losses": (10.0, [8.0, 8.0, 7.0], 0.0),
    "tie_at_tol": (1.0, [0.75, 0.5], 0.25),
    "inexact_tie": (3.0, [1.0, 0.1, 0.09], 0.3),
    "rising": (10.0, [8.0, 9.0], -0.05),
}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_stop_rule_ref_matches_host_rule(name):
    """The plain rule, driven as the fit graph drives the kernel (a gate,
    then the rule after each block while the loop's handle is set), stops
    at the block the host loop stops at and writes each loss bit for bit;
    the remainder's gate opens only where no stop came first."""
    L0, losses, tol = SEQUENCES[name]
    n_full = len(losses)
    ctl = torch.tensor([0, n_full, 0, 0, 0])
    fctl = torch.tensor([tol, L0, L0], dtype=torch.float64)
    hist = torch.full((n_full + 2,), float("nan"), dtype=torch.float64)
    hist[0] = L0
    go, rem = kfit.stop_rule_ref(ctl, fctl, hist, None, kfit.GATE)
    ran = 0
    while bool(go):
        go, rem = kfit.stop_rule_ref(
            ctl, fctl, hist, torch.tensor(losses[ran], dtype=torch.float64),
            kfit.BLOCK)
        ran += 1
    want = _host_rule(L0, losses, tol)
    assert ran == (n_full if want is None else want + 1)
    assert int(ctl[0]) == ran and bool(ctl[2]) == (want is not None)
    assert bool(rem) == (want is None)
    assert np.array_equal(hist[1:ran + 1].numpy(), np.asarray(losses[:ran]),
                          equal_nan=True)
    assert torch.isnan(hist[ran + 1:]).all()
    if want is None:
        kfit.stop_rule_ref(ctl, fctl, hist,
                           torch.tensor(1.5, dtype=torch.float64),
                           kfit.REMAINDER)
        assert int(ctl[3]) == 1 and float(hist[ran + 1]) == 1.5


def test_stop_rule_on_cpu_is_the_plain_version():
    ctl = torch.tensor([0, 3, 0, 0, 0])
    fctl = torch.tensor([0.2, 4.0, 4.0], dtype=torch.float64)
    hist = torch.full((5,), float("nan"), dtype=torch.float64)
    before = kfit.LAUNCHES.n
    kfit.stop_rule(ctl, fctl, hist, torch.tensor(3.0, dtype=torch.float64))
    assert ctl.tolist()[:3] == [1, 3, 0] and float(hist[1]) == 3.0
    kfit.stop_rule(ctl, fctl, hist, torch.tensor(2.5, dtype=torch.float64))
    assert ctl.tolist()[:3] == [2, 3, 1] and float(fctl[2]) == 2.5
    assert kfit.LAUNCHES.n == before   # the CPU launches nothing


# -- the cache --------------------------------------------------------------

def _mu_fit(X, Y, U0, V0, Z0, **kw):
    kw = dict(dict(max_iter=12, eval_every=5, tol=0.0, loop="device"), **kw)
    alpha = kw.pop("alpha", 0.0)
    cfg = SolverConfig(use_pallas=True)
    hyper = make_hyper(alpha, 0.0, dtype=U0.dtype)
    return run_mu(Coupled(X, a_sq=(X * X).sum()), Coupled(Y, a_sq=(Y * Y)
                                                          .sum()),
                  U0, V0, Z0, cfg, hyper, **kw)


def _tensors(rng, n=30, m=20, r=6, k=3, dtype=torch.float64):
    X, Y = make_problem(rng, n=n, m=m, r=r)
    return [torch.from_numpy(a).to(dtype) for a in
            (X, Y) + _factors(rng, n, m, r, k)]


def test_hit_with_other_data_equals_a_fresh_fit_bit_for_bit(rng):
    """A key's first fit keeps nothing; its second builds the entry; a
    third, on other data, hits: no capture, no eager block, and the
    results of a fresh fit of that data bit for bit."""
    first = _tensors(rng)
    other = _tensors(rng)
    _mu_fit(*first)
    assert not tcommon.LAST_FIT["hit"] and tcommon.fit_cache_entries() == []
    built = _mu_fit(*first)
    assert not tcommon.LAST_FIT["hit"] and tcommon.LAST_FIT["captures"] == 2
    hit = _mu_fit(*other)
    assert tcommon.LAST_FIT == dict(hit=True, eager_blocks=0, captures=0,
                                    graph_launches=1, replays=0)
    tcommon.clear_fit_cache()
    fresh = _mu_fit(*other)
    again = _mu_fit(*first)
    for a, b in zip(hit[:3] + built[:3], fresh[:3] + again[:3]):
        assert torch.equal(a, b)
    assert hit[3:6] == fresh[3:6] and built[3:6] == again[3:6]


def _est_fit(X, Y, **kw):
    kw = dict(dict(n_components=3, solver="mu", max_iter=6, eval_every=3,
                   tol=0.0, random_state=0, loop="device", device="cpu",
                   dtype="float64"), **kw)
    CMF(**kw).fit(X, Y)
    return tcommon.LAST_FIT["hit"]


def _sparse(rng, n, m, density):
    A = sp.random(n, m, density=density, random_state=rng, format="csr")
    A.data = np.abs(A.data) + 0.1
    return A


MISSES = {
    "hyper": lambda X, Y, r: (X, Y, dict(alpha=0.1)),
    "eval_every": lambda X, Y, r: (X, Y, dict(eval_every=2)),
    "remainder": lambda X, Y, r: (X, Y, dict(max_iter=7)),
    "dtype": lambda X, Y, r: (X, Y, dict(dtype="float32")),
    "shape": lambda X, Y, r: (X[:-1], Y, {}),
    "nnz": lambda X, Y, r: (_sparse(r, 30, 20, 0.3), Y,
                            dict(sparse_mode="csr")),
    "layout": lambda X, Y, r: (X, Y, dict(sparse_mode="dense")),
    "fp8": lambda X, Y, r: (X, Y, dict(dtype="float32", data_dtype="fp8")),
    "solver": lambda X, Y, r: (X, Y, dict(solver="newton")),
    "config": lambda X, Y, r: (X, Y, dict(use_pallas=False)),
}


@pytest.mark.parametrize("field", sorted(MISSES))
def test_cache_misses_on_each_changed_field(rng, field):
    """A fit that changes one field of the key misses, twice (its second
    fit builds its own entry); the fit it changed from hits before, and
    misses after that. The base fit is on a CSR X (so nnz and the layout
    can change) at float64 ('fp8' and 'dtype' change to float32 factors:
    the base is then refit at float32)."""
    X = _sparse(rng, 30, 20, 0.2)
    Y = np.abs(rng.randn(20, 6))
    base = dict(sparse_mode="csr")
    if field == "fp8":
        X, base = X.toarray(), dict(dtype="float32", data_dtype="bfloat16")
    assert [_est_fit(X, Y, **base) for _ in range(3)] == [False, False, True]
    X2, Y2, kw = MISSES[field](X, Y, rng)
    kw = dict(base, **kw)
    assert not _est_fit(X2, Y2, **kw), f"{field}: {kw} hit"
    assert _est_fit(X, Y, **base)
    assert not _est_fit(X2, Y2, **kw) and not _est_fit(X2, Y2, **kw)
    assert not _est_fit(X, Y, **base)


@pytest.mark.parametrize("kw", [dict(max_iter=9), dict(tol=1e-3),
                                dict(max_iter=30, tol=1e-2)])
def test_cache_hits_across_max_iter_and_tol(rng, kw):
    """max_iter (at the same remainder) and tol live in device buffers
    that each fit writes, not in the graph: changing them still hits."""
    X, Y = make_problem(rng, n=20, m=12, r=4)
    assert not _est_fit(X, Y) and not _est_fit(X, Y)
    assert _est_fit(X, Y, **kw)


def test_cache_is_bounded_least_recently_used_first(rng):
    """The cache holds one entry: building another evicts it (closed: its
    buffers dropped)."""
    X, Y = make_problem(rng, n=20, m=12, r=4)
    old = None
    for e in (1, 2, 3):
        for _ in range(2):
            _est_fit(X, Y, eval_every=e, max_iter=6)
        (entry,) = tcommon.fit_cache_entries()
        assert entry.key[2] == e and entry.nbytes > 0
        if old is not None:
            assert old.statics is None and old.fit is None
        old = entry
    tcommon.clear_fit_cache()
    assert tcommon.fit_cache_entries() == [] and old.statics is None


@pytest.mark.parametrize("limit,builds", [(None, True), (10 ** 9, True),
                                          (1000, False)])
def test_cache_entry_only_under_its_byte_limit(rng, monkeypatch, limit,
                                               builds):
    """A key's second fit builds the entry only where its data and factors
    take at most fit_cache_limit bytes (X here: 20 x 12 float64, 1920
    bytes); past it every fit runs the first fit's schedule, and keeps
    the entry it found."""
    X, Y = make_problem(rng, n=20, m=12, r=4)
    _est_fit(X, Y, eval_every=1)
    _est_fit(X, Y, eval_every=1)
    (kept,) = tcommon.fit_cache_entries()
    monkeypatch.setattr(tcommon, "fit_cache_limit", lambda device: limit)
    _est_fit(X, Y)
    first = dict(tcommon.LAST_FIT)
    _est_fit(X, Y)
    assert first["eager_blocks"] == 1 and first["graph_launches"] == 0
    assert (tcommon.LAST_FIT["graph_launches"] == 1) is builds
    assert tcommon.LAST_FIT["eager_blocks"] == (0 if builds else 1)
    assert (tcommon.fit_cache_entries() == [kept]) is not builds


def test_results_never_alias_the_entry(rng):
    """The factors a device fit returns are not the entry's buffers: a
    later fit of the same key leaves them as they were."""
    a = _tensors(rng)
    _mu_fit(*a)
    U, V, Z = _mu_fit(*a)[:3]
    kept = [t.clone() for t in (U, V, Z)]
    (entry,) = tcommon.fit_cache_entries()
    ours = {t.untyped_storage().data_ptr() for t in entry.statics}
    assert not ours & {t.untyped_storage().data_ptr() for t in (U, V, Z)}
    _mu_fit(*_tensors(rng))
    assert tcommon.LAST_FIT["hit"]
    for t, k in zip((U, V, Z), kept):
        assert torch.equal(t, k)


def test_entry_reads_only_its_own_copies(rng):
    """An entry reads its copies of the data, not the tensors of the fit
    that built it: changing those after that fit changes nothing."""
    a, b, c = _tensors(rng), _tensors(rng), _tensors(rng)
    _mu_fit(*a)
    _mu_fit(*b)
    for t in b:
        t.fill_(float("nan"))
    hit = _mu_fit(*c)
    assert tcommon.LAST_FIT["hit"]
    tcommon.clear_fit_cache()
    fresh = _mu_fit(*c)
    assert all(torch.equal(x, y) for x, y in zip(hit[:3], fresh[:3]))


def _sampled(X, Y, U0, V0, Z0, seed, loop):
    cfg = SolverConfig(use_pallas=True, y_link="sigmoid",
                       sg_sample_ratio=0.5)
    Yc = Coupled(Y, a_sq=(Y * Y).sum())
    return run_newton(Coupled(X, a_sq=(X * X).sum()), Yc, U0, V0, Z0, cfg,
                      make_hyper(dtype=U0.dtype), prng_key(seed), max_iter=7,
                      eval_every=3, tol=0.0, loop=loop)


def test_sampled_fit_on_a_hit_draws_as_a_fresh_fit(rng):
    """A sampled fit's draws follow its own key, on a key's first fit (an
    eager block, a graph of one eval block replayed), on the fit that
    builds the entry and on a hit: the last two are one launch of the fit
    graph (the entry's key stream loaded from the fit's, its counter read
    on the device by every block, the remainder's from n_full·eval_every),
    no replay. Each equals the host loop's fit with the same seed bit for
    bit, and another seed gives another fit."""
    X, Y = make_problem(rng, n=30, m=20, r=6, binary_y=True)
    X, Y = torch.from_numpy(X), torch.from_numpy(Y)
    U0, V0, Z0 = (torch.from_numpy(a) for a in _factors(rng, 30, 20, 6, 3))
    tcommon.clear_fit_cache()
    fits = []
    for seed, hit, launches, replays in ((1, False, 0, 1), (2, False, 1, 0),
                                         (3, True, 1, 0)):
        dev = _sampled(X, Y, U0, V0, Z0, seed, "device")
        assert tcommon.LAST_FIT["hit"] is hit
        assert tcommon.LAST_FIT["graph_launches"] == launches
        assert tcommon.LAST_FIT["replays"] == replays
        host = _sampled(X, Y, U0, V0, Z0, seed, "host")
        for a, b in zip(dev[:3], host[:3]):
            assert torch.equal(a, b)
        assert dev[3:5] == host[3:5]
        fits.append(dev)
    assert not torch.equal(fits[1][0], fits[2][0])
    assert isinstance(tcommon.fit_cache_entries()[0].fit,
                      tcommon.EagerFitGraph)
    tcommon.clear_fit_cache()


# -- the card's entry points, reached with a fake library ------------------

@pytest.fixture
def fake_fit_library(monkeypatch):
    """A fake fit_loop library: the check reports node type ``rec.bad``,
    create and launch return ``rec.rc``. Yields the record."""
    import types

    rec = types.SimpleNamespace(bad=-1, rc=0, calls=[])

    def check(graph, device, bad, nodes):
        rec.calls.append(("check", graph))
        bad._obj.value = rec.bad
        nodes._obj.value = 7
        return 0

    def create(*args):
        rec.calls.append(("create",) + args[:2])
        return rec.rc

    def launch(*args):
        rec.calls.append(("launch",))
        return rec.rc

    lib = types.SimpleNamespace(
        pycmf_fit_graph_check=check, pycmf_fit_graph_create=create,
        pycmf_fit_graph_launch=launch,
        pycmf_fit_graph_destroy=lambda *a: 0,
        pycmf_error_string=lambda rc: b"fake failure")
    monkeypatch.setattr(_build, "load", lambda name: lib)
    monkeypatch.setattr(_build, "_functions", {})
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda dev: 0xBEEF, raising=False)
    monkeypatch.setattr(torch.Tensor, "get_device", lambda t: 0)
    yield rec


def _fit_graph(rem=0):
    ctl = torch.zeros(kfit.CTL_SLOTS, dtype=torch.int64)
    fctl = torch.zeros(kfit.FCTL_SLOTS, dtype=torch.float64)
    loss = torch.zeros((), dtype=torch.float64)
    return kfit.FitGraph(0x1000, rem, ctl, fctl, loss, loss.clone())


@pytest.mark.parametrize("rem", [0, 0x2000])
def test_fit_graph_counts_nodes_and_launches(fake_fit_library, rem):
    """A fit graph's nodes (the child graphs'), and fit_loop's launches:
    its gate nodes at the launch (one, two with a remainder), then one
    rule node per eval block run and one after a remainder that ran."""
    policy.reset_launch_counts()
    g = _fit_graph(rem=rem)
    assert g.nodes == (14 if rem else 7)
    g.launch()
    assert kfit.LAUNCHES.n == (2 if rem else 1)
    g.ran(3, bool(rem))
    assert kfit.LAUNCHES.n == (6 if rem else 4)
    assert [c[0] for c in fake_fit_library.calls] == [
        "check"] * (1 + bool(rem)) + ["create", "launch"]
    assert fake_fit_library.calls[-2][1:] == (0x1000, rem or None)
    g.close()
    policy.reset_launch_counts()


@pytest.mark.parametrize("bad,name", [(3, "host"), (6, "wait event"),
                                      (10, "memory allocation")])
def test_fit_graph_refuses_a_node_type_naming_it(fake_fit_library, bad,
                                                 name):
    fake_fit_library.bad = bad
    with pytest.raises(RuntimeError, match=f"holds a {name} node"):
        _fit_graph()
    assert [c[0] for c in fake_fit_library.calls] == ["check"]


@pytest.mark.parametrize("stage", ["build", "launch"])
def test_fit_graph_failure_raises(fake_fit_library, stage):
    """No fallback: a failure to build or launch the fit graph raises."""
    if stage == "build":
        fake_fit_library.rc = 700
        with pytest.raises(RuntimeError, match="fit graph build.*700"):
            _fit_graph()
        return
    g = _fit_graph()
    fake_fit_library.rc = 700
    with pytest.raises(RuntimeError, match="fit graph launch.*700"):
        g.launch()
