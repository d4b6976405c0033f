"""The port's device loop (``loop='device'``) on the CPU.

On the card a key's first device fit replays a graph of one eval block
per block, and its later fits run as one launch of a cached CUDA graph (an
eval block inside a conditional while node); on the CPU the device loop
runs the same schedule with every block eager (the stand-ins
``solvers/common.EagerBlockGraph`` and ``EagerFitGraph``). Here it is held
against the reference's ``loop='device'`` (the jitted while loop, JAX on
the CPU) in float64 at rtol 1e-9, for MU on dense and CSR X and Newton with
linear links and with a sigmoid Y, early stops and remainder blocks
included; its schedule and launch counts, on a key's first fit, on the fit
that builds its cache entry and on a cache hit, are checked with a
recording stand-in and a fake block, and the estimator's loop rule case by
case.
"""
import numpy as np
import pytest
import torch

from pycmf_tpu import CMF as JCMF
from pycmf_tpu_torch import CMF
from pycmf_tpu_torch.ops.kernels import policy
from pycmf_tpu_torch.solvers import common as tcommon
from pycmf_tpu_torch.solvers.common import SolverConfig
from pycmf_tpu_torch.solvers.newton import captures_on_card
from tests.conftest import make_problem


def _factors(rng, n, m, r, k):
    return (np.abs(rng.randn(n, k)), np.abs(rng.randn(m, k)),
            np.abs(rng.randn(r, k)))


CASES = {
    "mu_dense": dict(solver="mu", max_iter=30, eval_every=5, tol=1e-7),
    "mu_csr": dict(solver="mu", max_iter=30, eval_every=5, tol=1e-7,
                   sparse_mode="csr"),
    "newton_linear": dict(solver="newton", max_iter=12, eval_every=4,
                          tol=1e-7, alpha=0.1, l1_ratio=0.5),
    "newton_sigmoid_y": dict(solver="newton", y_link="sigmoid", max_iter=12,
                             eval_every=4, tol=1e-7),
    "newton_sigmoid_y_k40": dict(solver="newton", y_link="sigmoid",
                                 max_iter=8, eval_every=4, tol=1e-7,
                                 n_components=40),
    "mu_early_stop": dict(solver="mu", max_iter=200, eval_every=5,
                          tol=1e-3),
    "mu_remainder": dict(solver="mu", max_iter=23, eval_every=10, tol=0.0),
}


@pytest.mark.parametrize("use_pallas", [None, False])
@pytest.mark.parametrize("case", sorted(CASES))
def test_device_loop_matches_reference_device_loop_f64(rng, case,
                                                       use_pallas):
    kw = dict(n_components=4, dtype="float64", use_pallas=use_pallas)
    kw.update(CASES[case])
    sigmoid = kw.get("y_link") == "sigmoid"
    X, Y = make_problem(rng, n=61, m=96 if kw["n_components"] > 32 else 40,
                        sparse=kw.get("sparse_mode") == "csr",
                        binary_y=sigmoid)
    U0, V0, Z0 = _factors(rng, X.shape[0], X.shape[1], Y.shape[1],
                          kw["n_components"])
    j = JCMF(loop="device", **kw).fit(X, Y, U=U0, V=V0, Z=Z0)
    t = CMF(loop="device", device="cpu", **kw).fit(X, Y, U=U0, V=V0, Z=Z0)
    assert t.n_iter_ == j.n_iter_
    assert t.loss_iters_ == j.loss_iters_
    np.testing.assert_allclose(t.loss_history_, j.loss_history_, rtol=1e-9)
    for name in ("U_", "V_", "Z_"):
        np.testing.assert_allclose(getattr(t, name), getattr(j, name),
                                   rtol=1e-9, atol=1e-12)
    assert len(t.step_times_) == len(t.loss_history_) - 1
    if case == "mu_early_stop":
        assert t.n_iter_ < kw["max_iter"]
    if case == "mu_remainder":
        assert t.loss_iters_ == [0, 10, 20, 23]


@pytest.mark.parametrize("solver", ["mu", "newton"])
def test_device_loop_equals_host_loop_bit_for_bit(rng, solver):
    """Both loops run the same blocks in the same order on the CPU."""
    X, Y = make_problem(rng, n=61)
    kw = dict(n_components=4, solver=solver, random_state=0, max_iter=23,
              eval_every=5, tol=1e-7, dtype="float64", device="cpu")
    h = CMF(loop="host", **kw).fit(X, Y)
    d = CMF(loop="device", **kw).fit(X, Y)
    assert d.loss_history_ == h.loss_history_
    assert d.loss_iters_ == h.loss_iters_
    for name in ("U_", "V_", "Z_"):
        assert np.array_equal(getattr(d, name), getattr(h, name))


def test_divergent_device_loop_raises(rng):
    """A Newton fit built to overflow float32 raises FloatingPointError
    from the device loop, as from the reference's
    (tests/test_round2_fixes.py)."""
    X, Y = make_problem(rng, n=24, m=16, non_negative=False)
    m = CMF(n_components=3, solver="newton", loop="device", dtype="float32",
            max_iter=6, tol=0.0, random_state=0, U_non_negative=False,
            V_non_negative=False, Z_non_negative=False,
            line_search_trials=0, hessian_pertubation=0.0, eps=0.0,
            device="cpu")
    with pytest.raises(FloatingPointError):
        m.fit(X * 1e30, Y * 1e30)


# -- the schedule, with a recording stand-in and a fake block --------------

class RecordingGraph(tcommon.EagerBlockGraph):
    events = []

    def capture(self, fn, outputs):
        self.events.append("capture")
        super().capture(fn, outputs)

    def replay(self):
        self.events.append("replay")
        super().replay()


def _fake_run(device, max_iter, eval_every, plateau_after=None):
    """run_solver_loop over a fake block: each step moves U and V and
    counts one launch of a fake kernel, each loss counts one more; the loss
    stops falling once V sums past ``plateau_after`` (a tol stop). Returns
    the loop's result, the fake launches and the block's step counts, call
    by call; under the device loop three fits of one key from a cleared
    cache (the first fit, the fit that builds the entry, a cache hit), each
    with the graphs' events and the loop's record (LAST_FIT)."""
    fake_step = policy.launch_count("test_fake_step")
    fake_loss = policy.launch_count("test_fake_loss")
    calls = []

    def block(state, hyper, rng, n_steps):
        X, Y, U, V, Z = state
        calls.append(n_steps)
        for _ in range(n_steps):
            U = U * 0.5 + 1.0
            V = V + U.sum()
            fake_step.n += 1
        fake_loss.n += 1
        done = torch.minimum(V.sum(), torch.tensor(1e30, dtype=V.dtype))
        loss = 1.0 / (1.0 + done) if plateau_after is None else \
            torch.where(V.sum() > plateau_after, torch.tensor(1.0),
                        1.0 / (1.0 + done))
        return (X, Y, U, V, Z), loss, rng

    def fit():
        state = (None, None, torch.ones(3, 2), torch.zeros(2, 2),
                 torch.zeros(0, 2))
        policy.reset_launch_counts()
        RecordingGraph.events = []
        calls.clear()
        out = tcommon.run_solver_loop(
            block, state, None, None, max_iter=max_iter, tol=1e-12,
            eval_every=eval_every, initial_loss_fn=lambda s, h: torch.tensor(
                2.0), loop="device" if device else "host",
            key=("fake", plateau_after))
        counts = {k: v for k, v in policy.launch_counts().items()
                  if k.startswith("test_fake")}
        return (out, counts, list(calls), RecordingGraph.events,
                dict(tcommon.LAST_FIT))

    if not device:
        return fit()[:3]
    tcommon.clear_fit_cache()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tcommon, "EagerBlockGraph", RecordingGraph)
        runs = fit(), fit(), fit()
    tcommon.clear_fit_cache()
    return runs


@pytest.mark.parametrize("max_iter,eval_every,events,build_events", [
    (10, 10, [], ["capture", "replay"]),
    (15, 10, [], ["capture", "capture", "replay", "replay"]),
    (20, 10, ["capture", "replay"], ["capture", "replay", "replay"]),
    (33, 10, ["capture", "replay", "replay"],
     ["capture", "capture"] + ["replay"] * 4),
    (40, 10, ["capture", "replay", "replay", "replay"],
     ["capture"] + ["replay"] * 4),
    (5, 1, ["capture", "replay", "replay", "replay", "replay"],
     ["capture"] + ["replay"] * 5),
])
def test_device_loop_schedule_and_launch_counts(max_iter, eval_every,
                                                events, build_events):
    """A key's first fit: block 1 eager, one eval block captured when a
    second full block runs and replayed for each, the remainder eager. The
    second fit builds the entry: it captures the eval block (and the
    remainder block, when max_iter % eval_every) and runs every block in
    the fit graph, as a cache hit does with no capture. All three: the
    launch counts, the losses and the factors those of the host loop."""
    first, build, hit = _fake_run(True, max_iter, eval_every)
    host, host_counts, host_calls = _fake_run(False, max_iter, eval_every)
    n_full, rem = divmod(max_iter, eval_every)
    tail = [rem] if rem else []
    assert host_calls == [eval_every] * n_full + tail
    assert first[3] == events and build[3] == build_events
    assert hit[3] == ["replay"] * (n_full + bool(rem))
    # calls: block 1 eager, the capture's pass, the replays, the remainder
    assert first[2] == [eval_every] * (1 + 2 * (n_full > 1)) + [
        eval_every] * max(0, n_full - 2) + tail
    assert build[2] == [eval_every] + tail + [eval_every] * n_full + tail
    assert first[4] == dict(hit=False, eager_blocks=1,
                            captures=int(n_full > 1), graph_launches=0,
                            replays=n_full - 1)
    assert build[4] == dict(hit=False, eager_blocks=0,
                            captures=1 + (rem > 0), graph_launches=1,
                            replays=0)
    assert hit[4] == dict(hit=True, eager_blocks=0, captures=0,
                          graph_launches=1, replays=0)
    for (sd, nd, ld, id_, td), dev_counts, *_ in (first, build, hit):
        (sh, nh, lh, ih, th) = host
        assert dev_counts == host_counts == {
            "test_fake_step": max_iter, "test_fake_loss": len(host_calls)}
        assert (nd, ld, id_) == (nh, lh, ih)
        assert len(td) == len(ld) - 1
        for a, b in zip(sd[2:], sh[2:]):
            assert torch.equal(a, b)


def test_device_loop_early_stop_skips_later_blocks():
    """A tol stop ends the loop: no further block, no remainder, on a
    key's first fit, on the fit that builds its entry and on a hit."""
    first, build, hit = _fake_run(True, 45, 10, plateau_after=30.0)
    host = _fake_run(False, 45, 10, plateau_after=30.0)
    n_iter = host[0][1]
    assert n_iter < 40
    assert first[3] == ["capture"] + ["replay"] * (n_iter // 10 - 1)
    assert build[3] == ["capture", "capture"] + ["replay"] * (n_iter // 10)
    assert hit[3] == ["replay"] * (n_iter // 10)
    for (state, n, losses, iters, times), counts, *_ in (first, build, hit):
        assert (n, losses, iters) == host[0][1:4]
        assert counts == host[1]


def test_launch_count_bookkeeping():
    c = policy.launch_count("test_bookkeeping")
    policy.reset_launch_counts()
    before = policy.launch_counts()
    c.n += 3
    delta = policy.launches_since(before)
    assert delta == {"test_bookkeeping": 3}
    policy.set_launch_counts(before)
    assert c.n == 0
    policy.add_launches(delta)
    policy.add_launches(delta)
    assert c.n == 6
    policy.reset_launch_counts()


def test_block_graph_by_loop_and_device():
    """A CPU factor takes the eager stand-in of a block graph; a loop name
    other than 'host' and 'device' raises, in the loop and in both
    solvers."""
    from pycmf_tpu_torch.solvers import mu as tmu
    from pycmf_tpu_torch.solvers import newton as tnewton

    U = torch.zeros(3, 2)
    assert isinstance(tcommon.block_graph(U), tcommon.EagerBlockGraph)
    for run in (lambda: tcommon.run_solver_loop(
            None, None, None, None, max_iter=1, tol=0.0, eval_every=1,
            loop="gpu"),
            lambda: tmu.run_mu(None, None, U, U, U, SolverConfig(), None,
                               loop="gpu"),
            lambda: tnewton.run_newton(None, None, U, U, U, SolverConfig(),
                                       None, loop="gpu")):
        with pytest.raises(ValueError, match="loop"):
            run()


# -- the estimator's loop rule ---------------------------------------------

@pytest.mark.parametrize("kw,cuda,want", [
    (dict(loop="auto"), False, "host"),
    (dict(loop="auto"), True, "device"),
    (dict(loop="auto", verbose=1), True, "host"),
    (dict(loop="device"), False, "device"),
    (dict(loop="host"), True, "host"),
    (dict(loop="device", verbose=1), True, "device"),
    (dict(loop="auto", solver="newton", n_components=40), True, "device"),
    (dict(loop="auto", solver="newton", y_link="sigmoid"), True, "device"),
    (dict(loop="auto", solver="newton", y_link="sigmoid",
          n_components=65), True, "device"),
    (dict(loop="auto", solver="newton", x_link="sigmoid",
          use_pallas=False), True, "host"),
    (dict(loop="auto", solver="mu", use_pallas=False, n_components=40),
     True, "device"),
    (dict(loop="auto", solver="newton", y_link="sigmoid",
          n_components=40), True, "device"),
    (dict(loop="auto", solver="newton", y_link="sigmoid",
          hessian_form="full"), True, "device"),
    (dict(loop="auto", solver="newton", sg_sample_ratio=0.25,
          y_link="sigmoid"), True, "device"),
])
def test_resolve_loop_rule(monkeypatch, kw, cuda, want):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cuda)
    kw = dict(dict(n_components=4, device="cuda" if cuda else "cpu"), **kw)
    assert CMF(**kw)._resolve_loop() == want


def test_resolve_loop_verbose_auto_is_host_in_both_packages():
    assert JCMF(n_components=2, verbose=1, loop="auto")._resolve_loop() \
        == "host"
    assert CMF(n_components=2, verbose=1, loop="auto",
               device="cpu")._resolve_loop() == "host"


@pytest.mark.parametrize("kw,k,want", [
    (dict(), 40, True),
    (dict(y_link="sigmoid"), 32, True),
    (dict(y_link="sigmoid"), 33, True),
    (dict(x_link="sigmoid", use_pallas=True), 20, True),
    (dict(x_link="sigmoid", use_pallas=False), 20, False),
    (dict(y_link="sigmoid", has_Y=False), 40, True),
    (dict(y_link="sigmoid", update_Z=False, update_V=False), 40, True),
    (dict(use_pallas=False), 20, True),
    (dict(y_link="sigmoid"), 64, True),
    (dict(y_link="sigmoid"), 65, True),
    (dict(y_link="sigmoid", hessian_form="full"), 20, True),
    (dict(x_link="sigmoid", hessian_form="full"), 20, True),
    (dict(hessian_form="full"), 20, True),
    (dict(y_link="sigmoid", sg_sample_ratio=0.25), 20, True),
])
def test_captures_on_card(kw, k, want):
    """Per-row systems (a sigmoid link) through a library's batched solve
    (use_pallas off) cannot be captured on the card; under use_pallas K5
    takes every k (its block route above 64) and the full Hessian form
    (its LU route)."""
    kw = dict(dict(use_pallas=True), **kw)
    assert captures_on_card(SolverConfig(**kw)) is want


@pytest.mark.parametrize("kw,why", [
    (dict(y_link="sigmoid", use_pallas=False), "use_pallas=False"),
    (dict(y_link="sigmoid", hessian_form="full", use_pallas=False),
     "use_pallas=False"),
    (dict(x_link="sigmoid", use_pallas=False), "use_pallas=False k=65")])
def test_device_loop_on_card_refuses_uncapturable_fit_naming_c3(
        monkeypatch, kw, why):
    """loop='device' on a fit the card cannot capture (per-row systems on
    the plain path's library solve) raises, naming C3 and the case, at
    any k and either Hessian form; it does not fall back to the host
    loop. (A card is faked: the refusal comes before any work.)"""
    from pycmf_tpu_torch.solvers import newton as tnewton

    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    k = 65 if "65" in why else 20
    why = why.split(" ")[0]
    cfg = SolverConfig(**dict(dict(use_pallas=True), **kw))
    U0 = torch.zeros(3, k)
    with pytest.raises(NotImplementedError, match="ROADMAP C3") as e:
        tnewton.run_newton(None, None, U0, U0, U0, cfg, None, None,
                           loop="device")
    assert why in str(e.value)
