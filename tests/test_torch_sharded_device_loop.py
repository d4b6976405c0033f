"""The rules around the device loop under shards, in this process: which
loop 'auto' takes under n_shards > 1, the refusal of loop='device' on CUDA
tensors over a gloo group, the cache key's group part and COMM's per-replay
accounting. The process group's backend and the fit's device are patched:
no card and no second process is needed. The fits themselves (the device
loop against the reference and against the host loop) are in
``test_torch_sharded.py``, ``test_torch_sharded_cols.py`` and
``test_torch_sharded_grid.py``."""
import numpy as np
import pytest
import torch
import torch.distributed as dist

from pycmf_tpu_torch import CMF
from pycmf_tpu_torch.parallel import grid as tgrid
from pycmf_tpu_torch.parallel import mesh as tmesh
from pycmf_tpu_torch.parallel import sharded as tsharded
from pycmf_tpu_torch.solvers.common import SolverConfig, make_hyper

CUDA = torch.device("cuda", 0)


@pytest.fixture
def backend(monkeypatch):
    """Set the name dist.get_backend gives every group."""
    def set_backend(name):
        monkeypatch.setattr(tmesh.dist, "get_backend",
                            lambda group=None: name)
    return set_backend


def _sharded_est(monkeypatch, device, **kw):
    est = CMF(n_components=2, n_shards=2, **kw)
    monkeypatch.setattr(CMF, "_resolve_device",
                        lambda self: torch.device(device))
    monkeypatch.setattr(CMF, "_resolve_n_shards", lambda self: 2)
    return est


@pytest.mark.parametrize("device,name,kw,want", [
    ("cuda", "nccl", {}, "device"),
    ("cuda", "cpu:gloo,cuda:nccl", {}, "device"),
    ("cuda", "gloo", {}, "host"),
    ("cuda", "cpu:gloo,cuda:gloo", {}, "host"),
    ("cpu", "gloo", {}, "host"),
    ("cuda", "nccl", dict(verbose=1), "host"),
    ("cuda", "nccl", dict(shard_layout="cols"), "device"),
    ("cuda", "gloo", dict(shard_layout="grid"), "host"),
    # the C3 case: a sigmoid link's per-row systems on the plain path
    ("cuda", "nccl", dict(solver="newton", y_link="sigmoid",
                          use_pallas=False), "host"),
    ("cuda", "nccl", dict(solver="newton", y_link="sigmoid"), "device"),
    ("cuda", "gloo", dict(loop="device"), "device"),
    ("cuda", "nccl", dict(loop="host"), "host"),
], ids=["nccl", "nccl_for_cuda", "gloo", "gloo_for_cuda", "cpu", "verbose",
        "cols", "grid_gloo", "c3", "newton", "explicit_device",
        "explicit_host"])
def test_auto_loop_under_shards(monkeypatch, backend, device, name, kw, want):
    """'auto' under n_shards > 1 is the device loop on CUDA tensors over a
    group whose CUDA backend is NCCL, whatever the layout, as the
    reference takes its device loop on its accelerator; the host loop on
    the CPU, over gloo, under verbose and in the C3 case. An explicit
    loop is honoured (run_sharded then refuses 'device' over gloo)."""
    backend(name)
    est = _sharded_est(monkeypatch, device, **kw)
    assert est._resolve_loop() == want


def _mesh(device=CUDA):
    return tmesh.Mesh(None, 0, 2, torch.device(device))


@pytest.mark.parametrize("name", ["gloo", "cpu:gloo,cuda:gloo"])
def test_device_loop_over_gloo_on_cuda_raises(backend, name):
    """A gloo all-reduce of CUDA tensors goes through the host and cannot
    be captured: loop='device' there raises ValueError saying so; over
    NCCL, on the CPU, and on the host loop it passes."""
    backend(name)
    with pytest.raises(ValueError, match="needs an NCCL process group"):
        tsharded.check_shardable(layout="rows", loop="device", mesh=_mesh())
    tsharded.check_shardable(layout="rows", loop="host", mesh=_mesh())
    tsharded.check_shardable(layout="rows", loop="device",
                             mesh=_mesh("cpu"))
    backend("nccl")
    tsharded.check_shardable(layout="grid", loop="device", mesh=_mesh())


def _args(solver="mu", **cfg):
    rng = np.random.RandomState(0)
    X, Y = np.abs(rng.randn(6, 5)), np.abs(rng.randn(5, 3))
    return (solver, X, Y, np.abs(rng.randn(6, 2)), np.abs(rng.randn(5, 2)),
            np.abs(rng.randn(3, 2)),
            SolverConfig(**dict(dict(use_pallas=True), **cfg)), make_hyper())


@pytest.mark.parametrize("layout", ["rows", "cols", "grid"])
def test_run_sharded_and_run_grid_refuse_device_loop_over_gloo(
        monkeypatch, backend, layout):
    """run_sharded and run_grid check the mesh they fit on before any
    upload: over gloo on a card, loop='device' raises ValueError; over
    NCCL the C3 case raises NotImplementedError naming C3, as on one
    device."""
    mesh = _mesh()
    monkeypatch.setattr(tsharded, "make_mesh", lambda *a, **k: mesh)
    monkeypatch.setattr(tgrid, "make_grid_mesh", lambda *a, **k: (
        tmesh.GridMesh(mesh._replace(axis=tmesh.GRID_AXIS),
                       mesh._replace(axis=tmesh.ROW_AXIS),
                       mesh._replace(world=1, axis=tmesh.COL_AXIS), 2, 1)))

    def run(*args):
        if layout == "grid":
            return tgrid.run_grid(*args, grid=(2, 1), loop="device")
        return tsharded.run_sharded(*args, n_shards=2, layout=layout,
                                    loop="device")

    backend("gloo")
    with pytest.raises(ValueError, match="needs an NCCL process group"):
        run(*_args())
    backend("nccl")
    with pytest.raises(NotImplementedError, match="ROADMAP C3"):
        run(*_args("newton", y_link="sigmoid", use_pallas=False))


def test_cuda_backend_reads_a_mixed_spelling(backend):
    """The backend of CUDA tensors: the one backend a group was made with,
    or the 'cuda:' entry of a per-device spelling."""
    for name, want in (("nccl", "nccl"), ("gloo", "gloo"),
                       ("cpu:gloo,cuda:nccl", "nccl"),
                       ("cuda:nccl,cpu:gloo", "nccl"),
                       ("cpu:gloo,cuda:gloo", "gloo")):
        backend(name)
        assert tmesh.cuda_backend() == want
    backend("nccl")
    assert tmesh.captures(CUDA) and not tmesh.captures("cpu")


def test_group_key_names_each_group_apart(tmp_path):
    """The cache key's mesh part: the same group gives the same key, a new
    group of the same ranks another, so a fit on a later group never finds
    the entry of an earlier one."""
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        a = tmesh.make_mesh(device="cpu")
        other = dist.new_group([0])
        b = tmesh.Mesh(other, 0, 1, torch.device("cpu"))
        assert tmesh.group_key(a) == tmesh.group_key(a)
        assert tmesh.group_key(a) != tmesh.group_key(b)
        assert tmesh.group_key(a)[-1] == "gloo"
        assert tmesh.all_ranks(a, [True, False, 1]) == [True, False, True]
    finally:
        dist.destroy_process_group()


def test_comm_counts_a_replay_as_its_capture_recorded():
    """COMM's counts taken before a capture and put back after it (a
    capture calls no collective), then added once per replay: the same
    totals, per axis too, as the calls made eagerly."""
    comm = tmesh.CommStats()
    comm.calls, comm.nbytes, comm.by_axis = 3, 40, {"rows": [3, 40]}
    before = comm.counts()
    comm.calls += 2
    comm.nbytes += 24
    comm.by_axis["rows"][0] += 1
    comm.by_axis["rows"][1] += 8
    comm.by_axis["grid"] = [1, 16]
    delta = comm.since(before)
    assert delta == (2, 24, {"rows": [1, 8], "grid": [1, 16]})
    comm.set_counts(before)
    assert comm.counts() == before
    comm.add(delta, 3)
    assert (comm.calls, comm.nbytes) == (9, 112)
    assert comm.by_axis == {"rows": [6, 64], "grid": [3, 48]}


class _CardGraphStandIn:
    """The eager stand-in of a block graph, with a card graph's raw()
    and graph pool, for a cache entry built as on the card."""

    def __init__(self):
        from pycmf_tpu_torch.solvers.common import EagerBlockGraph

        self.eager = EagerBlockGraph()
        self.graph = type("Pool", (), {"pool": staticmethod(lambda: None)})

    def capture(self, fn, outputs):
        self.eager.capture(fn, outputs)

    def replay(self):
        self.eager.replay()

    def raw(self):
        return 1

    def close(self):
        self.eager.close()


def test_a_refused_node_makes_a_cached_fit_replay_per_block(monkeypatch):
    """The rule that picks a cache entry's schedule reads the captured
    block's node types (fit_loop.refused_node): where a conditional body
    would refuse one (a host node here, faked), the entry builds no fit
    graph, names the type, and runs the fit as one replay per eval block
    and one of the remainder, with the stop rule after each: the host
    loop's losses and factors."""
    from pycmf_tpu_torch.ops.kernels import fit_loop as kfit
    from pycmf_tpu_torch.solvers import common as tcommon

    def block(state, hyper, rng, n_steps):
        X, Y, U, V, Z = state
        for _ in range(n_steps):
            U = U * 0.5 + 1.0
            V = V + U.sum()
        return (X, Y, U, V, Z), 1.0 / (1.0 + V.sum()), rng

    def state():
        return (None, None, torch.ones(3, 2, dtype=torch.float64),
                torch.zeros(2, 2, dtype=torch.float64),
                torch.zeros(0, 2, dtype=torch.float64))

    with monkeypatch.context() as mp:   # built as on the card
        mp.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
        mp.setattr(tcommon, "block_graph",
                   lambda U, pool=None, keep=False: _CardGraphStandIn())
        mp.setattr(kfit, "refused_node", lambda graph, device: (5, 3))
        entry = tcommon.FitEntry("key", block, state(), None, None,
                                 eval_every=3, rem=1)
    assert entry.refused == "host" and entry.fit is None
    hist = torch.full((5,), float("nan"), dtype=torch.float64)
    entry.start(hist, torch.tensor(2.0, dtype=torch.float64), n_full=3,
                tol=1e-12)
    info = dict(replays=0, graph_launches=0)
    U, V, _ = entry.run(n_full=3, rem=1, info=info)
    assert info == dict(replays=4, graph_launches=0)
    host = tcommon.run_solver_loop(
        block, state(), None, None, max_iter=10, tol=1e-12, eval_every=3,
        initial_loss_fn=lambda s, h: torch.tensor(2.0, dtype=torch.float64))
    assert torch.equal(U, host[0][2]) and torch.equal(V, host[0][3])
    assert hist.tolist() == host[2]
    entry.close()
