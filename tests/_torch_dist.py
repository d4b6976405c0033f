"""Run a function on every rank of a gloo process group of spawned CPU
processes, for the tests of the port's sharded fits.

The ranks meet at a ``FileStore`` (no TCP port: the suite runs several
workers at once) and import only this module, torch, numpy, scipy and the
port, never JAX. Each rank writes what its function returns to a file; a
rank's exception reaches the caller, and a run past its time limit kills
every rank and raises, so a hang cannot stall the suite.
"""
from __future__ import annotations

import pickle
import sys
import time
from pathlib import Path

import numpy as np

JOIN_TIMEOUT = 240.0


def _rank_main(rank, world, store_path, out_dir, fn, args):
    import torch
    import torch.distributed as dist

    from pycmf_tpu_torch.solvers.common import clear_fit_cache

    torch.set_num_threads(1)
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        out = fn(rank, *args)
        out = {"result": out, "jax_imported": "jax" in sys.modules}
        with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(out, f)
    finally:
        clear_fit_cache()  # a cached device fit's graphs hold the group
        dist.destroy_process_group()


class Spawned:
    """The ranks of one spawn; :meth:`join` waits for them (within the time
    limit left) and returns each rank's result, in rank order."""

    def __init__(self, ctx, world, out_dir, deadline):
        self.ctx, self.world, self.out_dir = ctx, world, out_dir
        self.deadline = deadline

    def join(self):
        try:
            while not self.ctx.join(timeout=max(
                    0.0, self.deadline - time.monotonic())):
                if time.monotonic() >= self.deadline:
                    raise TimeoutError(
                        f"the {self.world} ranks did not finish within "
                        f"{JOIN_TIMEOUT:.0f} s")
        finally:
            for p in self.ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join(5)
        outs = []
        for r in range(self.world):
            with open(Path(self.out_dir) / f"rank{r}.pkl", "rb") as f:
                out = pickle.load(f)
            if out["jax_imported"]:
                raise AssertionError(f"rank {r} imported jax")
            outs.append(out["result"])
        return outs


def spawn(fn, world: int, tmp_dir, *args,
          timeout: float = JOIN_TIMEOUT) -> Spawned:
    """Start fn(rank, *args) on ``world`` spawned ranks of a gloo group;
    returns at once (:meth:`Spawned.join` for the results). fn and args
    must pickle, and fn's module must not import JAX."""
    import torch.multiprocessing as mp

    tmp_dir = Path(tmp_dir)
    tmp_dir.mkdir(parents=True, exist_ok=True)
    store = tmp_dir / "store"
    if store.exists():
        store.unlink()
    ctx = mp.start_processes(
        _rank_main, args=(world, str(store), str(tmp_dir), fn, args),
        nprocs=world, join=False, start_method="spawn")
    return Spawned(ctx, world, tmp_dir, time.monotonic() + timeout)


# ---------------------------------------------------------------------------
# what the ranks run
# ---------------------------------------------------------------------------


def _fitted(est):
    return {"U": est.U_, "V": est.V_, "Z": est.Z_, "n_iter": est.n_iter_,
            "losses": list(est.loss_history_),
            "iters": list(est.loss_iters_)}


def _case_patches(case, rank):
    """The patches a case asks for: 'threshold' (the sharded layouts' densify
    threshold, bytes), 'chunk_rows' (the chunked layout's rows per chunk;
    the shapes of the chunked layouts built are then listed in
    case['_built']) and 'no_cache_rank' (on that rank alone the fit cache
    may copy nothing: ``fit_cache_limit`` 0). Returns an ExitStack."""
    from contextlib import ExitStack
    from unittest import mock

    from pycmf_tpu_torch.ops import chunked
    from pycmf_tpu_torch.parallel import sharded
    from pycmf_tpu_torch.solvers import common

    stack = ExitStack()
    if case.get("no_cache_rank") == rank:
        stack.enter_context(mock.patch.object(common, "fit_cache_limit",
                                              lambda device: 0))
    if "threshold" in case:
        stack.enter_context(mock.patch.object(
            sharded, "DENSIFY_THRESHOLD", case["threshold"]))
    if "chunk_rows" in case:
        rows = case["chunk_rows"]
        stack.enter_context(mock.patch.object(
            chunked, "pick_chunk_rows", lambda *a, **k: rows))
        # and the shapes of the chunked layouts the fit builds
        from pycmf_tpu_torch.utils import validation

        built, make = [], validation.chunked_from_scipy

        def spy(A, *args, **kw):
            built.append(tuple(A.shape))
            return make(A, *args, **kw)
        stack.enter_context(mock.patch.object(validation,
                                              "chunked_from_scipy", spy))
        case["_built"] = built
    return stack


def _run_layout(case, group=None):
    """run_sharded (or run_grid when the case has 'grid') on ``group``
    (default: the default group), float64 on the CPU: the case's solver,
    X, Y, init, cfg (a SolverConfig's fields), hyper (make_hyper's
    arguments) and run keywords."""
    import torch

    from pycmf_tpu_torch.parallel.grid import run_grid
    from pycmf_tpu_torch.parallel.sharded import run_sharded
    from pycmf_tpu_torch.solvers.common import SolverConfig, make_hyper

    init = case["init"]
    args = (case["solver"], case["X"], case.get("Y"), init["U"], init["V"],
            init.get("Z"), SolverConfig(**case["cfg"]),
            make_hyper(*case.get("hyper", ()), dtype=torch.float64))
    kw = dict(case["run"], dtype=torch.float64, device="cpu", group=group)
    if "grid" in case:
        out = run_grid(*args, grid=case["grid"], **kw)
    else:
        out = run_sharded(*args, **kw)
    U, V, Z, n_iter, losses, iters, _ = out
    return {"U": U.numpy(), "V": V.numpy(), "Z": Z.numpy(),
            "n_iter": int(n_iter), "losses": [float(v) for v in losses],
            "iters": list(iters)}


def _fit_once(kind, case):
    """One fit of a 'fit' or 'run' case: its result, with what COMM
    counted in it ('comm': calls, bytes, by axis) and the device loop's
    record ('info': LAST_FIT, empty on the host loop)."""
    from pycmf_tpu_torch import CMF
    from pycmf_tpu_torch.parallel.mesh import COMM
    from pycmf_tpu_torch.solvers.common import LAST_FIT

    COMM.reset()
    LAST_FIT.clear()
    if kind == "run":
        res = _run_layout(case)
    else:
        est = CMF(device="cpu", **case["kw"])
        est.fit(case["X"], case.get("Y"), **case.get("init", {}))
        res = _fitted(est)
        if case.get("Xn") is not None:
            res["transform"] = est.transform(case["Xn"], U=case.get("Un"))
    res["comm"] = (COMM.calls, COMM.nbytes,
                   {a: list(v) for a, v in COMM.by_axis.items()})
    res["info"] = dict(LAST_FIT)
    return res


def _new_group_fit(case):
    """The case's run on a new group of every rank, its cache entry freed
    and the group destroyed after: (result, LAST_FIT)."""
    import torch.distributed as dist

    from pycmf_tpu_torch.solvers.common import LAST_FIT, clear_fit_cache

    group = dist.new_group(list(range(dist.get_world_size())))
    try:
        LAST_FIT.clear()
        res = _run_layout(case, group=group)
        return res, dict(LAST_FIT)
    finally:
        clear_fit_cache()
        dist.destroy_process_group(group)


def run_cases(rank, cases):
    """Each case on this rank, in order; {name: result}. A case is a dict:

    kind 'fit': CMF(device='cpu', **kw).fit(X, Y, U=, V=, Z=), and when
        'Xn' is given, transform(Xn) after it (its U0 'Un');
        'threshold', 'chunk_rows' and 'no_cache_rank' patch the densify
        threshold, the chunk rows and one rank's fit cache limit (see
        _case_patches); the result holds the fit's COMM counts ('comm')
        and device-loop record ('info'); with 'repeat' n the fit runs n
        times from an emptied fit cache (the device loop's first fit of
        its key, the fit that builds the cache entry, hits), the result
        the first's with every fit's result under 'fits';
    kind 'run': run_sharded or run_grid called directly (_run_layout),
        with the same patches and 'repeat', and with 'new_group' one more
        run on a new group of every rank ('new_group': its result and
        LAST_FIT), after which the cache is emptied and the group
        destroyed;
    kind 'raises': that fit, which must raise: (type name, message);
    kind 'sigmoid': fused_sigmoid_update on this rank's columns of X
        (rank r of d takes columns [r·q/d, (r+1)·q/d)) with the group;
    kind 'newton_factor': newton_update_factor with a distributed term on
        this rank's columns and a local one;
    kind 'grid_meshes': make_grid_mesh at each of the case's 'shapes' in
        turn, then again: whether each shape got its first axis groups
        back, and one all-reduce of (rank + 1) on each axis of the first
        shape with what COMM counted per axis.
    """
    from pycmf_tpu_torch import CMF
    from pycmf_tpu_torch.solvers.common import clear_fit_cache

    out = {}
    for name, case in cases.items():
        kind = case["kind"]
        case = dict(case)
        if kind in ("fit", "run"):
            stack = _case_patches(case, rank)
            with stack:
                if "repeat" in case:
                    clear_fit_cache()
                    fits = [_fit_once(kind, case)
                            for _ in range(case["repeat"])]
                    res = dict(fits[0], fits=fits)
                    if case.get("new_group"):
                        res["new_group"] = _new_group_fit(case)
                    clear_fit_cache()
                else:
                    res = _fit_once(kind, case)
            if "_built" in case:
                res["chunked"] = case["_built"]
            out[name] = res
        elif kind == "raises":
            try:
                CMF(device="cpu", **case["kw"]).fit(case["X"], case.get("Y"))
            except Exception as e:  # noqa: BLE001 -- reported to the test
                out[name] = (type(e).__name__, str(e))
            else:
                out[name] = None
        elif kind == "sigmoid":
            out[name] = _sigmoid_case(rank, case)
        elif kind == "newton_factor":
            out[name] = _newton_factor_case(rank, case)
        elif kind == "grid_meshes":
            out[name] = _grid_meshes_case(rank, case)
        else:
            raise ValueError(f"unknown case kind {kind!r}")
    return out


def _shard_cols(A, rank, d):
    q = A.shape[-1] if A.ndim == 1 else A.shape[1]
    w = q // d
    return slice(rank * w, (rank + 1) * w)


def _sigmoid_case(rank, case):
    import torch

    from pycmf_tpu_torch.parallel.mesh import make_mesh
    from pycmf_tpu_torch.solvers.common import make_hyper
    from pycmf_tpu_torch.solvers.newton import Term, fused_sigmoid_update

    mesh = make_mesh(device="cpu")
    t = lambda a: None if a is None else torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a, dtype=np.float64))
    cols = _shard_cols(case["X"], rank, mesh.world)
    hyper = make_hyper(*case["hyper"], dtype=torch.float64)
    yterm = Term(t(case["Y"]), t(case["Z"])) if "Y" in case else None
    out = fused_sigmoid_update(
        t(case["M"]), t(case["X"][:, cols]), t(case["B"][cols]), hyper,
        trials=case["trials"], non_negative=case["non_negative"],
        use_pallas=True, yterm=yterm, y_link=case.get("y_link", "linear"),
        row_mask=t(case.get("row_mask")), group=mesh,
        return_phi=case["return_phi"])
    if case["return_phi"]:
        return out[0].numpy(), out[1].numpy()
    return out.numpy()


def _newton_factor_case(rank, case):
    import torch

    from pycmf_tpu_torch.parallel.mesh import make_mesh
    from pycmf_tpu_torch.solvers.common import make_hyper
    from pycmf_tpu_torch.solvers.newton import Term, newton_update_factor

    mesh = make_mesh(device="cpu")
    t = lambda a: None if a is None else torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a, dtype=np.float64))
    cols = _shard_cols(case["D"], rank, mesh.world)
    hyper = make_hyper(*case["hyper"], dtype=torch.float64)
    mask = case.get("mask")
    terms = (Term(t(case["D"][:, cols]), t(case["B"][cols])),
             Term(t(case["D2"]), t(case["B2"])))
    out = newton_update_factor(
        None, t(case["M"]), terms, (case["link"], case["link2"]), hyper,
        non_negative=case["non_negative"], trials=case["trials"],
        use_pallas=False, distributed=(True, False),
        masks=(None if mask is None else t(mask[cols]), None), group=mesh,
        return_phi=True)
    return out[0].numpy(), out[1].numpy()


def _grid_meshes_case(rank, case):
    import torch

    from pycmf_tpu_torch.parallel import mesh as tmesh

    shapes = case["shapes"]
    first = [tmesh.make_grid_mesh(*s, device="cpu") for s in shapes]
    again = [tmesh.make_grid_mesh(*s, device="cpu") for s in shapes]
    reused = [a.row.group is b.row.group and a.col.group is b.col.group
              for a, b in zip(first, again)]
    gm = first[0]
    tmesh.COMM.reset()
    x = torch.full((3,), float(rank + 1), dtype=torch.float64)
    sums = {ax: tmesh.all_reduce(m, x)[0].tolist()
            for ax, m in (("row", gm.row), ("col", gm.col))}
    return dict(reused=reused, sums=sums,
                by_axis={a: list(v) for a, v in tmesh.COMM.by_axis.items()})
