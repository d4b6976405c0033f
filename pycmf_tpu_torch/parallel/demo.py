"""A sharded fit, one process per shard, under torchrun:

    torchrun --nproc-per-node 2 -m pycmf_tpu_torch.parallel.demo \\
        --backend gloo --device cpu --docs 2000 --terms 3000

(``--backend nccl --device cuda`` on a machine with a card per process;
``--layout cols`` shards the shared dimension instead of X's rows,
``--layout grid --grid R C`` X's cells over an R×C mesh of R·C processes).
Every rank fits ``CMF(n_shards=<world size, or (R, C)>,
shard_layout=<layout>)`` on the whole 20NG-shaped surrogate; rank 0 prints
what it got and the single-device fit's loss beside it (under NCCL
``loop='auto'`` is the device loop, its collectives captured into the fit's
CUDA graphs; over gloo the host loop).
"""
from __future__ import annotations

import argparse

import torch.distributed as dist

from ..models.cmf import CMF
from ..solvers.common import clear_fit_cache
from ..utils.datasets import synthetic_20ng


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--backend", required=True, choices=("gloo", "nccl"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--docs", type=int, default=11314)
    ap.add_argument("--terms", type=int, default=30000)
    ap.add_argument("--solver", default="mu", choices=("mu", "newton"))
    ap.add_argument("--max-iter", type=int, default=50)
    ap.add_argument("--layout", default="rows",
                    choices=("rows", "cols", "grid"))
    ap.add_argument("--grid", type=int, nargs=2, metavar=("R", "C"),
                    help="the grid layout's mesh (default: factor_grid of "
                    "the world size)")
    args = ap.parse_args(argv)
    dist.init_process_group(args.backend)
    try:
        X, Y = synthetic_20ng(n_docs=args.docs, n_terms=args.terms,
                              random_state=0)
        kw = dict(n_components=20, solver=args.solver, random_state=0,
                  max_iter=args.max_iter, device=args.device)
        shards = (tuple(args.grid) if args.layout == "grid" and args.grid
                  else dist.get_world_size())
        est = CMF(n_shards=shards, shard_layout=args.layout, **kw).fit(X, Y)
        if dist.get_rank() == 0:
            single = CMF(**kw).fit(X, Y)
            print(f"{dist.get_world_size()} shards: n_iter {est.n_iter_}, "
                  f"loss {est.reconstruction_err_:.9g}; one device: n_iter "
                  f"{single.n_iter_}, loss {single.reconstruction_err_:.9g}; "
                  f"layout {args.layout}"
                  + (" {}x{}".format(*est._resolve_grid())
                     if args.layout == "grid" else ""), flush=True)
    finally:
        clear_fit_cache()  # its graphs hold the group's communicator
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
