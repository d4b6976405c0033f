"""The reference's column draws of a sampled sharded Newton fit, per rank
and per draw stream of the port (``pycmf_tpu_torch/parallel/sharded.py:
Draws``), computed in the test's process with ``jax.random`` on the
reference's key schedule:

- the fit loop folds the iteration into the key, ``fold_in(key, it)``
  (``pycmf_tpu/solvers/common.py:195``), and each iteration splits it
  into (kU, kZ, kV);
- term t of a factor draws with ``fold_in(k, t)``, a distributed term's
  key folded again with its axis index (``pycmf_tpu/solvers/newton.py:
  363-369``);
- the rows layout folds kU with the shard index before U's update
  (``pycmf_tpu/parallel/sharded.py:1288``), the cols layout kV
  (``:1498``), the grid kV with its COL index (``grid.py:479``).

A stream is named by its ``stream_seed`` key: () the stream every rank
shares, (0, r) a rows or cols rank's own, (1, j) the grid's mesh column j,
(2, i, j) its cell. The ranks get the draws as NumPy arrays
(``tests/_torch_dist.py:StreamDraws``).
"""
import jax
import numpy as np

from pycmf_tpu_torch.solvers.newton import sample_size


def _draw(key, q: int, ratio: float):
    s = sample_size(q, ratio)
    if s >= q:
        return None
    return q, np.array(jax.random.choice(key, q, shape=(s,), replace=False))


def _fold(key, *data):
    for d in data:
        key = jax.random.fold_in(key, d)
    return key


def fit_draws(layout: str, mesh, rank: int, *, seed: int, n_iter: int,
              n: int, m: int, ry, ratio: float, update_v: bool = True):
    """{stream key: [(q, indices), ...]}: one rank's draws over ``n_iter``
    iterations of a fit (U, Z when ``ry`` is Y's column count, V when
    ``update_v``) in ``layout`` on ``mesh`` ((d,) or the grid's (r, c)),
    in the order the port's step makes them."""
    out = {}

    def add(stream, key, q):
        d = _draw(key, q, ratio)
        if d is not None:
            out.setdefault(stream, []).append(d)

    base = jax.random.PRNGKey(seed)
    for it in range(n_iter):
        kU, kZ, kV = jax.random.split(jax.random.fold_in(base, it), 3)
        if layout == "rows":
            d = mesh[0]
            n_loc, own = -(-n // d), (0, rank)
            add(own, _fold(kU, rank, 0), m)
            if ry:
                add((), _fold(kZ, 0), m)
            if update_v:
                add(own, _fold(kV, 0, rank), n_loc)
                if ry:
                    add((), _fold(kV, 1), ry)
        elif layout == "cols":
            m_loc, own = -(-m // mesh[0]), (0, rank)
            add(own, _fold(kU, 0, rank), m_loc)
            if ry:
                add(own, _fold(kZ, 0, rank), m_loc)
            if update_v:
                add(own, _fold(kV, rank, 0), n)
                if ry:
                    add(own, _fold(kV, rank, 1), ry)
        else:
            r, c = mesh
            i, j = divmod(rank, c)
            n_loc, m_loc = -(-n // r), -(-m // c)
            add((1, j), _fold(kU, 0, j), m_loc)
            if ry:
                add((1, j), _fold(kZ, 0, j), m_loc)
            if update_v:
                add((2, i, j), _fold(kV, j, 0, i), n_loc)
                if ry:
                    add((1, j), _fold(kV, j, 1), ry)
    return out


def rank_draws(layout: str, mesh, *, transform_iters: int = 0, **kw):
    """{rank: {stream key: [fit's draws, (transform's draws)]}} over the
    mesh's ranks: each stream's list of uses, one per generator the rank
    draws from with that stream's seed, in order. With
    ``transform_iters``, the fold-in after the fit (the rows layout over
    every rank, U's update alone) adds a use to each rank's own stream
    (0, r)."""
    world = int(np.prod(mesh))
    out = {}
    for rank in range(world):
        uses = {key: [d] for key, d in fit_draws(
            layout, mesh, rank, **kw).items()}
        if transform_iters:
            t = fit_draws("rows", (world,), rank, **dict(
                kw, n_iter=transform_iters, ry=None, update_v=False))
            for key, d in t.items():
                uses.setdefault(key, []).append(d)
        out[rank] = uses
    return out
