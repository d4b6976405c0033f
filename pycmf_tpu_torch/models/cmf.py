"""Collective Matrix Factorization estimator (sklearn-style API) on PyTorch.

Counterpart of ``pycmf_tpu/models/cmf.py``: ``CMF(n_components=k, ...)``
jointly factors

    X ≈ U Vᵀ   (X: n×m)
    Y ≈ V Zᵀ   (Y: m×r, optional)

with a shared V, NumPy in and NumPy out. Validation and initialization run
on the host (the same NumPy draws as the reference for one
``random_state``); the solver loop runs on ``device``. The keyword surface
is the reference's plus ``device``. The port runs linear and sigmoid links
on dense or densified data, linear links on CSR data
(``sparse_mode='csr'``, or 'auto' past the densify threshold), and both on
the streamed chunked-COO layout (``sparse_mode='chunked'``, or 'auto' past
the threshold for a sigmoid-linked matrix under Newton). Newton runs full
batch or sampled (``sg_sample_ratio`` < 1: stochastic minibatch Newton,
its column draws the reference's, under ``PRNGKey`` of the reference's
seed rule from ``random_state``: ``ops/random.py``), with the Gauss-Newton or the full Hessian
(``hessian_form``). ``data_dtype='fp8'`` stores X dense as float8_e4m3fn
(Y then at bf16), contracted in bf16 as the reference does. ``n_shards``
> 1 fits row-, column- or grid-sharded over a torch.distributed process
group, one process per shard or cell (``parallel/sharded.py``,
``parallel/grid.py``), sampled Newton, the chunked layout and the device
loop included (over NCCL on the card, each block's collectives captured
into the fit's CUDA graphs). Beside fit
and transform, the reference's sklearn surface: ``components_``,
``inverse_transform``, ``get_feature_names_out``, ``print_topic_terms``,
``set_output``, metadata routing and sklearn's changed-only repr; sklearn
itself is imported only inside the methods that need it (the tags, the
routing, the HTML repr: the card's machine has none).
"""
from __future__ import annotations

import importlib
import inspect
import sys
import warnings

import numpy as np
import scipy.sparse as sp
import torch

from ..ops.matmul import FP8_DTYPES
from ..ops.random import prng_key
from ..parallel.grid import factor_grid, run_grid
from ..parallel.mesh import broadcast, captures, group_size, make_mesh
from ..parallel.sharded import check_shardable, run_sharded
from ..solvers.common import SolverConfig, make_hyper
from ..solvers.mu import run_mu
from ..solvers.newton import captures_on_card, run_newton
from ..utils.convert import (factors_from_numpy, factors_to_numpy,
                             fitted_state_from_reference)
from ..utils.init import initialize_factors
from ..utils.validation import (DENSIFY_THRESHOLD, as_coupled, check_matrix,
                                validate_cmf_params)

_DTYPES = {
    "float32": torch.float32,
    "float64": torch.float64,
    "bfloat16": torch.bfloat16,
}
_FP8_NAMES = ("fp8", "float8_e4m3fn")
_REPR_WIDTH = 80  # sklearn's pretty printer's line width
# set_output's containers (sklearn's ADAPTERS_MANAGER.supported_outputs)
_OUTPUTS = ("default", "pandas", "polars")


def _is_nan(v) -> bool:
    return isinstance(v, (float, np.floating)) and bool(np.isnan(v))


def _sklearn_html():
    """(sklearn.get_config, sklearn's estimator_html_repr); AttributeError
    when sklearn cannot be imported (the repr hooks are then absent)."""
    try:
        from sklearn import get_config
        from sklearn.utils import estimator_html_repr
    except ImportError:
        raise AttributeError("the HTML repr needs scikit-learn") from None
    return get_config, estimator_html_repr


def _container_library(name: str):
    """The library of set_output's container ``name``, imported here only;
    a missing one raises sklearn's ImportError."""
    try:
        return importlib.import_module(name)
    except ImportError as exc:
        raise ImportError(f"Setting output container to '{name}' requires "
                          f"{name} to be installed") from exc


def _seed(random_state) -> int:
    """The seed of the fit's sampling key from a sklearn-style
    random_state, by the reference's rule (``pycmf_tpu/models/cmf.py:
    _jax_seed``): an int is itself, a RandomState its state's first word
    (read, not consumed), None 0."""
    if isinstance(random_state, np.random.RandomState):
        return int(random_state.get_state()[1][0])
    if isinstance(random_state, (int, np.integer)):
        return int(random_state)
    return 0


def _key(random_state, device: torch.device) -> torch.Tensor:
    """The reference's ``jax.random.PRNGKey(_jax_seed(random_state))`` on
    ``device`` (``ops/random.prng_key`` of :func:`_seed`): stochastic
    Newton draws its columns under it, the reference's columns."""
    return prng_key(_seed(random_state), device)


class CMF:
    """Collective Matrix Factorization.

    Parameters are the reference's (``pycmf_tpu.CMF``), with its defaults:
    n_components, solver ('mu' | 'newton'), alpha, l1_ratio, tol, max_iter,
    random_state, verbose, U/V/Z_non_negative, x_link, y_link, x_init,
    y_init, hessian_pertubation, sg_sample_ratio, eps, dtype, eval_every,
    use_pallas, hessian_form, line_search_trials, n_shards, shard_layout,
    sparse_mode, loop, data_dtype. Here:

    use_pallas : None (on) | bool. The kernel branch: the U pass of each
        solver on dense X, every MU ratio tail, every sigmoid-linked Newton
        update, every per-row Newton solve and every product with CSR data
        (BlockEll or CSR kernels) run through hand-written CUDA kernels on
        the card (their plain PyTorch versions on the CPU). False runs the
        unfused plain PyTorch path.
    sparse_mode : 'auto' | 'csr' | 'dense' | 'chunked', per matrix (see
        ``_matrix_sparse_mode`` and ``_chunked_ok``).
    loop : 'auto' | 'host' | 'device'. 'host' runs every eval block
        eagerly and syncs with the device once per eval point. 'device'
        is the reference's device-resident loop, the loss history and the
        stop rule on the device. On the card the first fit of a config and
        shapes replays a CUDA graph of one eval block per block; the next
        fit of that key builds the cache's one entry (a copy of the fit's
        data, when it takes at most 1/8 of the card's memory), and it and
        every later fit of the key run as one launch of a CUDA graph (the
        eval block inside a conditional while node) and one readback; a
        sampled fit replays the cached eval block per block. On the CPU
        the same schedule runs eagerly. Under n_shards > 1 every rank runs
        it, on the same branch (see shard_layout).
        ``pycmf_tpu_torch.solvers.common.clear_fit_cache()``
        frees the cache. See _resolve_loop.
    device : 'cuda' (default) | 'cpu' | a torch.device. 'cuda' raises when
        CUDA is not available.
    n_shards : None | int | -1 | 'all' | (rows, cols). Above 1, the fit
        (and transform) is sharded over the default torch.distributed
        process group, whose size it must equal (-1 and 'all': the group's
        size; a tuple, shard_layout='grid' only: rows·cols). Every rank
        calls fit with the whole X and Y and gets the same result; a rank
        computes on ``device`` ('cuda': ``cuda:$LOCAL_RANK``, else the rank
        modulo the visible cards).
    shard_layout : 'rows' (X's rows and U sharded) | 'cols' (the shared
        dimension: X's columns, Y's rows and V sharded) | 'grid' (X's
        cells over a (rows, cols) mesh: the tuple, or an int's
        ``factor_grid``). transform folds in by rows, over every rank,
        whatever the fit's layout. Under shards both loops run dense,
        densified, CSR or chunked data (fp8 dense), full batch or sampled
        (each rank's draws the reference's, its keys folded per rank as
        the reference folds them); ``loop='device'`` runs the device loop
        on every rank, its collectives captured into the
        graphs, which on CUDA tensors needs an NCCL group (ValueError over
        gloo) and on the CPU runs eagerly (``parallel/sharded.py``,
        ``parallel/grid.py``). Free the fit cache
        (``solvers.common.clear_fit_cache``) before destroying the group:
        its graphs hold the group's communicator.

    Attributes: U_, V_, Z_ (NumPy float64), reconstruction_err_, n_iter_,
    loss_history_, loss_iters_, step_times_, n_components_.
    """

    def __init__(self, n_components=None, solver="mu", alpha=0.0,
                 l1_ratio=0.0, tol=1e-4, max_iter=200, random_state=None,
                 verbose=0, U_non_negative=True, V_non_negative=True,
                 Z_non_negative=True, x_link="linear", y_link="linear",
                 x_init="random", y_init="random", hessian_pertubation=0.2,
                 sg_sample_ratio=1.0, eps=1e-10, dtype="float32",
                 eval_every=10, use_pallas=None, hessian_form="gauss",
                 line_search_trials=8, n_shards=None, shard_layout="rows",
                 sparse_mode="auto", loop="auto", data_dtype=None,
                 device="cuda"):
        self.n_components = n_components
        self.solver = solver
        self.alpha = alpha
        self.l1_ratio = l1_ratio
        self.tol = tol
        self.max_iter = max_iter
        self.random_state = random_state
        self.verbose = verbose
        self.U_non_negative = U_non_negative
        self.V_non_negative = V_non_negative
        self.Z_non_negative = Z_non_negative
        self.x_link = x_link
        self.y_link = y_link
        self.x_init = x_init
        self.y_init = y_init
        self.hessian_pertubation = hessian_pertubation
        self.sg_sample_ratio = sg_sample_ratio
        self.eps = eps
        self.dtype = dtype
        self.eval_every = eval_every
        self.use_pallas = use_pallas
        self.hessian_form = hessian_form
        self.line_search_trials = line_search_trials
        self.n_shards = n_shards
        self.shard_layout = shard_layout
        self.sparse_mode = sparse_mode
        self.loop = loop
        self.data_dtype = data_dtype
        self.device = device

    # -- parameters (written by hand: the card's machine has no sklearn) ---

    @classmethod
    def _param_names(cls):
        return [p for p in inspect.signature(cls.__init__).parameters
                if p != "self"]

    def get_params(self, deep=True):
        return {name: getattr(self, name) for name in self._param_names()}

    def set_params(self, **params):
        valid = set(self._param_names())
        for name, value in params.items():
            if name not in valid:
                raise ValueError(f"invalid parameter {name!r} for CMF")
            setattr(self, name, value)
        return self

    def __repr__(self):
        """sklearn's repr (``print_changed_only``): the parameters whose
        repr differs from their default's (NaN equal to NaN), sorted by
        name, filled into lines of 80 columns as sklearn's pretty printer
        fills them."""
        defaults = {name: p.default for name, p in
                    inspect.signature(type(self).__init__).parameters.items()}

        def changed(name, value):
            d = defaults[name]
            return repr(value) != repr(d) and not (_is_nan(value)
                                                   and _is_nan(d))

        head = type(self).__name__ + "("
        items = [f"{k}={v!r}" for k, v in sorted(self.get_params().items())
                 if changed(k, v)]
        one_line = head + ", ".join(items) + ")"
        if len(one_line) <= _REPR_WIDTH:
            return one_line
        # sklearn's compact fill: each item takes its length + 2 of a line
        # of width - indent + 1 columns, the last also its closing ")"
        indent = len(head)
        out, delim = [head], ""
        width = max_width = _REPR_WIDTH - indent + 1
        for i, rep in enumerate(items):
            if i == len(items) - 1:
                width -= 1
                max_width -= 1
            w = len(rep) + 2
            if width < w:
                width = max_width
                if delim:
                    delim = ",\n" + " " * indent
            width -= w
            out += [delim, rep]
            delim = ", "
        return "".join(out) + ")"

    # -- internals ---------------------------------------------------------

    def _resolve_device(self) -> torch.device:
        dev = torch.device(self.device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' but torch.cuda.is_available() is False; pass "
                "device='cpu' to run the plain PyTorch path on the CPU")
        if dev.type not in ("cuda", "cpu"):
            raise ValueError(f"device must be 'cuda' or 'cpu', got {dev}")
        return dev

    def _resolve_n_shards(self):
        """None or a positive int, passed through; -1 or 'all': the size of
        the default process group (ValueError when there is none); a
        (rows, cols) tuple under shard_layout='grid': rows·cols (under
        another layout the reference's ValueError). Any other value raises,
        as in the reference (``pycmf_tpu/models/cmf.py:161-197``): a typo
        such as n_shards=0 must not fit on one device."""
        ns = self.n_shards
        if ns is None:
            return None
        if isinstance(ns, (tuple, list)):
            if len(ns) == 2 and all(
                    isinstance(v, (int, np.integer))
                    and not isinstance(v, bool) and v >= 1 for v in ns):
                if self.shard_layout != "grid":
                    raise ValueError(
                        "a (rows, cols) n_shards tuple requires "
                        "shard_layout='grid'")
                return int(ns[0]) * int(ns[1])
            raise ValueError(
                f"n_shards={ns!r} not understood; a tuple must be two "
                "positive ints (rows, cols) with shard_layout='grid'")
        resolved = None
        if isinstance(ns, str) and ns.lower() == "all":
            resolved = group_size()
        elif isinstance(ns, (int, np.integer)) and not isinstance(ns, bool):
            if ns == -1:
                resolved = group_size()
            elif ns >= 1:
                resolved = int(ns)
        if resolved is None:
            raise ValueError(
                f"n_shards={ns!r} not understood; use a positive int, -1, "
                "'all', a (rows, cols) tuple, or None")
        if resolved > 1:
            check_shardable(layout=self.shard_layout)
        return resolved

    def _sharded(self) -> bool:
        ns = self._resolve_n_shards()
        return ns is not None and ns > 1

    def _resolve_grid(self):
        """(rows, cols) of the grid layout's mesh: a tuple as given, else
        ``factor_grid`` of the resolved count (n_shards=2 is (1, 2)).
        Reference: ``pycmf_tpu/models/cmf.py:_resolve_grid``."""
        ns = self.n_shards
        if isinstance(ns, (tuple, list)):
            return int(ns[0]), int(ns[1])
        return factor_grid(self._resolve_n_shards())

    def _resolve_dtype(self, which=None):
        dt = which if which is not None else self.dtype
        if isinstance(dt, str):
            if dt in _FP8_NAMES:
                dt = torch.float8_e4m3fn
            elif dt in _DTYPES:
                dt = _DTYPES[dt]
            else:
                raise ValueError(
                    f"dtype must be one of {list(_DTYPES) + list(_FP8_NAMES)}")
        if which is None and dt in FP8_DTYPES:
            raise ValueError(
                "fp8 is a data storage dtype, not a factor/compute "
                "dtype; pass it as data_dtype='fp8' with dtype='float32'")
        if which is None and dt == torch.bfloat16:
            raise ValueError(
                "dtype='bfloat16' is not a factor/compute dtype (factor "
                "updates need f32 precision); use data_dtype='bfloat16' to "
                "halve the data-pass traffic instead")
        return dt

    def _resolve_data_dtype(self):
        """Storage dtype of X on the device: ``data_dtype``, else
        ``dtype``. 'bfloat16' halves the data passes' traffic and 'fp8'
        (float8_e4m3fn, dense X only) halves it again; factors and all
        accumulation stay in ``dtype``."""
        if self.data_dtype is None:
            return self._resolve_dtype()
        return self._resolve_dtype(self.data_dtype)

    def _y_dtype(self):
        """Storage dtype of Y: X's, except bf16 under fp8 X (the reference
        quantizes only the big matrix; ``as_coupled`` then counts Y's
        dense copy at 2 bytes per element)."""
        ddt = self._resolve_data_dtype()
        return torch.bfloat16 if ddt in FP8_DTYPES else ddt

    def _resolve_loop(self, cfg=None):
        """The reference's rule: 'auto' → the device loop on a CUDA device
        and the host loop on the CPU (where the device loop only runs the
        same blocks eagerly); verbose > 0 takes the host loop under 'auto',
        as in the reference. Under n_shards > 1 likewise, whatever the
        layout: the device loop on CUDA tensors over an NCCL group (the
        default process group's), the host loop over gloo, whose
        collectives of CUDA tensors a graph cannot capture. One more case
        takes the host loop under 'auto': a Newton fit on the card that the
        device loop cannot capture (``solvers/newton.captures_on_card``:
        per-row systems through a library's batched solve, which is the
        plain path's, use_pallas=False; ROADMAP C3), where an explicit
        'device' raises. An explicit 'host' or 'device' is honoured
        ('device' over gloo on CUDA tensors raises ValueError). cfg: the
        fit's SolverConfig (default: with Y)."""
        if self.loop not in ("auto", "host", "device"):
            raise ValueError("loop must be 'auto', 'host' or 'device'")
        if self.loop != "auto":
            return self.loop
        dev = self._resolve_device()
        if self.verbose or dev.type != "cuda":
            return "host"
        if self._sharded() and not captures(dev):
            return "host"
        if self.solver == "newton" and not captures_on_card(
                cfg if cfg is not None else self._config(has_Y=True)):
            return "host"
        return "device"

    def _use_pallas(self) -> bool:
        return self.use_pallas is None or bool(self.use_pallas)

    def _matrix_sparse_mode(self, A, link, is_x: bool = True):
        """Per-matrix sparse policy (the reference's, on one device). A
        sigmoid-linked sparse matrix under Newton is densified under
        'dense' and 'csr' (the update materializes dense sigmoid
        predictions of the same size anyway) and streamed under
        'chunked'; under 'auto' as_coupled densifies it below the densify
        threshold and streams it past it (``_chunked_ok``), X or Y alike.
        Under n_shards > 1 'auto' densifies it, as the reference's sharded
        fits do. For a linear-linked Y, 'chunked' resolves as 'auto'."""
        if self._chunked_ok(link) and sp.issparse(A):
            if self.sparse_mode == "chunked" or (
                    self.sparse_mode == "auto" and not self._sharded()):
                return self.sparse_mode
            if self.sparse_mode == "csr":
                warnings.warn(
                    "sparse_mode='csr' is overridden to 'dense' for a "
                    "sigmoid-linked matrix under solver='newton': the "
                    "Newton update materializes dense sigmoid predictions "
                    "of the same size anyway (sparse_mode='chunked' "
                    "streams them per row chunk)", UserWarning,
                    stacklevel=3)
            return "dense"
        if not is_x and self.sparse_mode == "chunked":
            return "auto"
        return self.sparse_mode

    def _stays_sparse(self, A) -> bool:
        """Whether host matrix A stays CSR or chunked on the device (is not
        densified) under sparse_mode, by as_coupled's storage-byte rule: fp8
        counts 4 bytes per element (its densify goes through a float32
        buffer). Under n_shards > 1 each shard or cell is sized alone (the
        rows layout's ⌈n/d⌉·m, the cols layout's n·⌈m/d⌉, the grid's
        ⌈n/r⌉·⌈m/c⌉), fp8 at 1 byte per element (densified on the host).
        Reference: ``pycmf_tpu/models/cmf.py:_stays_sparse``."""
        if not sp.issparse(A) or self.sparse_mode == "dense":
            return False
        if self.sparse_mode in ("csr", "chunked"):
            return True
        ddt = self._resolve_data_dtype()
        n, m = A.shape
        sharded = self._sharded()
        item = (1 if sharded else 4) if ddt in FP8_DTYPES else ddt.itemsize
        if sharded and self.shard_layout == "grid":
            r, c = self._resolve_grid()
            n, m = -(-n // r), -(-m // c)
        elif sharded and self.shard_layout == "cols":
            m = -(-m // self._resolve_n_shards())
        elif sharded:
            n = -(-n // self._resolve_n_shards())
        return n * m * item > DENSIFY_THRESHOLD

    def _chunked_ok(self, link) -> bool:
        """Whether 'auto' streams a sparse matrix past the densify
        threshold (as_coupled's chunked_ok): only a sigmoid-linked one
        under Newton, which has no other path there. The reference streams
        a linear-linked one too (its per-nonzero products ran ~79× slower
        than a dense chunk on the TPU); the port keeps it CSR, whose
        kernels on the card take a few ms per product where a chunked
        iteration must zero, scatter and read the whole dense equivalent
        (ROADMAP A7 re-decides it on measured numbers). 'chunked' by name
        streams any matrix X."""
        return self.solver == "newton" and link == "sigmoid"

    def _config(self, has_Y, update_U=True, update_V=True, update_Z=True):
        return SolverConfig(
            x_link=self.x_link, y_link=self.y_link,
            U_non_negative=self.U_non_negative,
            V_non_negative=self.V_non_negative,
            Z_non_negative=self.Z_non_negative,
            update_U=update_U, update_V=update_V, update_Z=update_Z,
            has_Y=has_Y, hessian_form=self.hessian_form,
            line_search_trials=self.line_search_trials,
            sg_sample_ratio=self.sg_sample_ratio,
            use_pallas=self._use_pallas())

    def _validate(self, X, Y):
        validate_cmf_params(
            n_components=self.n_components, solver=self.solver,
            x_link=self.x_link, y_link=self.y_link,
            U_non_negative=self.U_non_negative,
            V_non_negative=self.V_non_negative,
            Z_non_negative=self.Z_non_negative, alpha=self.alpha,
            l1_ratio=self.l1_ratio, tol=self.tol, max_iter=self.max_iter,
            sg_sample_ratio=self.sg_sample_ratio)
        if self._sharded():
            check_shardable(layout=self.shard_layout)
        mu = self.solver == "mu"
        X = check_matrix(X, "X", require_non_negative=mu)
        if Y is not None:
            Y = check_matrix(Y, "Y", require_non_negative=mu)
        if self._resolve_data_dtype() in FP8_DTYPES:
            # fp8 stores X dense only (Y is bf16); the rule follows the
            # per-matrix decision, so a sigmoid-linked Newton X that
            # _matrix_sparse_mode densifies passes
            if sp.issparse(X) and self._matrix_sparse_mode(
                    X, self.x_link) != "dense" and self._stays_sparse(X):
                raise ValueError(
                    "data_dtype='fp8' requires dense device storage, but "
                    f"X stays CSR under sparse_mode={self.sparse_mode!r}; "
                    "use sparse_mode='dense' (or 'auto' below the densify "
                    "threshold)")
        return X, Y

    def _run(self, Xc, Yc, U0, V0, Z0, cfg):
        hyper = make_hyper(self.alpha, self.l1_ratio, self.eps,
                           self.hessian_pertubation, dtype=U0.dtype)
        kw = dict(max_iter=self.max_iter, tol=self.tol,
                  eval_every=self.eval_every, verbose=self.verbose,
                  loop=self._resolve_loop(cfg))
        if self.solver == "mu":
            return run_mu(Xc, Yc, U0, V0, Z0, cfg, hyper, **kw)
        return run_newton(Xc, Yc, U0, V0, Z0, cfg, hyper,
                          _key(self.random_state, U0.device), **kw)

    def _run_sharded(self, X, Y, U0, V0, Z0, cfg, layout=None):
        """The sharded fit on this rank (``parallel/sharded.py``, the grid
        layout ``parallel/grid.py``) in ``layout`` (default:
        shard_layout), from the first rank's U0, V0 and Z0: a draw without
        a fixed random_state differs between processes. A sampled Newton
        fit draws under the key of the reference's rule (:func:`_seed`),
        folded per rank as the reference folds it."""
        self._resolve_device()
        mesh = make_mesh(self._resolve_n_shards(), device=self.device)
        dt = self._resolve_dtype()
        ddt = self._resolve_data_dtype()

        def first_rank(a):
            if a is None:
                return None
            t = torch.as_tensor(np.asarray(a, dtype=np.float64)).to(
                mesh.device)
            return broadcast(mesh, t).cpu().numpy()

        U0, V0, Z0 = (first_rank(a) for a in (U0, V0, Z0))
        hyper = make_hyper(self.alpha, self.l1_ratio, self.eps,
                           self.hessian_pertubation, dtype=dt)
        layout = layout or self.shard_layout
        kw = dict(group=mesh.group, dtype=dt,
                  data_dtype=None if ddt == dt else ddt, device=mesh.device,
                  max_iter=self.max_iter, tol=self.tol,
                  eval_every=self.eval_every, verbose=self.verbose,
                  loop=self._resolve_loop(cfg),
                  sparse_mode=self._matrix_sparse_mode(X, self.x_link),
                  seed=_seed(self.random_state))
        if layout == "grid":
            return run_grid(self.solver, X, Y, U0, V0, Z0, cfg, hyper,
                            grid=self._resolve_grid(), **kw)
        return run_sharded(self.solver, X, Y, U0, V0, Z0, cfg, hyper,
                           n_shards=mesh.world, layout=layout, **kw)

    # -- public API (reference parity) -------------------------------------

    def fit_transform(self, X, Y=None, U=None, V=None, Z=None):
        """Fit the model to (X, Y) and return the factors (U, V, Z).

        U/V/Z, when given, are the initial factors (warm start / resume).
        U is in the container :meth:`set_output` chose."""
        U_, V_, Z_ = self._fit(X, Y, U, V, Z)
        return self._wrap_output(U_, X), V_, Z_

    def _fit(self, X, Y=None, U=None, V=None, Z=None):
        X, Y = self._validate(X, Y)
        if self.n_components is None:
            raise ValueError("n_components must be set")
        k = int(self.n_components)
        dev = self._resolve_device()
        dt = self._resolve_dtype()
        ddt = self._resolve_data_dtype()
        cfg = self._config(has_Y=Y is not None)

        U0, V0, Z0 = initialize_factors(
            X, Y, k, x_init=self.x_init, y_init=self.y_init,
            U_non_negative=self.U_non_negative,
            V_non_negative=self.V_non_negative,
            Z_non_negative=self.Z_non_negative,
            random_state=self.random_state, U=U, V=V, Z=Z)

        if self._sharded():
            Uf, Vf, Zf, n_iter, losses, iters, times = self._run_sharded(
                X, Y, U0, V0, Z0, cfg)
        else:
            up = self._use_pallas()
            Xc = as_coupled(X, ddt, dev, use_pallas=up,
                            sparse_mode=self._matrix_sparse_mode(
                                X, self.x_link),
                            chunked_ok=self._chunked_ok(self.x_link))
            Yc = (as_coupled(Y, self._y_dtype(), dev, use_pallas=up,
                             sparse_mode=self._matrix_sparse_mode(
                                 Y, self.y_link, is_x=False),
                             chunked_ok=self._chunked_ok(self.y_link))
                  if Y is not None else None)
            U0, V0, Z0 = factors_from_numpy(U0, V0, Z0, dev, dt)
            if Z0 is None:
                Z0 = torch.zeros((0, k), dtype=dt, device=dev)
            Uf, Vf, Zf, n_iter, losses, iters, times = self._run(
                Xc, Yc, U0, V0, Z0, cfg)

        self.U_, self.V_, self.Z_ = factors_to_numpy(
            Uf, Vf, Zf if Y is not None else None)
        self.n_iter_ = int(n_iter)
        self.loss_history_ = [float(v) for v in losses]
        self.loss_iters_ = list(iters)
        self.step_times_ = list(times)
        self.reconstruction_err_ = self.loss_history_[-1]
        self.n_components_ = k
        return self.U_, self.V_, self.Z_

    def fit(self, X, Y=None, **params):
        """Fit and return self."""
        self.fit_transform(X, Y, **params)
        return self

    def transform(self, X, U=None):
        """Fold-in: solve for U on new rows of X holding the fitted V fixed,
        returned in the container :meth:`set_output` chose.

        The initial U is the reference's draw: a fresh
        ``RandomState(random_state)`` (or the given RandomState)."""
        return self._wrap_output(self._transform(X, U), X)

    def _transform(self, X, U=None):
        if not hasattr(self, "V_"):
            raise RuntimeError("transform called before fit")
        mu = self.solver == "mu"
        X = check_matrix(X, "X", require_non_negative=mu)
        n, m = X.shape
        if m != self.V_.shape[0]:
            raise ValueError(
                f"X has {m} columns; fitted V expects {self.V_.shape[0]}")
        k = self.n_components_
        dev = self._resolve_device()
        dt = self._resolve_dtype()

        if U is None:
            rng_np = (self.random_state
                      if isinstance(self.random_state, np.random.RandomState)
                      else np.random.RandomState(
                          self.random_state
                          if isinstance(self.random_state, (int, np.integer))
                          else None))
            mean = float(X.mean())
            avg = np.sqrt(max(abs(mean), 1e-12) / k)
            U0 = avg * rng_np.standard_normal((n, k))
            if self.U_non_negative:
                np.abs(U0, out=U0)
        else:
            U0 = np.asarray(U, dtype=np.float64)

        cfg = self._config(has_Y=False, update_U=True, update_V=False,
                           update_Z=False)
        if self._sharded():
            # the rows layout over every rank whatever the fit's: the new
            # rows are the axis
            Uf = self._run_sharded(X, None, U0, self.V_, None, cfg,
                                   layout="rows")[0]
            return factors_to_numpy(Uf, None, None)[0]
        Xc = as_coupled(X, self._resolve_data_dtype(), dev,
                        use_pallas=self._use_pallas(),
                        sparse_mode=self._matrix_sparse_mode(X, self.x_link),
                        chunked_ok=self._chunked_ok(self.x_link))
        U0, V0, _ = factors_from_numpy(U0, self.V_, None, dev, dt)
        Z0 = torch.zeros((0, k), dtype=dt, device=dev)
        Uf = self._run(Xc, None, U0, V0, Z0, cfg)[0]
        return factors_to_numpy(Uf, None, None)[0]

    def get_feature_names_out(self, input_features=None):
        """Names of the k output columns of transform (sklearn pipelines):
        ``cmf0 .. cmf{k-1}``."""
        if not hasattr(self, "n_components_"):
            raise AttributeError(
                "get_feature_names_out is only available after fit")
        return np.asarray([f"cmf{i}" for i in range(self.n_components_)],
                          dtype=object)

    # -- sklearn's mixin surface, without sklearn on the import path -----

    def set_output(self, *, transform=None):
        """The container of transform's and fit_transform's U: 'default'
        (NumPy, or sklearn's global ``transform_output`` when sklearn is
        imported and no setting was made here), 'pandas' or 'polars' (that
        library imported at the call that needs it), as sklearn's
        ``set_output``; None leaves the setting as it is."""
        if transform is None:
            return self
        if not hasattr(self, "_sklearn_output_config"):
            self._sklearn_output_config = {}
        self._sklearn_output_config["transform"] = transform
        return self

    def _wrap_output(self, data, X):
        """``data`` (transform's output for input X) in the chosen
        container, as sklearn's ``_wrap_data_with_container`` makes it:
        columns ``get_feature_names_out()``, X's index if X has one."""
        config = getattr(self, "_sklearn_output_config", {})
        sklearn = sys.modules.get("sklearn")
        if "transform" in config:
            dense = config["transform"]
        elif sklearn is not None:
            dense = sklearn.get_config()["transform_output"]
        else:
            dense = "default"
        if dense not in _OUTPUTS:
            raise ValueError(f"output config must be in {sorted(_OUTPUTS)}, "
                             f"got {dense}")
        if dense == "default":
            return data
        columns = self.get_feature_names_out()
        if dense == "polars":
            pl = _container_library("polars")
            return pl.DataFrame(data, schema=columns.tolist(), orient="row")
        pd = _container_library("pandas")
        index = X.index if isinstance(X, (pd.DataFrame, pd.Series)) else None
        out = pd.DataFrame(data, index=index, copy=False)
        out.columns = columns
        return out

    @classmethod
    def _get_class_level_metadata_request_values(cls, method_name,
                                                 method=None,
                                                 ignore_params=None):
        from sklearn.utils._metadata_requests import _MetadataRequester

        return _MetadataRequester._get_class_level_metadata_request_values \
            .__func__(cls, method_name, method, ignore_params)

    def _get_metadata_request(self):
        from sklearn.utils._metadata_requests import _MetadataRequester

        return _MetadataRequester._get_metadata_request(self)

    def get_metadata_routing(self):
        """sklearn's MetadataRequest of this estimator: ``U`` routed to
        transform and inverse_transform (sklearn imported here only)."""
        return self._get_metadata_request()

    def _set_request(self, method: str, **kwargs):
        from sklearn.utils._metadata_requests import RequestMethod

        keys = sorted(self._get_class_level_metadata_request_values(method))
        return RequestMethod(method, keys).__get__(self, type(self))(**kwargs)

    def set_transform_request(self, **kwargs):
        """sklearn's ``set_transform_request`` (``U=True`` etc.; needs
        ``sklearn.set_config(enable_metadata_routing=True)``)."""
        return self._set_request("transform", **kwargs)

    def set_inverse_transform_request(self, **kwargs):
        """sklearn's ``set_inverse_transform_request``."""
        return self._set_request("inverse_transform", **kwargs)

    @property
    def _repr_html_(self):
        """sklearn's HTML repr when sklearn is importable and its
        ``display`` is 'diagram'; otherwise absent (AttributeError, so
        ``hasattr`` is False)."""
        get_config, html = _sklearn_html()
        if get_config()["display"] != "diagram":
            raise AttributeError("_repr_html_ is only defined when the "
                                 "'display' configuration option is set to "
                                 "'diagram'")
        return lambda: html(self)

    @property
    def _repr_mimebundle_(self):
        """sklearn's mime bundle (text/plain, and text/html under the
        'diagram' display) when sklearn is importable; otherwise absent."""
        get_config, html = _sklearn_html()

        def bundle(**kwargs):
            out = {"text/plain": repr(self)}
            if get_config()["display"] == "diagram":
                out["text/html"] = html(self)
            return out

        return bundle

    @property
    def components_(self):
        """sklearn-NMF-style components (k × m): X ≈ transform(X) @
        components_."""
        if not hasattr(self, "V_"):
            raise AttributeError("components_ is only available after fit")
        return self.V_.T

    def inverse_transform(self, U):
        """X's rows rebuilt from factor rows: f_x(U Vᵀ), in NumPy."""
        if not hasattr(self, "V_"):
            raise RuntimeError("inverse_transform called before fit")
        T = np.asarray(U) @ self.V_.T
        if self.x_link == "sigmoid":
            return 1.0 / (1.0 + np.exp(-T))
        return T

    def print_topic_terms(self, vectorizer=None, vocabulary=None,
                          factor="U", n_top_words=10, file=None):
        """Print (to ``file``) and return the top-weighted terms of each
        component of ``factor`` ('U', 'V' or 'Z'). In the 20NG orientation
        (X = term×document, Y = document×label) the term factor is U; pass
        factor='V' when the vocabulary indexes X's columns."""
        from ..utils.analysis import topic_terms_string

        M = {"U": getattr(self, "U_", None),
             "V": getattr(self, "V_", None),
             "Z": getattr(self, "Z_", None)}[factor]
        if M is None:
            raise RuntimeError("model is not fitted (or factor is absent)")
        s = topic_terms_string(M, vectorizer=vectorizer,
                               vocabulary=vocabulary,
                               n_top_words=n_top_words)
        print(s, file=file)
        return s

    def __sklearn_tags__(self):
        """The reference's tags (a BaseEstimator's), which sklearn reads
        in a Pipeline's transform. sklearn is imported here only: the
        package does not need it."""
        from sklearn.utils import InputTags, Tags, TargetTags

        return Tags(estimator_type=None,
                    target_tags=TargetTags(required=False),
                    transformer_tags=None, input_tags=InputTags())

    @classmethod
    def from_reference(cls, ref, device="cuda"):
        """A fitted port estimator from a fitted ``pycmf_tpu.CMF``: its
        params, factors and fit history, read through its public surface."""
        state = fitted_state_from_reference(ref)
        names = set(cls._param_names())
        est = cls(**{k: v for k, v in state["params"].items() if k in names},
                  device=device)
        for name, value in state["fitted"].items():
            setattr(est, name, value)
        return est
