"""Collective Matrix Factorization estimator (sklearn-style API) on PyTorch.

Counterpart of ``pycmf_tpu/models/cmf.py``: ``CMF(n_components=k, ...)``
jointly factors

    X ≈ U Vᵀ   (X: n×m)
    Y ≈ V Zᵀ   (Y: m×r, optional)

with a shared V, NumPy in and NumPy out. Validation and initialization run
on the host (the same NumPy draws as the reference for one
``random_state``); the solver loop runs on ``device``. The keyword surface
is the reference's plus ``device``. This slice runs linear links on dense
or densified data; the rest raises NotImplementedError naming the ROADMAP
item that brings it.
"""
from __future__ import annotations

import inspect

import numpy as np
import torch

from ..ops.matmul import FP8_DTYPES
from ..solvers.common import SolverConfig, make_hyper
from ..solvers.mu import run_mu
from ..solvers.newton import run_newton
from ..utils.convert import (factors_from_numpy, factors_to_numpy,
                             fitted_state_from_reference)
from ..utils.init import initialize_factors
from ..utils.validation import as_coupled, check_matrix, validate_cmf_params

_DTYPES = {
    "float32": torch.float32,
    "float64": torch.float64,
    "bfloat16": torch.bfloat16,
}
_FP8_NAMES = ("fp8", "float8_e4m3fn")


class CMF:
    """Collective Matrix Factorization.

    Parameters are the reference's (``pycmf_tpu.CMF``), with its defaults:
    n_components, solver ('mu' | 'newton'), alpha, l1_ratio, tol, max_iter,
    random_state, verbose, U/V/Z_non_negative, x_link, y_link, x_init,
    y_init, hessian_pertubation, sg_sample_ratio, eps, dtype, eval_every,
    use_pallas, hessian_form, line_search_trials, n_shards, shard_layout,
    sparse_mode, loop, data_dtype. Here:

    use_pallas : None (on) | bool. The fused-kernel branch: the U pass of
        each solver runs as one call of a hand-written CUDA kernel on the
        card (its plain PyTorch version on the CPU). False runs the unfused
        plain PyTorch path.
    loop : 'auto' | 'host' | 'device'. Every value runs the host loop,
        which syncs with the device once per eval point.
    device : 'cuda' (default) | 'cpu' | a torch.device. 'cuda' raises when
        CUDA is not available.

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
        args = ", ".join(f"{k}={v!r}" for k, v in self.get_params().items())
        return f"CMF({args})"

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
        if dt in FP8_DTYPES:
            if which is None:
                raise ValueError(
                    "fp8 is a data storage dtype, not a factor/compute "
                    "dtype; pass it as data_dtype='fp8' with dtype='float32'")
            raise NotImplementedError(
                "fp8 data storage is not ported yet (ROADMAP A9)")
        if which is None and dt == torch.bfloat16:
            raise ValueError(
                "dtype='bfloat16' is not a factor/compute dtype (factor "
                "updates need f32 precision); use data_dtype='bfloat16' to "
                "halve the data-pass traffic instead")
        return dt

    def _resolve_data_dtype(self):
        if self.data_dtype is None:
            return self._resolve_dtype()
        return self._resolve_dtype(self.data_dtype)

    def _resolve_loop(self):
        if self.loop not in ("auto", "host", "device"):
            raise ValueError("loop must be 'auto', 'host' or 'device'")
        return "host"

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
            use_pallas=self.use_pallas is None or bool(self.use_pallas))

    def _validate(self, X, Y):
        validate_cmf_params(
            n_components=self.n_components, solver=self.solver,
            x_link=self.x_link, y_link=self.y_link,
            U_non_negative=self.U_non_negative,
            V_non_negative=self.V_non_negative,
            Z_non_negative=self.Z_non_negative, alpha=self.alpha,
            l1_ratio=self.l1_ratio, tol=self.tol, max_iter=self.max_iter,
            sg_sample_ratio=self.sg_sample_ratio)
        if self.n_shards not in (None, 1):
            raise NotImplementedError(
                "n_shards is not ported yet (ROADMAP A10: sharding on "
                "torch.distributed)")
        mu = self.solver == "mu"
        X = check_matrix(X, "X", require_non_negative=mu)
        if Y is not None:
            Y = check_matrix(Y, "Y", require_non_negative=mu)
        return X, Y

    def _run(self, Xc, Yc, U0, V0, Z0, cfg):
        hyper = make_hyper(self.alpha, self.l1_ratio, self.eps,
                           self.hessian_pertubation, dtype=U0.dtype)
        kw = dict(max_iter=self.max_iter, tol=self.tol,
                  eval_every=self.eval_every, verbose=self.verbose,
                  loop=self._resolve_loop())
        if self.solver == "mu":
            return run_mu(Xc, Yc, U0, V0, Z0, cfg, hyper, **kw)
        return run_newton(Xc, Yc, U0, V0, Z0, cfg, hyper, None, **kw)

    # -- public API (reference parity) -------------------------------------

    def fit_transform(self, X, Y=None, U=None, V=None, Z=None):
        """Fit the model to (X, Y) and return the factors (U, V, Z).

        U/V/Z, when given, are the initial factors (warm start / resume)."""
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

        Xc = as_coupled(X, ddt, dev, sparse_mode=self.sparse_mode)
        Yc = (as_coupled(Y, ddt, dev, sparse_mode=self.sparse_mode)
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
        """Fold-in: solve for U on new rows of X holding the fitted V fixed.

        The initial U is the reference's draw: a fresh
        ``RandomState(random_state)`` (or the given RandomState)."""
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
        Xc = as_coupled(X, self._resolve_data_dtype(), dev,
                        sparse_mode=self.sparse_mode)
        U0, V0, _ = factors_from_numpy(U0, self.V_, None, dev, dt)
        Z0 = torch.zeros((0, k), dtype=dt, device=dev)
        Uf = self._run(Xc, None, U0, V0, Z0, cfg)[0]
        return factors_to_numpy(Uf, None, None)[0]

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
