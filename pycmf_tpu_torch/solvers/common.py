"""Shared solver machinery: static config, hyperparameters, host loop.

Counterpart of ``pycmf_tpu/solvers/common.py``. A solver is a step
``(X, Y, U, V, Z, hyper) → (U, V, Z)`` on tensors, driven by a host loop
that evaluates the loss every ``eval_every`` iterations. PyTorch runs
eagerly, so there is no compiled device loop: the loop syncs with the
device once per eval point, when it reads the loss.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ..ops.links import LINEAR, check_link
from ..ops.matmul import matmul


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Static solver configuration (the reference's fields)."""

    x_link: str = LINEAR
    y_link: str = LINEAR
    U_non_negative: bool = True
    V_non_negative: bool = True
    Z_non_negative: bool = True
    update_U: bool = True
    update_V: bool = True
    update_Z: bool = True
    has_Y: bool = True
    hessian_form: str = "gauss"  # 'gauss' | 'full'
    line_search_trials: int = 8
    sg_sample_ratio: float = 1.0
    use_pallas: bool = False     # the fused-kernel branch (reference's name)

    def __post_init__(self):
        check_link(self.x_link)
        check_link(self.y_link)
        if self.hessian_form not in ("gauss", "full"):
            raise ValueError("hessian_form must be 'gauss' or 'full'")
        if not (0.0 < self.sg_sample_ratio <= 1.0):
            raise ValueError("sg_sample_ratio must be in (0, 1]")
        if self.x_link != LINEAR or self.y_link != LINEAR:
            raise NotImplementedError(
                "sigmoid links are not ported yet (ROADMAP A3: sigmoid "
                "Newton with kernels K3-K5)")
        if self.sg_sample_ratio < 1.0:
            raise NotImplementedError(
                "sg_sample_ratio < 1 is not ported yet (ROADMAP A3: Newton "
                "column sampling)")
        if self.hessian_form != "gauss":
            raise NotImplementedError(
                "hessian_form='full' is not ported yet (ROADMAP A3)")


class Hyper(NamedTuple):
    """Numeric hyperparameters as Python floats rounded to the factor
    dtype; l1 and l2 are derived in that dtype, as the reference's traced
    scalars are."""

    alpha: float
    l1_ratio: float
    eps: float
    hessian_pertubation: float  # reference's spelling
    l1: float
    l2: float


def make_hyper(alpha=0.0, l1_ratio=0.0, eps=1e-10, hessian_pertubation=0.2,
               dtype=torch.float32) -> Hyper:
    def c(v):
        return torch.tensor(v, dtype=dtype)

    a, r = c(alpha), c(l1_ratio)
    return Hyper(float(a), float(r), float(c(eps)),
                 float(c(hessian_pertubation)), float(a * r),
                 float(a * (1.0 - r)))


class Coupled(NamedTuple):
    """A dense data matrix on the device plus fit-time constants."""

    A: torch.Tensor
    row_sq: Optional[torch.Tensor] = None    # (p,) per-row ‖aᵢ‖²
    row_sq_t: Optional[torch.Tensor] = None  # (q,) per-row norms of Aᵀ
    a_sq: Optional[torch.Tensor] = None      # ‖A‖²_F


def coupled_mm(C: Coupled, B: torch.Tensor,
               transpose: bool = False) -> torch.Tensor:
    """C.A @ B (or C.Aᵀ @ B)."""
    return matmul(C.A.mT if transpose else C.A, B)


def run_solver_loop(block_fn, state, hyper, rng, *, max_iter: int, tol: float,
                    eval_every: int, verbose: int = 0,
                    initial_loss_fn=None) -> tuple:
    """Host loop over blocks of ``eval_every`` iterations with the
    relative-decrease stopping rule

        stop when (L_prev − L) / L_init < tol

    checked after every block (the last block may be shorter). A non-finite
    loss raises FloatingPointError.
    """
    eval_every = max(1, min(eval_every, max_iter))
    loss_history: List[float] = []
    loss_iters: List[int] = []
    step_times: List[float] = []

    if initial_loss_fn is not None:
        loss_init = float(initial_loss_fn(state, hyper))
        loss_history.append(loss_init)
        loss_iters.append(0)
    else:
        loss_init = None

    prev_loss = loss_init
    n_iter = 0
    while n_iter < max_iter:
        n_steps = min(eval_every, max_iter - n_iter)
        t0 = time.perf_counter()
        state, loss, rng = block_fn(state, hyper, rng, n_steps)
        loss = float(loss)
        step_times.append(time.perf_counter() - t0)
        n_iter += n_steps
        if not np.isfinite(loss):
            raise FloatingPointError(
                f"non-finite loss ({loss}) at iteration {n_iter}; this "
                "usually means the problem scale overflows the compute "
                "dtype — try dtype='float64' (CPU), a larger "
                "hessian_pertubation (Newton), or alpha-regularization. "
                f"History so far: {loss_history}")
        loss_history.append(loss)
        loss_iters.append(n_iter)
        if verbose:
            print(f"[pycmf_tpu_torch] iter {n_iter:5d}  loss {loss:.8g}")
        if loss_init is None:
            loss_init = loss_history[0]
        if prev_loss is not None and loss_init > 0:
            if (prev_loss - loss) / loss_init < tol:
                break
        prev_loss = loss
    return state, n_iter, loss_history, loss_iters, step_times


def check_loop(loop: str) -> None:
    """'host' and 'device' both run the host loop (PyTorch has no compiled
    device-resident loop); the reference's names are accepted."""
    if loop not in ("host", "device"):
        raise ValueError("loop must be 'host' or 'device'")
