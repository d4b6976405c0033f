"""Masked per-row backtracking step selection: the one implementation of
the pinned accept rule shared by every PyTorch Newton path.

Counterpart of ``pycmf_tpu/ops/linesearch.py``. Candidates are steps 0.5ᵗ
for t = 0..trials-1; a candidate is accepted iff its per-row objective φ is
STRICTLY below φ(M); each row takes the FIRST (largest) accepted step, and
rows with no accepted candidate keep their value. trials <= 0 means a plain
(projected) Newton step. The CUDA Newton kernel (csrc/newton_fused.cu)
implements the same rule per row.
"""
from __future__ import annotations

import torch


def _steps(trials: int, M):
    """0.5ᵗ for t < trials, exact (halving is exact in binary floating
    point), built on M's device without a host copy."""
    half = torch.full((trials,), 0.5, dtype=M.dtype, device=M.device)
    return half.cumprod(0) * 2.0


def _first_accepted(accepted):
    """(index of the first True along dim 0, whether there is one)."""
    # argmax returns the first maximal index; bool has no argmax kernel
    return accepted.to(torch.int8).argmax(dim=0), accepted.any(dim=0)


def backtracking_select_table(phis, project, M, d, return_phi: bool = False):
    """Same accept rule from a precomputed φ table (rows, trials+1):
    slot 0 = φ(M), slot t = φ of project(M − 0.5^(t−1) d).

    return_phi: additionally return the per-row objective at the selected
    value (the accepted slot's φ, or slot 0 for rows that kept M)."""
    first, any_acc = _first_accepted((phis[:, 1:] < phis[:, :1]).T)
    s = _steps(phis.shape[1] - 1, M)[first][:, None]
    out = torch.where(any_acc[:, None], project(M - s * d), M)
    if return_phi:
        sel = torch.gather(phis[:, 1:], 1, first[:, None])[:, 0]
        return out, torch.where(any_acc, sel, phis[:, 0])
    return out


def backtracking_select(phi, project, M, d, trials: int,
                        return_phi: bool = False):
    """Select per-row updates of M along direction d (shape of M).

    phi(Mc) -> per-row objective over Mc's last axis: (rows,) for M and
    (trials, rows) for the stacked candidates, which are evaluated in one
    batch. project(Mc) -> Mc projected (applied BEFORE φ, so the accept
    test sees the feasible point).
    return_phi: additionally return φ at the selected value; requires
    trials >= 1 (a plain Newton step evaluates no objective)."""
    if trials <= 0:
        if return_phi:
            raise ValueError("return_phi needs trials >= 1")
        return project(M - d)
    cands = project(M[None] - _steps(trials, M)[:, None, None] * d[None])
    phi0 = phi(M)
    phis = phi(cands)
    first, any_acc = _first_accepted(phis < phi0[None])
    rows = torch.arange(M.shape[0], device=M.device)
    out = torch.where(any_acc[:, None], cands[first, rows], M)
    if return_phi:
        return out, torch.where(any_acc, phis[first, rows], phi0)
    return out
