"""Link functions for CMF residual models.

Counterpart of ``pycmf_tpu/ops/links.py``: identity ("linear") and
elementwise sigmoid, applied to the factor product before the squared
residual ½‖A − f(M Bᵀ)‖²_F, with f' and f'' for the Newton solver.
"""
from __future__ import annotations

import torch

LINEAR = "linear"
SIGMOID = "sigmoid"

VALID_LINKS = (LINEAR, SIGMOID)


def check_link(name: str) -> str:
    if name not in VALID_LINKS:
        raise ValueError(f"link must be one of {VALID_LINKS}, got {name!r}")
    return name


def apply_link(name: str, t: torch.Tensor) -> torch.Tensor:
    """f(t)."""
    if name == LINEAR:
        return t
    return torch.sigmoid(t)


def link_and_grad(name: str, t: torch.Tensor):
    """Return (f(t), f'(t)) without recomputing the expensive part."""
    if name == LINEAR:
        return t, None  # f' == 1; callers special-case None as "ones"
    p = torch.sigmoid(t)
    return p, p * (1.0 - p)


def link_second_deriv(name: str, p: torch.Tensor) -> torch.Tensor:
    """f''(t) expressed in terms of p = f(t).

    sigmoid: f'' = p(1-p)(1-2p).  linear: 0.
    """
    if name == LINEAR:
        return torch.zeros_like(p)
    return p * (1.0 - p) * (1.0 - 2.0 * p)
