"""Dense matmul with the reference's mixed-precision semantics.

Counterpart of ``pycmf_tpu/ops/matmul.py``.
"""
from __future__ import annotations

import torch

# float32 products on the card run in true float32. TF32 keeps ~1e-3
# relative error, and the Newton line search compares per-row objectives
# whose late-stage decreases are smaller than that: the reference measured
# a fit that stalled at +22% objective when one reduced-precision pass was
# allowed (pycmf_tpu/ops/pallas/newton_fused.py:59-70).
torch.backends.cuda.matmul.allow_tf32 = False

# Storage-only dtypes: data may be stored in them, factors never are.
LOW_DTYPES = (torch.bfloat16,)
# fp8 storage is not ported yet (ROADMAP A9); ingest and kernels refuse it.
FP8_DTYPES = (torch.float8_e4m3fn, torch.float8_e5m2)


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b. When either operand is bf16 (the ``data_dtype`` storage of the
    big data matrix), both are rounded to bf16 and multiplied with float32
    accumulation, returning float32 as the reference's MXU path does.
    The products of bf16 values are exact in float32, so upcasting after
    the rounding gives exactly those semantics; ``torch.matmul`` on two bf16
    tensors would round its output to bf16."""
    if a.dtype in LOW_DTYPES or b.dtype in LOW_DTYPES:
        return torch.matmul(a.to(torch.bfloat16).float(),
                            b.to(torch.bfloat16).float())
    if a.dtype != b.dtype:  # promote as jnp.matmul does
        dt = torch.promote_types(a.dtype, b.dtype)
        a, b = a.to(dt), b.to(dt)
    return torch.matmul(a, b)


def gram(m: torch.Tensor) -> torch.Tensor:
    """mᵀ m (k×k)."""
    return m.mT @ m
