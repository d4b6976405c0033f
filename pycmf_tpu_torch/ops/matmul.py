"""Dense matmul with the reference's mixed-precision semantics and its
precision control.

Counterpart of ``pycmf_tpu/ops/matmul.py``. The reference names three
precisions of a float32 product; on the card each is a rounding of the
operands, chosen per call (no process-wide flag is read or set):

- ``'highest'`` (the default): the true float32 product;
- ``'high'``: both operands rounded to TF32 (10 mantissa bits, coarser than
  the TPU's bf16×3 passes), products exact and summed in float32, as a TF32
  tensor-core product does;
- ``'default'``: both operands rounded to bf16, summed in float32: the
  TPU's single bf16 pass.

On the CPU every setting gives the float32 (or float64) product, as JAX on
the CPU does. bf16 and fp8 operands take the bf16 product whatever the
setting, as in the reference.
"""
from __future__ import annotations

import torch

# float32 products on the card run in true float32. TF32 keeps ~1e-3
# relative error, and the Newton line search compares per-row objectives
# whose late-stage decreases are smaller than that: the reference measured
# a fit that stalled at +22% objective when one reduced-precision pass was
# allowed (pycmf_tpu/ops/pallas/newton_fused.py:59-70).
torch.backends.cuda.matmul.allow_tf32 = False

# Storage-only dtypes: data may be stored in them, factors never are. fp8
# (the estimator stores it as float8_e4m3fn) contracts in bf16, as the
# reference's MXU path does: every e4m3 value is exact in bf16.
FP8_DTYPES = (torch.float8_e4m3fn, torch.float8_e5m2)
LOW_DTYPES = (torch.bfloat16,) + FP8_DTYPES


def operand_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype a data matrix stored at ``dtype`` is contracted in, and
    that the factors are rounded to before a product with it: bf16 for fp8
    storage (V and U_new are never rounded below bf16), else ``dtype``."""
    return torch.bfloat16 if dtype in FP8_DTYPES else dtype


def storage_view(A: torch.Tensor) -> torch.Tensor:
    """A as uint8 when it is fp8, else A: indexing and copies of fp8 go
    through the byte view, which every op takes (torch's float8 coverage
    is thin, on the CPU and on the card), bit for bit."""
    return A.view(torch.uint8) if A.dtype in FP8_DTYPES else A


def contiguous_t(A: torch.Tensor) -> torch.Tensor:
    """The contiguous copy of Aᵀ, at A's dtype."""
    return storage_view(A).mT.contiguous().view(A.dtype)


def select_columns(A: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """A[:, idx], at A's dtype."""
    return storage_view(A).index_select(1, idx).view(A.dtype)


PRECISIONS = ("default", "high", "highest")
_PRECISION = "highest"


def _precision_name(p) -> str:
    """The reference's name of precision ``p``: one of PRECISIONS, or an
    object whose ``.name`` is DEFAULT, HIGH or HIGHEST (a
    ``jax.lax.Precision``). Anything else raises ValueError (the reference
    stores it and fails at its next product)."""
    name = p if isinstance(p, str) else getattr(p, "name", None)
    if isinstance(name, str) and name.lower() in PRECISIONS:
        return name.lower()
    raise ValueError(f"precision must be one of {PRECISIONS} or a "
                     f"jax.lax.Precision, got {p!r}")


def set_default_precision(p) -> None:
    """Set the precision of float32 products that name none (module
    docstring); the reference's ``set_default_precision``."""
    global _PRECISION
    _PRECISION = _precision_name(p)


def get_default_precision() -> str:
    """The precision float32 products take when they name none."""
    return _PRECISION


def _round_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 t rounded to TF32's 10 mantissa bits, to nearest with ties
    away from zero (``cvt.rna.tf32.f32``); NaN and ±inf as they are."""
    r = ((t.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isfinite(t), r, t)


def _rounded(a: torch.Tensor, b: torch.Tensor, precision):
    """(a, b) rounded as ``precision`` (None: the default) asks for a
    float32 product on the card."""
    name = _PRECISION if precision is None else _precision_name(precision)
    if name == "highest" or not (a.is_cuda and a.dtype == torch.float32
                                 and b.dtype == torch.float32):
        return a, b
    if name == "high":
        return _round_tf32(a), _round_tf32(b)
    return a.to(torch.bfloat16).float(), b.to(torch.bfloat16).float()


def matmul(a: torch.Tensor, b: torch.Tensor, precision=None) -> torch.Tensor:
    """a @ b. When either operand is bf16 or fp8 (the ``data_dtype``
    storage of the big data matrix), both are rounded to bf16 and
    multiplied with float32 accumulation, returning float32 as the
    reference's MXU path does, whatever ``precision`` says. The products of
    bf16 values are exact in float32, so upcasting after the rounding gives
    exactly those semantics; ``torch.matmul`` on two bf16 tensors would
    round its output to bf16. float32 products on the card take
    ``precision`` (None: :func:`get_default_precision`)."""
    if a.dtype in LOW_DTYPES or b.dtype in LOW_DTYPES:
        return torch.matmul(a.to(torch.bfloat16).float(),
                            b.to(torch.bfloat16).float())
    if a.dtype != b.dtype:  # promote as jnp.matmul does
        dt = torch.promote_types(a.dtype, b.dtype)
        a, b = a.to(dt), b.to(dt)
    return torch.matmul(*_rounded(a, b, precision))


def gram(m: torch.Tensor, precision=None) -> torch.Tensor:
    """mᵀ m (k×k), at ``precision`` as :func:`matmul` takes it."""
    return torch.matmul(*_rounded(m.mT, m, precision))
