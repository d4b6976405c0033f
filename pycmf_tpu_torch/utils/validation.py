"""Input/parameter validation and device ingest.

Counterpart of the dense parts of ``pycmf_tpu/utils/validation.py``: host
matrices (NumPy or scipy.sparse) become ``Coupled`` operands on the device,
with the per-row and total squared norms computed once on the host in
float64 from the unquantized values.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from ..ops.links import LINEAR, SIGMOID
from ..ops.matmul import FP8_DTYPES
from ..solvers.common import Coupled

# Sparse inputs whose dense copy (at the storage dtype) fits under this many
# bytes are densified on the device. The value is the reference's; choosing
# it for an 80 GB card is ROADMAP A7.
DENSIFY_THRESHOLD = 1 << 31  # 2 GB


def _norms(fdt, device, row_sq, col_sq, total) -> dict:
    def up(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64)).to(
            device=device, dtype=fdt)

    return dict(row_sq=up(row_sq), row_sq_t=up(col_sq), a_sq=up(total))


def as_coupled(A, dtype, device, sparse_mode: str = "auto",
               densify_threshold: int = DENSIFY_THRESHOLD) -> Coupled:
    """Convert a host matrix to a dense ``Coupled`` on ``device``, stored at
    ``dtype`` (float32, float64 or bfloat16; norms at float32 under bf16).

    sparse_mode (scipy.sparse input only; dense input uploads as is):
      'auto'  densify when the dense copy at the storage dtype fits
              ``densify_threshold``;
      'dense' always densify.
    Sparse device layouts ('csr', 'chunked', 'auto' past the threshold)
    are not ported yet (ROADMAP A7, A8).
    """
    if dtype in FP8_DTYPES:
        raise NotImplementedError(
            "fp8 data storage is not ported yet (ROADMAP A9)")
    fdt = torch.float32 if dtype == torch.bfloat16 else dtype

    if not sp.issparse(A):
        Ah = np.asarray(A)
        sq = Ah.astype(np.float64) ** 2
        return Coupled(torch.from_numpy(np.ascontiguousarray(Ah)).to(dtype)
                       .to(device),
                       **_norms(fdt, device, sq.sum(axis=1), sq.sum(axis=0),
                                sq.sum()))

    if sparse_mode not in ("auto", "csr", "dense", "chunked"):
        raise ValueError(
            f"sparse_mode must be 'auto', 'csr', 'dense' or 'chunked', "
            f"got {sparse_mode!r}")
    nbytes_dense = A.shape[0] * A.shape[1] * dtype.itemsize
    mode = sparse_mode
    if mode == "auto" and nbytes_dense <= densify_threshold:
        mode = "dense"
    if mode == "chunked":
        raise NotImplementedError(
            "sparse_mode='chunked' is not ported yet (ROADMAP A8)")
    if mode != "dense":
        raise NotImplementedError(
            f"sparse device storage is not ported yet (ROADMAP A7): this "
            f"matrix resolves to CSR (sparse_mode={sparse_mode!r}, dense copy "
            f"{nbytes_dense / 2**30:.2f} GiB); use sparse_mode='dense'")
    # Densify ON DEVICE: upload only the COO triplets and scatter them into
    # device zeros at the storage dtype (duplicates are summed on the host
    # first, so the scatter is exact).
    coo = A.tocoo()
    coo.sum_duplicates()
    n, m = A.shape
    sq64 = coo.data.astype(np.float64) ** 2
    row_sq = np.bincount(coo.row, weights=sq64, minlength=n)
    col_sq = np.bincount(coo.col, weights=sq64, minlength=m)
    rows = torch.from_numpy(coo.row.astype(np.int64)).to(device)
    cols = torch.from_numpy(coo.col.astype(np.int64)).to(device)
    vals = torch.from_numpy(coo.data).to(device).to(dtype)
    Ad = torch.zeros((n, m), dtype=dtype, device=device)
    Ad.index_put_((rows, cols), vals)
    return Coupled(Ad, **_norms(fdt, device, row_sq, col_sq, sq64.sum()))


def check_matrix(A, name: str, *, require_non_negative: bool,
                 require_finite: bool = True):
    if sp.issparse(A):
        data = A.data
    else:
        A = np.asarray(A)
        if A.ndim != 2:
            raise ValueError(f"{name} must be 2-D, got shape {A.shape}")
        data = A
    if data.size and require_finite and not np.all(np.isfinite(data)):
        raise ValueError(f"{name} contains NaN or infinity")
    if require_non_negative and data.size and (data < 0).any():
        raise ValueError(
            f"{name} contains negative entries, which the multiplicative-"
            "update solver cannot handle; use solver='newton'")
    return A


def validate_cmf_params(*, n_components, solver, x_link, y_link,
                        U_non_negative, V_non_negative, Z_non_negative,
                        alpha, l1_ratio, tol, max_iter, sg_sample_ratio):
    if n_components is not None and (not isinstance(n_components, (int, np.integer))
                                     or n_components <= 0):
        raise ValueError(f"n_components must be a positive int, got {n_components!r}")
    if solver not in ("mu", "newton"):
        raise ValueError(f"solver must be 'mu' or 'newton', got {solver!r}")
    for nm, link in (("x_link", x_link), ("y_link", y_link)):
        if link not in (LINEAR, SIGMOID):
            raise ValueError(f"{nm} must be 'linear' or 'sigmoid', got {link!r}")
    if solver == "mu":
        # MU is the Lee–Seung scheme: linear links, non-negative factors.
        if x_link != LINEAR or y_link != LINEAR:
            raise ValueError("solver='mu' supports only linear links; "
                             "use solver='newton' for sigmoid links")
        if not (U_non_negative and V_non_negative and Z_non_negative):
            raise ValueError("solver='mu' requires all factors non-negative; "
                             "use solver='newton' to allow negative factors")
    if not (0 <= l1_ratio <= 1):
        raise ValueError(f"l1_ratio must be in [0, 1], got {l1_ratio}")
    if alpha < 0:
        raise ValueError(f"alpha must be >= 0, got {alpha}")
    if max_iter <= 0:
        raise ValueError(f"max_iter must be positive, got {max_iter}")
    if tol < 0:
        raise ValueError(f"tol must be >= 0, got {tol}")
    if not (0.0 < sg_sample_ratio <= 1.0):
        raise ValueError(f"sg_sample_ratio must be in (0, 1], got {sg_sample_ratio}")
