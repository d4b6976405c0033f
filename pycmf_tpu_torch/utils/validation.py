"""Input/parameter validation and device ingest.

Counterpart of ``pycmf_tpu/utils/validation.py``: host matrices (NumPy or
scipy.sparse) become ``Coupled`` operands on the device (dense, CSR,
BlockEll or chunked COO), with the per-row and total squared norms computed
once on the host in float64: from the unquantized values under float32 and
bf16 storage, from the stored (quantized) values under fp8, the
reference's loss convention for each.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from ..ops.chunked import chunked_from_scipy
from ..ops.kernels.bell import BELL_MIN_FILL, bell_from_scipy
from ..ops.links import LINEAR, SIGMOID
from ..ops.matmul import FP8_DTYPES
from ..ops.sparse import csr_transpose_host
from ..solvers.common import Coupled

# Sparse inputs whose dense copy (at the storage dtype) fits under this many
# bytes are densified on the device. The value is the reference's; choosing
# it for an 80 GB card is ROADMAP A7.
DENSIFY_THRESHOLD = 1 << 31  # 2 GB


def check_fp8_range(A, dtype) -> None:
    """Raise ValueError when |A| exceeds the fp8 storage range. The
    reference's conversion turns such values into NaN and fails the fit
    later; torch's saturates them to ±448 (e4m3), which would fit clipped
    data silently, so this check is the port's only guard."""
    fmax = float(torch.finfo(dtype).max)
    amax = float(abs(A).max() if not sp.issparse(A)
                 else (abs(A.data).max() if A.nnz else 0.0))
    if amax > fmax:
        raise ValueError(
            f"data max |x| = {amax:.4g} exceeds "
            f"{str(dtype).removeprefix('torch.')}'s range (±{fmax:.0f}); "
            "scale the data (e.g. X / c) or use data_dtype='bfloat16'")


def _norms(fdt, device, row_sq, col_sq, total) -> dict:
    def up(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64)).to(
            device=device, dtype=fdt)

    return dict(row_sq=up(row_sq), row_sq_t=up(col_sq), a_sq=up(total))


def as_coupled(A, dtype, device, use_pallas: bool = False,
               sparse_mode: str = "auto",
               densify_threshold: int = DENSIFY_THRESHOLD,
               chunked_ok: bool = False) -> Coupled:
    """Convert a host matrix to a ``Coupled`` on ``device``, stored at
    ``dtype`` (float32, float64, bfloat16 or float8_e4m3fn; norms at
    float32 under bf16 and fp8). fp8 data is stored dense only: its values
    are rounded to e4m3 as the reference's conversion rounds them (through
    float32), a sparse one densified through a transient float32 buffer on
    the device.

    sparse_mode (scipy.sparse input only; dense input uploads as is):
      'auto'    densify when the dense copy at the storage dtype fits
                ``densify_threshold``, else 'chunked' if ``chunked_ok``
                (the caller's consumer streams it), else 'csr';
      'csr'     keep CSR on the device, with the CSR of Aᵀ; under
                ``use_pallas``, BlockEll layouts of A and Aᵀ instead when
                both fit the threshold and fill at least
                ``bell.BELL_MIN_FILL``;
      'dense'   always densify;
      'chunked' the streamed chunked-COO layout (``ops/chunked.py``), with
                the host's norms.
    Under fp8 a matrix that resolves to 'csr' or 'chunked' raises
    ValueError, as in the reference.
    """
    fp8 = dtype in FP8_DTYPES
    fdt = torch.float32 if fp8 or dtype == torch.bfloat16 else dtype
    if fp8:
        check_fp8_range(A, dtype)

    if not sp.issparse(A):
        Ah = torch.from_numpy(np.ascontiguousarray(A)).to(dtype)
        # fp8: the norms of the stored values (the reference's convention)
        sq = (Ah.to(torch.float64).numpy() if fp8
              else np.asarray(A).astype(np.float64)) ** 2
        return Coupled(Ah.to(device),
                       **_norms(fdt, device, sq.sum(axis=1), sq.sum(axis=0),
                                sq.sum()))

    if sparse_mode not in ("auto", "csr", "dense", "chunked"):
        raise ValueError(
            f"sparse_mode must be 'auto', 'csr', 'dense' or 'chunked', "
            f"got {sparse_mode!r}")
    # fp8 densifies through a float32 buffer: its dense copy counts 4 bytes
    # per element against the threshold
    nbytes_dense = A.shape[0] * A.shape[1] * (4 if fp8 else dtype.itemsize)
    mode = sparse_mode
    if mode == "auto":
        mode = ("dense" if nbytes_dense <= densify_threshold
                else "chunked" if chunked_ok else "csr")
    if fp8 and mode == "chunked":
        raise ValueError(
            "fp8 data storage requires dense device form; the chunked "
            "streaming layout stores COO + a transient dense chunk — "
            "use data_dtype='bfloat16' for beyond-threshold X")
    if fp8 and mode == "csr":
        raise ValueError(
            "fp8 data storage requires dense device form, but this matrix "
            "resolves to CSR (sparse_mode="
            f"{sparse_mode!r}, dense copy {nbytes_dense / 2**30:.2f} GiB); "
            "use sparse_mode='dense', shrink the matrix, or "
            "data_dtype='bfloat16'")
    # Host float64 norms, stored at fdt (float32 under bf16 and fp8 data:
    # they feed the line-search objectives): of the unquantized values,
    # or under fp8 of the stored ones (rounded through float32, as the
    # device's scatter below and the reference round them).
    coo = A.tocoo()
    coo.sum_duplicates()
    n, m = A.shape
    vals = coo.data.astype(np.float32) if fp8 else coo.data
    sq64 = (torch.from_numpy(vals).to(dtype).to(torch.float64).numpy() if fp8
            else vals.astype(np.float64)) ** 2
    row_sq = np.bincount(coo.row, weights=sq64, minlength=n)
    col_sq = np.bincount(coo.col, weights=sq64, minlength=m)
    norms = _norms(fdt, device, row_sq, col_sq, sq64.sum())
    if mode == "chunked":
        return Coupled(chunked_from_scipy(coo, dtype, device), **norms)
    if mode == "csr":
        # ‖A‖² of a sparse layout is its own sq_norm (of the stored values)
        sparse_norms = dict(row_sq=norms["row_sq"],
                            row_sq_t=norms["row_sq_t"])
        if use_pallas:
            A_bell = bell_from_scipy(A, dtype, device,
                                     max_bytes=densify_threshold,
                                     min_fill=BELL_MIN_FILL)
            At_bell = (bell_from_scipy(A.T, dtype, device,
                                       max_bytes=densify_threshold,
                                       min_fill=BELL_MIN_FILL)
                       if A_bell is not None else None)
            if At_bell is not None:
                # every product and loss of the fit reads the BlockEll
                # layouts, so no CSR is built
                return Coupled(A_bell, At=At_bell, A_bell=A_bell,
                               At_bell=At_bell, **sparse_norms)
        C, Ct = csr_transpose_host(A, dtype, device)
        return Coupled(C, At=Ct, **sparse_norms)
    # Densify ON DEVICE: upload only the COO triplets and scatter them into
    # device zeros at the storage dtype (duplicates are summed on the host
    # first, so the scatter is exact); fp8 scatters into a transient
    # float32 buffer and converts it (the reference's scatter_densify).
    scat = torch.float32 if fp8 else dtype
    rows = torch.from_numpy(coo.row.astype(np.int64)).to(device)
    cols = torch.from_numpy(coo.col.astype(np.int64)).to(device)
    Ad = torch.zeros((n, m), dtype=scat, device=device)
    Ad.index_put_((rows, cols), torch.from_numpy(vals).to(device).to(scat))
    return Coupled(Ad.to(dtype) if fp8 else Ad, **norms)


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
