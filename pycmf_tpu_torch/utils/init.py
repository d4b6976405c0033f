"""Factor initialization (host-side, NumPy).

Counterpart of ``pycmf_tpu/utils/init.py``, kept line for line so that the
same ``random_state`` gives byte-identical initial factors in both packages.

Follows sklearn's ``_initialize_nmf`` conventions as the reference does
(SURVEY.md §0 "Initialization"): seeded random init scaled by
sqrt(mean(A)/k), plus the NNDSVD family for non-negative warm starts.
Initialization is O(one SVD) host work done once per fit — it stays on the
host; only the solver loop runs on the device.

The shared factor V receives contributions from both X (as its column
factor) and Y (as its row factor); we average the two when both are
available. This is a pinned assumption (the reference mount is empty —
SURVEY.md provenance notice); the binding parity mechanism is externally
supplied (U, V, Z), which ``CMF.fit_transform`` accepts directly.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp

VALID_INITS = ("random", "nndsvd", "nndsvda", "nndsvdar", "svd")


def check_init(name: str) -> str:
    if name not in VALID_INITS:
        raise ValueError(f"init must be one of {VALID_INITS}, got {name!r}")
    return name


def _mean(A) -> float:
    return float(A.mean())


def _svd_k(A, k: int):
    """Leading-k SVD of a dense or sparse matrix (host)."""
    if sp.issparse(A):
        from scipy.sparse.linalg import svds

        kk = min(k, min(A.shape) - 1)
        u, s, vt = svds(A.astype(np.float64), k=kk)
        order = np.argsort(-s)
        u, s, vt = u[:, order], s[order], vt[order]
        if kk < k:  # pad with zeros if k exceeds what svds can return
            u = np.pad(u, ((0, 0), (0, k - kk)))
            s = np.pad(s, (0, k - kk))
            vt = np.pad(vt, ((0, k - kk), (0, 0)))
        return u, s, vt
    u, s, vt = np.linalg.svd(np.asarray(A, dtype=np.float64),
                             full_matrices=False)
    return u[:, :k], s[:k], vt[:k]


def _init_pair(A, k: int, method: str, rng: np.random.RandomState,
               non_negative: bool) -> Tuple[np.ndarray, np.ndarray]:
    """Initialize (W, H) with A ≈ W Hᵀ; W: (p, k), H: (q, k)."""
    p, q = A.shape
    if method == "random":
        avg = np.sqrt(max(abs(_mean(A)), 1e-12) / k)
        W = avg * rng.standard_normal((p, k))
        H = avg * rng.standard_normal((q, k))
        if non_negative:
            np.abs(W, out=W)
            np.abs(H, out=H)
        return W, H

    if method == "svd":
        # Truncated SVD warm start; |·| only when the factors are
        # constrained non-negative (unconstrained factors keep the signs).
        u, s, vt = _svd_k(A, k)
        rs = np.sqrt(np.maximum(s, 0.0))
        W = u * rs
        H = vt.T * rs
        if non_negative:
            return np.abs(W), np.abs(H)
        return W, H

    if not non_negative:
        raise ValueError(
            f"init {method!r} (NNDSVD family) produces non-negative factors "
            "and cannot initialize unconstrained ones; use 'random' or "
            "'svd' when a *_non_negative flag is False")

    # NNDSVD family (Boutsidis & Gallopoulos 2008)
    u, s, vt = _svd_k(A, k)
    W = np.zeros((p, k))
    H = np.zeros((q, k))
    W[:, 0] = np.sqrt(s[0]) * np.abs(u[:, 0])
    H[:, 0] = np.sqrt(s[0]) * np.abs(vt[0])
    for j in range(1, k):
        x, y = u[:, j], vt[j]
        xp, xn = np.maximum(x, 0), np.maximum(-x, 0)
        yp, yn = np.maximum(y, 0), np.maximum(-y, 0)
        xpn, ypn = np.linalg.norm(xp), np.linalg.norm(yp)
        xnn, ynn = np.linalg.norm(xn), np.linalg.norm(yn)
        mp, mn = xpn * ypn, xnn * ynn
        if mp >= mn:
            uu = xp / xpn if xpn > 0 else xp
            vv = yp / ypn if ypn > 0 else yp
            sigma = mp
        else:
            uu = xn / xnn if xnn > 0 else xn
            vv = yn / ynn if ynn > 0 else yn
            sigma = mn
        lbd = np.sqrt(s[j] * sigma)
        W[:, j] = lbd * uu
        H[:, j] = lbd * vv

    if method == "nndsvda":
        avg = _mean(A)
        W[W == 0] = avg
        H[H == 0] = avg
    elif method == "nndsvdar":
        avg = _mean(A)
        W[W == 0] = avg * rng.uniform(size=(W == 0).sum()) / 100.0
        H[H == 0] = avg * rng.uniform(size=(H == 0).sum()) / 100.0
    return W, H


def initialize_factors(
    X, Y, k: int, *, x_init: str = "random", y_init: str = "random",
    U_non_negative: bool = True, V_non_negative: bool = True,
    Z_non_negative: bool = True, random_state=None,
    U: Optional[np.ndarray] = None, V: Optional[np.ndarray] = None,
    Z: Optional[np.ndarray] = None,
):
    """Build (U, V, Z) honoring externally supplied factors (parity hook)."""
    rng = (random_state if isinstance(random_state, np.random.RandomState)
           else np.random.RandomState(random_state))
    n, m = X.shape
    check_init(x_init)
    if Y is not None:
        check_init(y_init)
        my, r = Y.shape
        if my != m:
            raise ValueError(
                f"X has {m} columns but Y has {my} rows; CMF couples X's "
                "columns with Y's rows through the shared factor V "
                "(X ≈ f(UVᵀ), Y ≈ f(VZᵀ))")

    need_xpair = U is None or V is None
    Ux = Vx = None
    if need_xpair:
        Ux, Vx = _init_pair(X, k, x_init, rng,
                            U_non_negative and V_non_negative)
    Vy = Zy = None
    if Y is not None and (Z is None or V is None):
        Vy, Zy = _init_pair(Y, k, y_init, rng,
                            V_non_negative and Z_non_negative)

    if U is None:
        U = Ux
    if V is None:
        V = Vx if Vy is None else (0.5 * (Vx + Vy) if Vx is not None else Vy)
    if Y is not None and Z is None:
        Z = Zy
    if Y is None:
        Z = None if Z is None else Z

    U = np.ascontiguousarray(U, dtype=np.float64)
    V = np.ascontiguousarray(V, dtype=np.float64)
    if U.shape != (n, k):
        raise ValueError(f"U must have shape {(n, k)}, got {U.shape}")
    if V.shape != (m, k):
        raise ValueError(f"V must have shape {(m, k)}, got {V.shape}")
    if Z is not None:
        Z = np.ascontiguousarray(Z, dtype=np.float64)
        if Y is not None and Z.shape != (Y.shape[1], k):
            raise ValueError(
                f"Z must have shape {(Y.shape[1], k)}, got {Z.shape}")
    return U, V, Z
