"""Checkpoints of fitted factors.

Counterpart of ``pycmf_tpu/utils/checkpoint.py``, with the same ``.npz``
keys (``U``, ``V``, optional ``Z``, ``n_iter``, ``loss_history``,
``params_json``), so each package loads the other's files. A snapshot holds
factors, history and constructor parameters, no sampler state (the
reference's holds none); ``fit(X, Y, U=U, V=V, Z=Z)`` resumes from one.
"""
from __future__ import annotations

import json
from typing import Optional

import numpy as np


def save_checkpoint(path: str, U: np.ndarray, V: np.ndarray,
                    Z: Optional[np.ndarray] = None, n_iter: int = 0,
                    loss_history=None, params: Optional[dict] = None
                    ) -> None:
    payload = dict(
        U=np.asarray(U), V=np.asarray(V),
        n_iter=np.asarray(int(n_iter)),
        loss_history=np.asarray(loss_history if loss_history is not None
                                else [], dtype=np.float64),
        params_json=np.asarray(json.dumps(params or {})),
    )
    if Z is not None:
        payload["Z"] = np.asarray(Z)
    np.savez(path, **payload)


def load_checkpoint(path: str) -> dict:
    with np.load(path, allow_pickle=False) as f:
        return dict(
            U=f["U"], V=f["V"],
            Z=f["Z"] if "Z" in f else None,
            n_iter=int(f["n_iter"]),
            loss_history=list(f["loss_history"]),
            params=json.loads(str(f["params_json"])),
        )


def save_model(path: str, model) -> None:
    """Snapshot a fitted CMF: factors, history and the reference's
    constructor parameters (the port's ``device`` is left out, so the
    reference loads the file)."""
    if not hasattr(model, "U_"):
        raise RuntimeError("cannot checkpoint an unfitted model")
    params = {k: v for k, v in model.get_params().items() if k != "device"}
    save_checkpoint(path, model.U_, model.V_, model.Z_,
                    n_iter=model.n_iter_,
                    loss_history=model.loss_history_, params=params)


def load_model(path: str, device="cuda"):
    """A fitted CMF from a snapshot (of either package), computing on
    ``device``: the fitted attributes the reference's ``load_model`` sets."""
    from ..models.cmf import CMF

    ck = load_checkpoint(path)
    names = set(CMF._param_names())
    model = CMF(**{k: v for k, v in ck["params"].items() if k in names},
                device=device)
    model.U_, model.V_, model.Z_ = ck["U"], ck["V"], ck["Z"]
    model.n_iter_ = ck["n_iter"]
    model.loss_history_ = ck["loss_history"]
    model.loss_iters_ = []
    model.step_times_ = []
    model.reconstruction_err_ = (ck["loss_history"][-1]
                                 if ck["loss_history"] else float("nan"))
    model.n_components_ = model.U_.shape[1]
    return model
