"""Carry fitted factors between NumPy, the reference estimator and the port.

The port never imports JAX: a fitted ``pycmf_tpu.CMF`` is read through its
public surface (``get_params()`` and the NumPy ``U_``/``V_``/``Z_``).
"""
from __future__ import annotations

import numpy as np
import torch

# Fitted attributes of the reference estimator, copied as they are.
FITTED_ATTRS = ("n_components_", "n_iter_", "loss_history_", "loss_iters_",
                "step_times_", "reconstruction_err_")


def factors_from_numpy(U, V, Z, device, dtype=torch.float32):
    """(U, V, Z) NumPy arrays (Z may be None) as tensors on ``device``."""
    def up(a):
        return None if a is None else torch.as_tensor(
            np.asarray(a, dtype=np.float64)).to(device=device, dtype=dtype)

    return up(U), up(V), up(Z)


def factors_to_numpy(U, V, Z):
    """(U, V, Z) tensors (Z may be None) as float64 NumPy arrays."""
    def down(t):
        return None if t is None else \
            t.detach().to("cpu", torch.float64).numpy()

    return down(U), down(V), down(Z)


def fitted_state_from_reference(ref) -> dict:
    """Params and fitted attributes of a fitted reference estimator, as
    plain Python and NumPy values."""
    if not hasattr(ref, "V_"):
        raise ValueError("the reference estimator is not fitted")
    state = {name: getattr(ref, name) for name in FITTED_ATTRS}
    for name in ("U_", "V_", "Z_"):
        a = getattr(ref, name)
        state[name] = None if a is None else np.array(a, dtype=np.float64)
    return {"params": dict(ref.get_params()), "fitted": state}
