"""PyTorch/CUDA port of pycmf_tpu: Collective Matrix Factorization on an
NVIDIA H100.

``CMF`` has the reference estimator's surface (``pycmf_tpu.CMF``) plus a
``device`` argument. It runs dense (or densified) data with the MU solver
(linear links) and the Newton solver (linear or sigmoid links); the
kernels of those paths are hand-written CUDA on the card (``csrc/``) and
their plain PyTorch versions on the CPU. The package imports ``torch``,
never ``jax``.
"""
from .models.cmf import CMF

__all__ = ["CMF"]
__version__ = "0.1.0"
