"""PyTorch/CUDA port of pycmf_tpu: Collective Matrix Factorization on an
NVIDIA H100.

``CMF`` has the reference estimator's surface (``pycmf_tpu.CMF``) plus a
``device`` argument. This slice runs linear links on dense (or densified)
data with the MU and Newton solvers; the U pass of each runs through a
hand-written CUDA kernel on the card (``csrc/``) and through the kernel's
plain PyTorch version on the CPU. The package imports ``torch``, never
``jax``.
"""
from .models.cmf import CMF

__all__ = ["CMF"]
__version__ = "0.1.0"
