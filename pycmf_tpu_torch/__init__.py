"""PyTorch/CUDA port of pycmf_tpu: Collective Matrix Factorization on an
NVIDIA H100.

``CMF`` has the reference estimator's surface (``pycmf_tpu.CMF``) plus a
``device`` argument. It runs the MU solver (linear links) and the Newton
solver (linear or sigmoid links; full batch or sampled; Gauss-Newton or the
full Hessian) on dense or densified data, on CSR data (linear links) and on
the streamed chunked-COO layout, with data stored at float32, bf16 or fp8
(e4m3, dense X only: ``data_dtype='fp8'``); ``n_shards`` > 1 fits
row-, column- or grid-sharded (``shard_layout='grid'``, ``n_shards=(r,
c)``), one process per shard or cell of a torch.distributed group
(``parallel/``), fp8 data included. ``utils`` holds the topic-term analysis,
checkpoints (``.npz`` files either package loads) and profiling hooks.
The kernels of those paths are hand-written CUDA on the card (``csrc/``)
and their plain PyTorch versions on the CPU. The package imports
``torch``, never ``jax``.
"""
from .models.cmf import CMF
from .ops.sparse import CsrMatrix
from .solvers.common import SolverConfig, make_hyper

__version__ = "0.1.0"
__all__ = ["CMF", "CsrMatrix", "SolverConfig", "make_hyper", "__version__"]
