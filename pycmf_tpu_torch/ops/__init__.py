"""Tensor ops of the PyTorch port: links, matmul with its precision
control, losses, line search, CSR matrices.

The package exports the reference's names (``pycmf_tpu/ops/__init__.py``),
in its order. ``spmm`` dispatches on the tensors' device: CUDA tensors
launch the CSR kernel (``kernels/spmm.csr_spmm``), CPU tensors take the
plain gather and segment sum (``sparse.spmm``).
"""
from .kernels.spmm import csr_spmm as spmm
from .matmul import gram, matmul, set_default_precision
from .sparse import CsrMatrix, csr_from_dense, csr_from_scipy

__all__ = ["gram", "matmul", "set_default_precision", "CsrMatrix",
           "csr_from_dense", "csr_from_scipy", "spmm"]
