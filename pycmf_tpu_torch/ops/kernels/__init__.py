"""Hand-written CUDA kernels (sources in ``pycmf_tpu_torch/csrc``), each
beside its plain PyTorch version; counterpart of ``pycmf_tpu/ops/pallas``."""
