"""Drop-in alias of the ``pycmf`` package name for the PyTorch port.

Counterpart of ``pycmf/__init__.py``: ``from pycmf_torch import CMF`` is
the port's estimator. It re-exports the names of ``pycmf.__all__`` from
:mod:`pycmf_tpu_torch` and has no implementation of its own.
"""
from pycmf_tpu_torch import (  # noqa: F401
    CMF,
    CsrMatrix,
    SolverConfig,
    make_hyper,
)
from pycmf_tpu_torch import __version__  # noqa: F401
from pycmf_tpu_torch.utils import analysis  # noqa: F401
from pycmf_tpu_torch.utils.analysis import (  # noqa: F401
    top_component_samples,
    top_terms_per_component,
    topic_terms_string,
)

__all__ = [
    "CMF", "CsrMatrix", "SolverConfig", "make_hyper", "analysis",
    "top_terms_per_component", "topic_terms_string",
    "top_component_samples", "__version__",
]
