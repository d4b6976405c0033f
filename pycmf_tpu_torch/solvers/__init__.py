"""MU and Newton solvers of the PyTorch port, with the reference's
exports (``pycmf_tpu/solvers/__init__.py``)."""
from .common import Coupled, Hyper, SolverConfig, make_hyper
from .mu import make_mu_step, run_mu
from .newton import make_newton_step, run_newton

__all__ = ["Coupled", "Hyper", "SolverConfig", "make_hyper",
           "make_mu_step", "run_mu", "make_newton_step", "run_newton"]
