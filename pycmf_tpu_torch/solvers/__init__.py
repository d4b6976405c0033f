"""MU and Newton solvers of the PyTorch port."""
from .mu import run_mu
from .newton import run_newton

__all__ = ["run_mu", "run_newton"]
