"""Kernel dispatch and launch counts.

Dispatch is by the device the tensors lie on, and nothing else:

- CUDA tensors launch the hand-written kernel. It is built at first use and
  raises if the build or the launch fails; it never falls back to the plain
  PyTorch version.
- CPU tensors take the plain PyTorch version of the same contract. That is
  the path the CPU tests run against the JAX reference.

There is no environment override. Each kernel wrapper counts its launches
so a run can show that its main path went through the kernels. A CUDA
graph's replay runs its kernels without passing through the wrappers, so
the device loop (``solvers/common.py``) takes back what its capture counted
and adds that once per replay (:func:`launches_since`,
:func:`set_launch_counts`, :func:`add_launches`).
"""
from __future__ import annotations

from typing import Dict

import torch


def check_device(device) -> torch.device:
    """``device`` as a torch.device; 'cuda' without a card raises. The
    layout constructors (CSR, BlockEll, chunked COO) place on the card by
    default, as the reference's land on its default device."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise ValueError(
            "device='cuda' (the default) but torch.cuda.is_available() is "
            "False; pass device='cpu' to build the matrix on the CPU")
    return dev


class LaunchCount:
    """Number of times one kernel was launched in this process."""

    def __init__(self, name: str):
        self.name = name
        self.n = 0


_COUNTS: Dict[str, LaunchCount] = {}


def launch_count(name: str) -> LaunchCount:
    """The counter of kernel ``name`` (created on first request)."""
    return _COUNTS.setdefault(name, LaunchCount(name))


def launch_counts() -> Dict[str, int]:
    return {name: c.n for name, c in _COUNTS.items()}


def reset_launch_counts() -> None:
    for c in _COUNTS.values():
        c.n = 0


def launches_since(before: Dict[str, int]) -> Dict[str, int]:
    """How far each counter rose since ``before`` (a launch_counts())."""
    return {name: c.n - before.get(name, 0) for name, c in _COUNTS.items()
            if c.n != before.get(name, 0)}


def set_launch_counts(counts: Dict[str, int]) -> None:
    """Set every counter to its value in ``counts`` (0 where absent)."""
    for name, c in _COUNTS.items():
        c.n = counts.get(name, 0)


def add_launches(delta: Dict[str, int]) -> None:
    """Add ``delta`` ({name: launches}) to the counters."""
    for name, n in delta.items():
        launch_count(name).n += n


def on_card(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on a CUDA device, False when every one
    lies on the CPU; anything else raises. (On every launch's path: it
    reads flags, not torch.device objects.)"""
    cuda = tensors[0].is_cuda
    for t in tensors:
        if t.is_cuda is not cuda or not (cuda or t.is_cpu):
            kinds = sorted({t.device.type for t in tensors})
            raise ValueError(f"kernel operands must all be on one CUDA "
                             f"device or all on the CPU, got devices {kinds}")
    return cuda
