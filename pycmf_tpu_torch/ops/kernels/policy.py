"""Kernel dispatch and launch counts.

Dispatch is by the device the tensors lie on, and nothing else:

- CUDA tensors launch the hand-written kernel. It is built at first use and
  raises if the build or the launch fails; it never falls back to the plain
  PyTorch version.
- CPU tensors take the plain PyTorch version of the same contract. That is
  the path the CPU tests run against the JAX reference.

There is no environment override. Each kernel wrapper counts its launches
so a run can show that its main path went through the kernels.
"""
from __future__ import annotations

from typing import Dict

import torch


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


def on_card(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on a CUDA device, False when every one
    lies on the CPU; anything else raises."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"kernel operands must all be on one CUDA device or all "
                     f"on the CPU, got devices {sorted(kinds)}")
