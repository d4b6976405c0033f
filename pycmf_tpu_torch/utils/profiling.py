"""Tracing and timing hooks.

Counterpart of ``pycmf_tpu/utils/profiling.py``, on ``torch.profiler`` in
place of ``jax.profiler``: :func:`trace` records the host and, when a card
is present, its kernels, and writes a Chrome trace into ``log_dir``;
:func:`annotate` names a region in it.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, List, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture a trace around a block::

        with profiling.trace("/tmp/cmf-trace"):
            model.fit(X, Y)

    It is written on exit as ``log_dir/trace_<pid>.json`` (Chrome trace
    format: chrome://tracing, Perfetto or TensorBoard's profiler plugin)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(log_dir, f"trace_{os.getpid()}.json"))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named region in the trace (the host's timeline)."""
    with torch.profiler.record_function(name):
        yield


class StepTimer:
    """Host wall-clock timer with a log of its events.

    For examples and benchmarks; the solver loop records its own per-block
    times on the estimator (``step_times_``)."""

    def __init__(self) -> None:
        self.events: List[tuple] = []

    @contextlib.contextmanager
    def measure(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.events.append((name, time.perf_counter() - t0))

    def total(self, name: Optional[str] = None) -> float:
        return sum(dt for n, dt in self.events if name is None or n == name)
