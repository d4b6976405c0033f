"""The device-resident fit loop's stop rule and outer graph: the CUDA
kernel's wrappers and the rule's plain PyTorch version.

Counterpart of the reference's ``lax.while_loop`` in
``pycmf_tpu/solvers/common.py:device_fit_core`` (its cond, the body's stop
rule and history write, and the remainder under ``lax.cond``); no Pallas
kernel. ``csrc/fit_loop.cu`` holds ``stop_rule_kernel`` (one thread) and
the host functions that build, launch and destroy a fit's outer graph: a
conditional ``while`` node around a captured eval block and the rule, and a
conditional ``if`` node around a captured remainder block.

The loop's state lives in device buffers that eager ops write before a
launch (:func:`write_control`):

- ``ctl`` int64 (CTL_SLOTS,): i (the next full block), n_full, stop, the
  remainder ran, the history's address;
- ``fctl`` float64 (FCTL_SLOTS,): tol, L0, prev;
- ``hist`` float64 (n_full + 2,), NaN-filled: hist[0] = L0, hist[j + 1]
  the loss after block j.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .policy import launch_count, on_card

LAUNCHES = launch_count("fit_loop")

CTL_SLOTS, FCTL_SLOTS = 5, 3
GATE, BLOCK, REMAINDER = 0, 1, 2   # csrc/fit_loop.cu: FitMode

# cudaGraphNodeType, for naming a node a conditional body refuses
NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host", 4: "graph",
              5: "empty", 6: "wait event", 7: "event record",
              8: "external semaphore signal", 9: "external semaphore wait",
              10: "memory allocation", 11: "memory free",
              12: "batch memory operation", 13: "conditional"}


def stop_rule_ref(ctl, fctl, hist, loss, mode: int = BLOCK):
    """Plain version of ``stop_rule_kernel`` on the same buffers, in torch
    ops on float64 (any device, no sync). Mode BLOCK: hist[i + 1] = loss;
    stop = loss non-finite, or L0 > 0 and (prev − loss) / L0 < tol, in the
    host loop's order; i += 1; prev = loss. Mode REMAINDER: hist[i + 1] =
    loss; the remainder ran. Mode GATE: reads only. Returns the values the
    kernel would give the loop's and the remainder's handles: (not stop
    and i < n_full, not stop and i >= n_full), 0-d bool tensors."""
    i, n_full, stop = ctl[0], ctl[1], ctl[2] != 0
    if mode != GATE:
        l = loss.reshape(()).to(torch.float64)
        hist.index_put_(((i + 1).reshape(1),), l.reshape(1))
        if mode == REMAINDER:
            ctl[3] = 1
            return None
        L0, prev, tol = fctl[1], fctl[2], fctl[0]
        stop = ~torch.isfinite(l) | ((L0 > 0) & ((prev - l) / L0 < tol))
        i = i + 1
        ctl[0] = i
        ctl[2] = stop.to(torch.int64)
        fctl[2] = l
    return ~stop & (i < n_full), ~stop & (i >= n_full)


def write_control(ctl, fctl, hist, L0, *, start: int, n_full: int,
                  tol: float) -> None:
    """Write a fit's loop state: i = start, n_full, no stop, no remainder,
    the history's address (ctl); tol, L0 and prev = L0 (fctl); hist[0] =
    L0 (a 0-d tensor on the device). Asynchronous: the host's values go
    through pinned buffers on the card."""
    ints = torch.tensor([start, n_full, 0, 0, hist.data_ptr()],
                        dtype=torch.int64)
    floats = torch.tensor([float(tol), 0.0, 0.0], dtype=torch.float64)
    if ctl.is_cuda:
        ints, floats = ints.pin_memory(), floats.pin_memory()
    ctl.copy_(ints, non_blocking=True)
    fctl.copy_(floats, non_blocking=True)
    fctl[1:].copy_(L0.reshape(()).expand(2))
    hist[:1].copy_(L0.reshape(1))


def _check_operands(ctl, fctl, loss) -> None:
    if not (ctl.dtype is torch.int64 and ctl.shape == (CTL_SLOTS,)
            and fctl.dtype is torch.float64 and fctl.shape == (FCTL_SLOTS,)
            and loss.dtype is torch.float64 and loss.numel() == 1
            and ctl.is_contiguous() and fctl.is_contiguous()):
        raise ValueError(
            f"the stop rule takes ctl int64 ({CTL_SLOTS},), fctl float64 "
            f"({FCTL_SLOTS},) and a float64 loss, got ctl {ctl.dtype} "
            f"{tuple(ctl.shape)}, fctl {fctl.dtype} {tuple(fctl.shape)}, "
            f"loss {loss.dtype} {tuple(loss.shape)}")


def stop_rule(ctl, fctl, hist, loss, mode: int = BLOCK) -> None:
    """One step of the stop rule outside any graph (mode BLOCK or
    REMAINDER). CUDA tensors launch ``stop_rule_kernel``, which reads the
    history's address from ctl (written by :func:`write_control`); CPU
    tensors take :func:`stop_rule_ref`."""
    if not on_card(ctl, fctl, hist, loss):
        stop_rule_ref(ctl, fctl, hist, loss, mode)
        return
    _check_operands(ctl, fctl, loss)
    fn = _build.function("fit_loop", "pycmf_stop_rule",
                         (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 2
                         + (ctypes.c_void_p,))
    dev = ctl.get_device()
    rc = fn(ctl.data_ptr(), fctl.data_ptr(), loss.data_ptr(), int(mode), dev,
            torch._C._cuda_getCurrentRawStream(dev))
    if rc:
        _build.check(_build.load("fit_loop"), rc, "stop_rule")
    LAUNCHES.n += 1


def refused_node(graph: int, device: int):
    """(nodes, refused) of a captured graph (``CUDAGraph.raw_cuda_graph()``)
    and its child graphs: how many nodes they hold, and the
    cudaGraphNodeType of the first node a conditional node's body refuses
    (it takes kernel, memcpy, memset, empty, child-graph and conditional
    nodes only; ``NODE_TYPES`` names it), or None."""
    fn = _build.function("fit_loop", "pycmf_fit_graph_check",
                         (ctypes.c_void_p, ctypes.c_int,
                          ctypes.POINTER(ctypes.c_int),
                          ctypes.POINTER(ctypes.c_int)))
    bad, nodes = ctypes.c_int(-1), ctypes.c_int(0)
    rc = fn(graph, device, ctypes.byref(bad), ctypes.byref(nodes))
    if rc:
        _build.check(_build.load("fit_loop"), rc, "fit graph check")
    return nodes.value, (bad.value if bad.value >= 0 else None)


def graph_nodes(graph: int, device: int) -> int:
    """Nodes of a captured graph and its child graphs (:func:`refused_node`).
    Raises if one is of a type a conditional node's body refuses, naming
    the type."""
    nodes, bad = refused_node(graph, device)
    if bad is not None:
        raise RuntimeError(
            "the device loop cannot put this eval block in a conditional "
            f"node: its captured graph holds a "
            f"{NODE_TYPES.get(bad, bad)!s} node (type {bad}); a conditional "
            "body takes kernel, memcpy, memset, empty, child-graph and "
            "conditional nodes only")
    return nodes


class FitGraph:
    """The outer graph of a fit on the card, built from the captured
    graphs of an eval block (``block``, a ``cudaGraph_t`` as an int) and of
    the remainder block (``rem``, or 0): each is copied into the outer
    graph, and the caller keeps alive the memory they read. ``loss`` and
    ``rem_loss`` are the float64 0-d tensors the blocks write their loss
    to. Nothing is retried: a failure to build, instantiate or launch
    raises."""

    def __init__(self, block: int, rem: int, ctl, fctl, loss, rem_loss):
        self.device = ctl.get_device()
        self.nodes = graph_nodes(block, self.device) + (
            graph_nodes(rem, self.device) if rem else 0)
        _check_operands(ctl, fctl, loss)
        fn = _build.function("fit_loop", "pycmf_fit_graph_create",
                             (ctypes.c_void_p,) * 6
                             + (ctypes.c_int, ctypes.POINTER(ctypes.c_void_p)))
        handle = ctypes.c_void_p()
        rc = fn(block, rem or None, ctl.data_ptr(), fctl.data_ptr(),
                loss.data_ptr(), rem_loss.data_ptr() if rem else None,
                self.device, ctypes.byref(handle))
        if rc:
            _build.check(_build.load("fit_loop"), rc, "fit graph build")
        self._handle = handle.value
        self._gates = 1 + bool(rem)
        self._launch = _build.function(
            "fit_loop", "pycmf_fit_graph_launch",
            (ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p))

    def launch(self) -> None:
        """Launch the fit on the current stream. Counts the rule's gate
        nodes, which run once per launch; :meth:`ran` counts the others."""
        dev = self.device
        rc = self._launch(self._handle, dev,
                          torch._C._cuda_getCurrentRawStream(dev))
        if rc:
            _build.check(_build.load("fit_loop"), rc, "fit graph launch")
        LAUNCHES.n += self._gates

    def ran(self, blocks: int, rem_ran: bool) -> None:
        """Count the rule's nodes a launch ran after the gates: one per
        eval block and one after the remainder, known from the readback."""
        LAUNCHES.n += blocks + int(rem_ran)

    def close(self) -> None:
        """Destroy the outer graph and its executable."""
        if self._handle:
            fn = _build.function("fit_loop", "pycmf_fit_graph_destroy",
                                 (ctypes.c_void_p, ctypes.c_int))
            fn(self._handle, self.device)
            self._handle = None
