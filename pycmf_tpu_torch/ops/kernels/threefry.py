"""Threefry-2x32 random bits: the CUDA kernel's wrapper and its plain
PyTorch version.

Counterpart of ``jax.random``'s generator, which the reference's sampled
Newton fit draws its columns with (``pycmf_tpu/solvers/newton.py:115-143``);
no Pallas kernel. ``csrc/threefry.cu`` holds the kernel. Keys, bits and
pairs are int64 tensors holding uint32 values (torch has no uint32
arithmetic on every device), sort keys int32; :mod:`pycmf_tpu_torch.ops.
random` builds the reference's key schedule on :func:`threefry_bits`.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .policy import launch_count, on_card

LAUNCHES = launch_count("threefry")

MASK = 0xFFFFFFFF
# output forms (csrc/threefry.cu: ThreefryForm)
BITS, PAIRS, SORT_KEYS = 0, 1, 2
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
PARITY = 0x1BD11BDA


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32_ref(key, counters):
    """Threefry-2x32 (20 rounds) of the counter pairs ``counters`` = (x0,
    x1) under ``key`` (2,): the rounds, rotations and key injections of
    ``jax/_src/prng.py:_threefry2x32_lowering``, in uint32 arithmetic
    carried in int64 tensors. Returns (y0, y1), each of x0's shape."""
    k0, k1 = key[0], key[1]
    ks = (k0, k1, k0 ^ k1 ^ PARITY)
    x0 = (counters[0] + ks[0]) & MASK
    x1 = (counters[1] + ks[1]) & MASK
    for g in range(1, 6):
        for r in ROTATIONS[(g - 1) % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[g % 3]) & MASK
        x1 = (x1 + ks[(g + 1) % 3] + g) & MASK
    return x0, x1


def threefry_bits_ref(key, n: int, *, base=None, offset: int = 0,
                      start: int = 0, form: int = BITS):
    """Plain PyTorch version of :func:`threefry_bits`."""
    if base is not None:
        d = (base.reshape(()) + offset) & MASK
        k0, k1 = threefry2x32_ref(key, (torch.zeros_like(d), d))
        key = torch.stack([k0, k1])
    c = torch.arange(start, start + n, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32_ref(key, (c >> 32, c & MASK))
    if form == PAIRS:
        return torch.stack([y0, y1], dim=1)
    if form == SORT_KEYS:
        return ((y0 ^ y1) - (1 << 31)).to(torch.int32)
    return y0 ^ y1


def check_operands(key, base) -> None:
    """Raise on what the kernel does not take: an int64 key of two
    contiguous words and an int64 counter of one."""
    if not isinstance(key, torch.Tensor):
        raise ValueError(f"threefry takes an int64 key (2,), got {key!r}")
    if not (key.dtype is torch.int64 and key.shape == (2,)
            and key.is_contiguous()
            and (base is None or (base.dtype is torch.int64
                                  and base.numel() == 1))):
        raise ValueError(
            f"threefry takes an int64 key (2,) and an int64 counter of one "
            f"element, got key {key.dtype} {tuple(key.shape)}"
            + ("" if base is None else
               f", counter {base.dtype} {tuple(base.shape)}"))


def threefry_bits(key, n: int, *, base=None, offset: int = 0,
                  start: int = 0, form: int = BITS):
    """n outputs of Threefry-2x32 at the 64-bit counters start .. start +
    n − 1, split into high and low words (``iota_2x32_shape``), under
    ``key`` or, with ``base`` (a one-element int64 tensor on key's device,
    read there), under the derived key fold_in(key, base + offset). form:
    BITS, the pairs' xor, (n,) int64 of uint32 values: JAX's partitionable
    32-bit ``random_bits``; PAIRS, the (n, 2) pairs (``split``,
    ``fold_in``); SORT_KEYS, the xor minus 2³¹ as int32, (n,): the bits in
    their unsigned order, for a stable sort. CUDA tensors launch
    ``threefry_kernel`` (csrc/threefry.cu) or raise; CPU tensors take
    :func:`threefry_bits_ref`."""
    check_operands(key, base)
    if form not in (BITS, PAIRS, SORT_KEYS):
        raise ValueError(f"threefry's form is BITS, PAIRS or SORT_KEYS, "
                         f"got {form!r}")
    if not on_card(key, *(() if base is None else (base,))):
        return threefry_bits_ref(key, n, base=base, offset=offset,
                                 start=start, form=form)
    if n < 1:
        raise ValueError(f"threefry draws at least one output, got n={n}")
    out = torch.empty((n, 2) if form == PAIRS else (n,),
                      dtype=torch.int32 if form == SORT_KEYS else torch.int64,
                      device=key.device)
    fn = _build.function(
        "threefry", "pycmf_threefry",
        (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
         ctypes.c_ulonglong, ctypes.c_longlong, ctypes.c_int,
         ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p))
    dev = key.get_device()
    rc = fn(key.data_ptr(), None if base is None else base.data_ptr(),
            int(offset), int(start), int(n), int(form), out.data_ptr(), dev,
            torch._C._cuda_getCurrentRawStream(dev))
    if rc:
        _build.check(_build.load("threefry"), rc, "threefry")
    LAUNCHES.n += 1
    return out
