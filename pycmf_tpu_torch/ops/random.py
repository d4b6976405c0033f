"""The reference's random stream: ``jax.random``'s Threefry-2x32 keys and
draws on tensors, bit for bit.

Counterpart of the parts of ``jax.random`` (JAX 0.9, its default
``threefry2x32`` implementation with ``jax_threefry_partitionable``) that
the reference's sampled Newton fit calls: ``PRNGKey``, ``fold_in``,
``split``, 32-bit ``random_bits`` and ``choice(replace=False)``
(``pycmf_tpu/solvers/newton.py:115-143``). A key is an int64 tensor (2,)
holding two uint32 words; every hash goes through
``ops/kernels/threefry.threefry_bits`` (the CUDA kernel on a CUDA key, its
plain version on the CPU), and nothing here reads a value back to the
host, so a CUDA graph captures a whole draw.

:class:`KeyStream` is a fit's stream: the reference's key and a device
counter, the absolute iteration of the next step. Step i of a block draws
under ``split(fold_in(key, counter + i), 3)`` (the reference's fit loops,
``pycmf_tpu/solvers/common.py:191-197`` and ``newton.py:940-965``, then its
step's split, ``newton.py:636``), the counter read on the device, and the
block advances the counter on the device: a graph of one eval block
replayed inside a conditional while node draws each block's own keys.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .kernels.threefry import MASK, PAIRS, SORT_KEYS, threefry_bits


def prng_key(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a Python int, as the reference's
    tests run it (``jax_enable_x64``): the seed as an int64, the key its
    high and low 32-bit words ((0, seed) for 0 <= seed < 2³²; a negative
    seed in two's complement, -1 → (2³² − 1, 2³² − 1)). Outside the int64
    range, OverflowError, as numpy's int64 conversion raises."""
    s = int(seed)
    if not -(1 << 63) <= s < (1 << 63):
        raise OverflowError(f"PRNG seed {s} does not fit in int64")
    u = s % (1 << 64)
    return torch.tensor([u >> 32, u & MASK], dtype=torch.int64,
                        device=device)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: the hash of the counter (0, data)
    under key, 0 <= data < 2³²."""
    if not 0 <= int(data) <= MASK:
        raise ValueError(f"fold_in takes a uint32, got {data}")
    return threefry_bits(key, 1, start=int(data), form=PAIRS)[0]


def split(key: torch.Tensor, n: int = 2) -> torch.Tensor:
    """``jax.random.split(key, n)``, (n, 2): the hashes of the counters
    (0, j), j < n (the partitionable split; row j equals fold_in(key, j))."""
    return threefry_bits(key, n, form=PAIRS)


def random_bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,), uint32)``, as int64 (n,): each
    counter's two hash words xored (the partitionable scheme)."""
    return threefry_bits(key, n)


def shuffle_rounds(q: int) -> int:
    """The sort rounds ``jax.random.permutation`` takes for q items:
    ⌈3 ln q / ln(2³² − 1)⌉ (``jax/_src/random.py:_shuffle``; 1 to q = 1625,
    2 to q ≈ 2.6 million)."""
    return int(np.ceil(3 * np.log(max(1, q)) / np.log(MASK)))


def choice_without_replacement(key: torch.Tensor, q: int,
                               s: int) -> torch.Tensor:
    """``jax.random.choice(key, q, (s,), replace=False)``, index for index:
    the first s entries of ``permutation(key, q)``, whose rounds each
    split the key, draw 32-bit sort keys under the subkey and reorder
    arange(q) by a stable sort of them (``lax.sort_key_val`` on the
    uint32 bits: here a stable sort of the same bits as order-preserving
    int32 keys). int64 (s,) on key's device; a static shape and no host
    sync."""
    if not 0 < s <= q:
        raise ValueError(f"choice without replacement takes 0 < s <= q, "
                         f"got s={s}, q={q}")
    x = None
    for _ in range(shuffle_rounds(q)):
        pair = split(key)
        key, sub = pair[0], pair[1]
        keys = threefry_bits(sub, q, form=SORT_KEYS)
        order = torch.sort(keys, stable=True).indices
        x = order if x is None else x.index_select(0, order)
    if x is None:
        x = torch.arange(q, dtype=torch.int64, device=key.device)
    return x[:s]


class KeyStream(NamedTuple):
    """A sampled fit's draws: the reference's ``key`` (2,) and ``it``, a
    0-d int64 tensor on key's device: the absolute iteration of the next
    step (the reference's ``off + i``)."""

    key: torch.Tensor
    it: torch.Tensor

    @classmethod
    def start(cls, key: torch.Tensor) -> "KeyStream":
        """The stream of a fit from iteration 0."""
        return cls(key, torch.zeros((), dtype=torch.int64,
                                    device=key.device))

    def step_keys(self, i: int) -> torch.Tensor:
        """(kU, kZ, kV), (3, 2): split(fold_in(key, it + i), 3), the keys of
        the block's step i, in one launch that reads ``it`` on the
        device."""
        return threefry_bits(self.key, 3, base=self.it, offset=i, form=PAIRS)

    def advance(self, n: int) -> None:
        """Move the counter past a block of n steps (on the device)."""
        self.it.add_(n)

    def copy(self) -> "KeyStream":
        """A stream in memory of its own at the same key and iteration."""
        return KeyStream(self.key.clone(), self.it.clone())

    def load(self, other: "KeyStream") -> None:
        """Take ``other``'s key and iteration (device copies)."""
        self.key.copy_(other.key)
        self.it.copy_(other.it)
