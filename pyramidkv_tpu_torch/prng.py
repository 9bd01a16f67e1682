"""Counter-based random numbers that reproduce ``jax.random`` bit for bit
(the port's counterpart of the ``jax.random`` calls of
``pyramidkv_tpu/policy.py``: ``PRNGKey`` / ``split`` for the per-layer keys
and ``uniform`` for the random-eviction scores and CAM's merge draws).

JAX's default generator is Threefry-2x32 with ``jax_threefry_partitionable``
on: a key is two uint32 words; ``split(key, n)`` hashes the counters
``(0, i)`` for ``i < n`` under the key, and ``uniform(key, shape)`` hashes
the counters ``(hi, lo)`` of each element's flat index and keeps the XOR of
the two output words, whose top 23 bits become the mantissa of a float in
[1, 2), minus 1.  Everything is integer arithmetic on a counter, so the same
bits come out on the CPU and on the card: uint32 values are carried in
int64 tensors and masked to 32 bits after every add and shift.

A key is an int64 tensor of shape ``[2]`` (a stack of keys: ``[n, 2]``),
holding uint32 values.
"""

from __future__ import annotations

from typing import Sequence

import torch

_M32 = 0xFFFFFFFF
#: the rotation schedule and key-schedule parity of Threefry-2x32
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry_2x32(k1, k2, x1: torch.Tensor, x2: torch.Tensor):
    """The Threefry-2x32 hash (20 rounds) of the counter pairs (x1, x2)
    under the key (k1, k2); every value a uint32 held in int64.  Returns
    the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x = [(x1 + ks[0]) & _M32, (x2 + ks[1]) & _M32]
    for i in range(5):
        for r in _ROT[i % 2]:
            x[0] = (x[0] + x[1]) & _M32
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _M32
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & _M32
    return x[0], x[1]


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` with 64-bit types off: the key words
    (0, seed mod 2^32)."""
    return torch.tensor([0, int(seed) & _M32], dtype=torch.int64,
                        device=device)


def _counters(shape: Sequence[int], device):
    """The (hi, lo) words of each element's flat index, as JAX's
    ``iota_2x32_shape`` makes them."""
    n = 1
    for s in shape:
        n *= int(s)
    idx = torch.arange(n, dtype=torch.int64, device=device).reshape(
        tuple(shape))
    return (idx >> 32) & _M32, idx & _M32


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: [num, 2] keys."""
    hi, lo = _counters((num,), key.device)
    b1, b2 = threefry_2x32(key[0], key[1], hi, lo)
    return torch.stack([b1, b2], dim=-1)


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32 random bits per element (uint32 in int64), as JAX's partitionable
    ``random_bits`` makes them."""
    hi, lo = _counters(shape, key.device)
    b1, b2 = threefry_2x32(key[0], key[1], hi, lo)
    return b1 ^ b2


def uniform(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` (float32 in [0, 1))."""
    bits = (random_bits(key, shape) >> 9) | 0x3F800000
    # reinterpret the low 32 bits as float32 (values < 2^31 fit int32)
    return bits.to(torch.int32).view(torch.float32) - 1.0
