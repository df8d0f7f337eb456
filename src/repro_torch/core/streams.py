"""Counter-based random streams: the same draws on the CPU and on the card.

The reference keys its stochastic-rounding uniforms (``core/quant.py``) and
its participation draws (``core/schedule.py``) with threefry ``fold_in``
chains, which PyTorch cannot reproduce; and a ``torch.Generator`` draws
other values on the CPU than on a CUDA device. The port's own streams are
a counter hash instead:

* every value is a pure function of (key, counter), so a draw can be
  re-derived at any round without carrying generator state, and two
  drivers that ask for the same (key, counter) get the same bits;
* the hash runs in int64 tensor ops whose intermediates all stay below
  2**63 (32-bit lanes, multipliers below 2**31), so the CPU and the card
  compute the same bits and no op relies on signed overflow;
* nothing is read back to the host.

``fold(key, *values)`` derives a 32-bit key on the host from Python ints
(a seed, a round, a step); ``bits(key, shape, device)`` hashes the
counters 0..numel-1 under a key into distinct 32-bit values (two rounds of
a bijective hash); ``uniform`` maps them to [0, 1) on the 2**-24 grid,
exact in fp32.
"""
from __future__ import annotations

import math

import torch

M32 = 0xFFFFFFFF
# odd constants added before hashing, so that a zero key or value does not
# hash to zero (the hash maps 0 to 0)
_C_VALUE = 0x9E3779B9
_C_ROUND2 = 0x85EBCA6B


def hash32(x):
    """A bijective 32-bit integer hash of ``x`` in [0, 2**32): xorshift
    16, multiply, xorshift 15, multiply, xorshift 15 (the constants of
    hash-prospector's low-bias 16-21f0aaad-15-735a2d97-15 hash). ``x`` is
    a Python int or an int64 tensor; both multipliers are below 2**31, so
    every product stays below 2**63."""
    x = x ^ (x >> 16)
    x = (x * 0x21F0AAAD) & M32
    x = x ^ (x >> 15)
    x = (x * 0x735A2D97) & M32
    return x ^ (x >> 15)


def fold(key: int, *values: int) -> int:
    """Fold non-negative ints into a 32-bit key, in order, 32 bits at a
    time: ``fold(fold(k, a), b) == fold(k, a, b)``."""
    key = int(key) & M32
    for v in values:
        v = int(v)
        if v < 0:
            raise ValueError(f"fold: values must be >= 0, got {v}")
        while True:
            key = hash32(key ^ hash32((v + _C_VALUE) & M32))
            v >>= 32
            if not v:
                break
    return key


def bits(key: int, shape, device) -> torch.Tensor:
    """int64 tensor of ``shape`` holding 32-bit hashes of the counters
    0..numel-1 (row-major) under ``key``. Distinct counters below 2**32
    give distinct values."""
    n = math.prod(shape)
    key = int(key) & M32
    c = torch.arange(n, dtype=torch.int64, device=device)
    h = hash32((c + key) & M32)
    hi = fold(key, _C_ROUND2)
    h = hash32(h ^ (hi ^ (c >> 32)) if n > M32 else h ^ hi)
    return h.reshape(tuple(shape))


def uniform(key: int, shape, device) -> torch.Tensor:
    """fp32 uniforms in [0, 1) on the 2**-24 grid: the top 24 bits of
    ``bits(key, shape, device)``."""
    return (bits(key, shape, device) >> 8).to(torch.float32) * 2.0 ** -24
