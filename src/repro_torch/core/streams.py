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


def bits(key: int, shape, device, offset: int = 0) -> torch.Tensor:
    """int64 tensor of ``shape`` holding 32-bit hashes of the counters
    offset..offset+numel-1 (row-major) under ``key``. Distinct counters
    below 2**32 give distinct values; a range split at any offset gives
    the bits of the whole range."""
    n = math.prod(shape)
    key = int(key) & M32
    c = torch.arange(offset, offset + n, dtype=torch.int64, device=device)
    h = hash32((c + key) & M32)
    hi = fold(key, _C_ROUND2)
    h = hash32(h ^ (hi ^ (c >> 32)) if offset + n > M32 else h ^ hi)
    return h.reshape(tuple(shape))


def uniform(key: int, shape, device, offset: int = 0) -> torch.Tensor:
    """fp32 uniforms in [0, 1) on the 2**-24 grid: the top 24 bits of
    ``bits(key, shape, device, offset)``."""
    return (bits(key, shape, device, offset) >> 8).to(torch.float32) \
        * 2.0 ** -24


# pairs of uniforms per chunk of ``normal``: bounds the hash's int64
# temporaries to a few hundred MB whatever the size asked for
NORMAL_CHUNK_PAIRS = 1 << 25


def normal(key: int, n: int, device, out: torch.Tensor | None = None
           ) -> torch.Tensor:
    """n standard normals (fp32) by Box-Muller over the uniforms of
    ``key``: pair p takes counters 2p and 2p + 1 (u1 = 1 - u in (0, 1],
    u2 = u) and gives elements 2p (r cos) and 2p + 1 (r sin), so both
    outputs are kept. Drawn in chunks of ``NORMAL_CHUNK_PAIRS`` pairs
    into ``out`` (a contiguous fp32 tensor of n elements, flattened) or a
    new (n,) tensor. The uniforms are bitwise the same on every device;
    log, sqrt, cos and sin round within a few ulps of each other on the
    CPU and the card."""
    if out is None:
        out = torch.empty((n,), dtype=torch.float32, device=device)
    flat = out.view(-1)
    pairs = -(-n // 2)
    for p0 in range(0, pairs, NORMAL_CHUNK_PAIRS):
        m = min(NORMAL_CHUNK_PAIRS, pairs - p0)
        u = uniform(key, (m, 2), device, offset=2 * p0)
        r = torch.sqrt(-2.0 * torch.log(1.0 - u[:, 0]))
        theta = (2.0 * math.pi) * u[:, 1]
        z = torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=1)
        stop = min(n, 2 * (p0 + m))
        flat[2 * p0:stop] = z.view(-1)[:stop - 2 * p0]
    return out
