"""JAX's default random generator, Threefry-2x32, in numpy.

The JAX package draws its initial weights with ``jax.random``, and its
model store pins those draws by a sha256 of the written file. This is a
copy of the generator's arithmetic, so the port reproduces the same bits
on a machine without JAX. It follows JAX with
``jax_threefry_partitionable`` on (the default since JAX 0.5) and 64-bit
seeds (the JAX package runs with x64 on):

- :func:`prng_key` is ``jax.random.PRNGKey(seed)``: the seed's high and
  low 32 bits;
- :func:`split` is ``jax.random.split(key, num)``: the hash of the
  counts 0 .. num-1, its two output words forming each new key;
- :func:`random_bits` hashes the flat index of every element (its high
  and low 32 bits) and xors the two output words;
- :func:`uniform` is ``jax.random.uniform`` in float32: 23 random
  mantissa bits under the exponent of 1.0, minus 1, times
  ``maxval - minval`` plus ``minval``, and at least ``minval``. XLA's
  CPU backend contracts the product and the sum into one fused
  multiply-add, rounded once; so does :func:`uniform`, in float64.

Everything is vectorized over uint32 arrays, whose sums wrap modulo
2^32 as the hash needs; :func:`random_bits` hashes in chunks to bound
memory.
"""
from __future__ import annotations

import math

import numpy as onp

__all__ = ["prng_key", "split", "threefry_2x32", "random_bits", "uniform"]

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_CHUNK = 1 << 22


def prng_key(seed: int) -> onp.ndarray:
    """The key of ``seed`` (a 64-bit integer): uint32 [high, low]."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return onp.array([seed >> 32, seed & _MASK], dtype=onp.uint32)


def threefry_2x32(key, x0, x1):
    """The Threefry-2x32 hash (20 rounds) of the count pairs
    ``(x0, x1)`` (uint32 arrays of one shape) under ``key``: two uint32
    arrays."""
    k = [int(key[0]), int(key[1])]
    ks = (k[0], k[1], k[0] ^ k[1] ^ _PARITY)
    x0 = onp.asarray(x0, onp.uint32) + onp.uint32(ks[0])
    x1 = onp.asarray(x1, onp.uint32) + onp.uint32(ks[1])
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 += x1
            x1 = (x1 << onp.uint32(r)) | (x1 >> onp.uint32(32 - r))
            x1 ^= x0
        x0 += onp.uint32(ks[(i + 1) % 3])
        x1 += onp.uint32((ks[(i + 2) % 3] + i + 1) & _MASK)
    return x0, x1


def split(key, num: int = 2) -> onp.ndarray:
    """``num`` new keys from ``key``: a (num, 2) uint32 array."""
    lo = onp.arange(num, dtype=onp.uint32)
    b0, b1 = threefry_2x32(key, onp.zeros_like(lo), lo)
    return onp.stack([b0, b1], axis=1)


def random_bits(key, shape) -> onp.ndarray:
    """32 random bits per element of ``shape``: a uint32 array."""
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    out = onp.empty(n, dtype=onp.uint32)
    for start in range(0, n, _CHUNK):
        idx = onp.arange(start, min(n, start + _CHUNK), dtype=onp.uint64)
        b0, b1 = threefry_2x32(key, (idx >> onp.uint64(32)).astype(onp.uint32),
                               (idx & onp.uint64(_MASK)).astype(onp.uint32))
        out[start:start + len(idx)] = b0 ^ b1
    return out.reshape(shape)


def uniform(key, shape=(), dtype="float32", minval=0.0,
            maxval=1.0) -> onp.ndarray:
    """Floats in [minval, maxval) of ``shape``, bit for bit those of
    ``jax.random.uniform(key, shape, float32, minval, maxval)`` on JAX's
    CPU backend.

    The fused multiply-add is taken in float64 and rounded once to
    float32. The product of two float32s is exact there, and so is the
    sum whenever it fits in 53 bits, which it does for every range
    [-s, s) and [0, s): then the result is the fused one bit for bit."""
    if onp.dtype(dtype) != onp.float32:
        raise TypeError(f"uniform draws float32 only, not {dtype}")
    lo, hi = onp.float32(minval), onp.float32(maxval)
    bits = random_bits(key, shape)
    bits >>= onp.uint32(32 - 23)
    bits |= onp.uint32(0x3F800000)
    floats = (bits.view(onp.float32) - onp.float32(1.0)).astype(onp.float64)
    floats *= onp.float64(hi - lo)
    floats += onp.float64(lo)
    return onp.maximum(lo, floats.astype(onp.float32))
