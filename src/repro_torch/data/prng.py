"""JAX's threefry-2x32 key stream, reimplemented in vectorised numpy uint32
arithmetic, so the port draws the same tokens as the JAX package's data
pipeline without importing JAX.

It follows `jax._src.prng` and `jax._src.random` with
``jax_threefry_partitionable=True`` (the JAX 0.9 default): `split` and the
random bits hash a 64-bit iota counter (high word 0 here) with the key, and
32-bit bits are the XOR of the hash's two output words. Keys are ``(2,)``
uint32 arrays (or ``(..., 2)`` for a batch of keys).

`randint` and every split are bit-exact. `categorical` is the Gumbel-max
draw ``argmax(log_w + gumbel)`` with the "low" Gumbel mode; it goes through
``log``, which numpy evaluates in float64 and rounds to float32 (XLA's float32
log may differ by an ulp, which could flip an argmax between two near-equal
candidates; the tests count such flips on their grid).
"""
from __future__ import annotations

import numpy as np

_U32 = np.uint32
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << _U32(d)) | (x >> _U32(32 - d))


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 block hash (20 rounds) of counter words (x1, x2)
    under key (k1, k2); all broadcast uint32. Returns two uint32 arrays."""
    k1, k2 = np.asarray(k1, _U32), np.asarray(k2, _U32)
    ks = (k1, k2, k1 ^ k2 ^ _U32(0x1BD11BDA))
    with np.errstate(over="ignore"):
        x0 = np.asarray(x1, _U32) + ks[0]
        x1_ = np.asarray(x2, _U32) + ks[1]
        for i in range(5):
            for r in _ROT[i % 2]:
                x0 = x0 + x1_
                x1_ = _rotl(x1_, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1_ = x1_ + ks[(i + 2) % 3] + _U32(i + 1)
    return x0, x1_


def prng_key(seed: int) -> np.ndarray:
    """`jax.random.PRNGKey(seed)` for a 32-bit seed: ``[0, seed]``."""
    return np.array([0, int(seed) & 0xFFFFFFFF], _U32)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """`jax.random.fold_in`: hash the counter pair (0, data) under key."""
    a, b = threefry2x32(key[..., 0], key[..., 1], _U32(0),
                        _U32(int(data) & 0xFFFFFFFF))
    return np.stack([a, b], axis=-1)


def _counters(n: int):
    """Low words of the 64-bit iota counter 0..n-1 (high words are 0)."""
    if n >= 1 << 32:
        raise ValueError("counter beyond 2**32 draws is not supported")
    return np.arange(n, dtype=_U32)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """`jax.random.split(key, num)`: ``(num, 2)`` keys (or ``(..., num, 2)``
    for a batch of keys)."""
    lo = _counters(num)
    a, b = threefry2x32(key[..., 0, None], key[..., 1, None], _U32(0), lo)
    return np.stack([a, b], axis=-1)


def random_bits32(key: np.ndarray, shape) -> np.ndarray:
    """32-bit random bits of `shape` (leading dims of a key batch are kept:
    keys (..., 2) -> (..., *shape))."""
    n = int(np.prod(shape, dtype=np.int64))
    lo = _counters(n)
    k = key.reshape(-1, 2)
    a, b = threefry2x32(k[:, 0, None], k[:, 1, None], _U32(0), lo)
    return (a ^ b).reshape(key.shape[:-1] + tuple(shape))


def randint(key: np.ndarray, shape, minval: int, maxval: int) -> np.ndarray:
    """`jax.random.randint(key, shape, minval, maxval)` with int32 output:
    two 32-bit draws folded into [minval, maxval) by the modulus rule."""
    k = split(key, 2)
    hi = random_bits32(k[0], shape)
    lo = random_bits32(k[1], shape)
    span = _U32(max(1, maxval - minval))
    with np.errstate(over="ignore"):
        mult = _U32(2 ** 16) % span
        mult = (mult * mult) % span
        off = ((hi % span) * mult + lo % span) % span
    return (np.int64(minval) + off.astype(np.int64)).astype(np.int32)


def uniform01_tiny(key: np.ndarray, shape) -> np.ndarray:
    """`jax.random.uniform(key, shape, minval=tiny, maxval=1.)` in float32:
    23 mantissa bits, exponent of 1.0, minus 1, times (1 - tiny) = 1.0 in
    float32, plus tiny, floored at tiny."""
    tiny = np.finfo(np.float32).tiny
    bits = random_bits32(key, shape)
    f = ((bits >> _U32(9)) | _U32(0x3F800000)).view(np.float32) \
        - np.float32(1.0)
    span = np.float32(1.0) - np.float32(tiny)
    return np.maximum(np.float32(tiny), f * span + np.float32(tiny))


def _log32(x: np.ndarray) -> np.ndarray:
    return np.log(x.astype(np.float64)).astype(np.float32)


def gumbel(key: np.ndarray, shape) -> np.ndarray:
    """`jax.random.gumbel(key, shape, float32)` in "low" mode:
    ``-log(-log(u))``."""
    u = uniform01_tiny(key, shape)
    return -_log32(-_log32(u))


def categorical(key: np.ndarray, log_w: np.ndarray, batch: int) -> np.ndarray:
    """`jax.random.categorical(key, log_w[None].repeat(batch, 0))`: one draw
    per row over the last axis. A batch of keys (..., 2) gives (..., batch)."""
    n = log_w.shape[-1]
    g = gumbel(key, (batch, n))
    return np.argmax(g + log_w.astype(np.float32), axis=-1).astype(np.int32)
