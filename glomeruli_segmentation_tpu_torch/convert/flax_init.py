"""Flax's default initial weights of a parameter, drawn with numpy.

``model.init(jax.random.key(seed), ...)`` gives every parameter a key of
its own and draws it from that key.  This module draws the same numbers
without JAX, so that a trainer of the port starts from the JAX package's
weights for the same seed:

- the root key is ``(0, seed)`` (``threefry_seed``);
- a parameter's key folds into the root key (``jax.random.fold_in``) the
  first four bytes, big-endian, of the SHA-1 of its module path's names
  and its creation count in that module (1 for a kernel or a BN scale, 2
  for a bias), hashed together (``flax.core.scope.LazyRng``, without the
  separator byte, Flax's default);
- ``fold_in(key, d)`` is Threefry-2x32 of the counter ``(0, d)``; the 32
  random bits of element ``i`` of a draw are the two words of
  Threefry-2x32 of ``(0, i)`` xor-ed (``jax_threefry_partitionable``, the
  default since JAX 0.5);
- bits become a float in [0, 1) through the mantissa, a uniform in
  ``[erf(-sqrt 2), erf(sqrt 2))``, ``sqrt(2) erfinv(u)`` a normal cut at
  two standard deviations (``jax.random.truncated_normal``), scaled by
  ``sqrt(1 / fan_in) / 0.8796...`` (``lecun_normal``, Flax's default
  kernel init).

``erf`` and ``erfinv`` are evaluated here in float64 and float32
(XLA's single-precision polynomial for ``erfinv``), so a weight may differ
from the JAX package's in its last bit.
"""
from __future__ import annotations

import hashlib
import math
from typing import Sequence, Tuple

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# the standard deviation of a unit normal cut at +-2
_TRUNCATED_STD = 0.87962566103423978
# XLA's ErfInv32 coefficients (Giles, "Approximating the erfinv function")
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                 -4.39150654e-06, 0.00021858087, -0.00125372503,
                 -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322,
                 -0.00367342844, 0.00573950773, -0.0076224613,
                 0.00943887047, 1.00167406, 2.83297682)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key: Tuple[int, int], x0: np.ndarray, x1: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 with 20 rounds of ``key`` over the counter words
    ``(x0, x1)`` (uint32 arrays of one shape)."""
    ks = [np.uint32(key[0]), np.uint32(key[1])]
    ks.append(ks[0] ^ ks[1] ^ np.uint32(0x1BD11BDA))
    x0 = np.asarray(x0, np.uint32) + ks[0]
    x1 = np.asarray(x1, np.uint32) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def fold_in(key: Tuple[int, int], data: int) -> Tuple[int, int]:
    """``jax.random.fold_in`` of a uint32 ``data``."""
    y0, y1 = threefry2x32(key, np.zeros(1, np.uint32),
                          np.full(1, data, np.uint32))
    return int(y0[0]), int(y1[0])


def param_key(seed: int, path: Sequence[str], count: int) -> Tuple[int, int]:
    """The key Flax gives the ``count``-th parameter (from 1) created in
    the module at ``path`` under ``model.init(jax.random.key(seed))``."""
    digest = hashlib.sha1()
    for part in path:
        digest.update(part.encode("utf-8"))
    digest.update(count.to_bytes((count.bit_length() + 7) // 8, "big"))
    return fold_in((0, seed), int.from_bytes(digest.digest()[:4], "big"))


def random_bits(key: Tuple[int, int], n: int) -> np.ndarray:
    """``n`` words of 32 random bits (``jax.random.bits``)."""
    y0, y1 = threefry2x32(key, np.zeros(n, np.uint32),
                          np.arange(n, dtype=np.uint32))
    return y0 ^ y1


def _erfinv32(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.float32)
    w = -np.log1p(-x * x)
    small = w < np.float32(5.0)
    w = np.where(small, w - np.float32(2.5),
                 np.sqrt(w) - np.float32(3.0)).astype(np.float32)
    p = np.where(small, np.float32(_ERFINV_SMALL[0]),
                 np.float32(_ERFINV_LARGE[0]))
    for lo, hi in zip(_ERFINV_SMALL[1:], _ERFINV_LARGE[1:]):
        p = (np.where(small, np.float32(lo), np.float32(hi))
             + p * w).astype(np.float32)
    return (p * x).astype(np.float32)


def lecun_normal(key: Tuple[int, int], shape: Sequence[int],
                 fan_in: int) -> np.ndarray:
    """Flax's ``lecun_normal()`` draw of ``shape`` (float32)."""
    n = int(np.prod(shape))
    bits = random_bits(key, n)
    floats = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(
        np.float32) - np.float32(1.0)
    lo = np.float32(math.erf(-2.0 / math.sqrt(2.0)))
    hi = np.float32(math.erf(2.0 / math.sqrt(2.0)))
    u = np.maximum(lo, floats * (hi - lo) + lo).astype(np.float32)
    out = np.float32(math.sqrt(2.0)) * _erfinv32(u)
    out = np.clip(out, np.nextafter(np.float32(-2), np.float32(np.inf)),
                  np.nextafter(np.float32(2), np.float32(-np.inf)))
    std = np.float32(math.sqrt(1.0 / fan_in) / _TRUNCATED_STD)
    return (out * std).astype(np.float32).reshape(tuple(shape))
