"""The JAX package's random draws, in numpy: threefry keys and the samplers
and flax parameter keys its seeded initialisation uses.

The port's entry points draw their seeded weights here, so that a run at
``--seed`` starts from the initial weights of the JAX entry point at the
same seed: ``jax.random.PRNGKey``, ``split``, ``fold_in`` (threefry2x32,
partitionable mode, JAX's default), ``uniform`` and
``truncated_normal``, and flax's derivation of a parameter's key from its
module path (``flax.core.scope._fold_in_static``: the SHA-1 of the path
folded into the init key). Keys and uniform draws are JAX's bit for bit;
``erf`` and ``erf_inv`` are evaluated in float64 and rounded, so a
truncated normal draw may differ from XLA's float32 polynomials in its last
bits (a few ulps).
"""
from __future__ import annotations

import hashlib
from typing import Sequence, Tuple, Union

import numpy as np
import torch

_U32 = np.uint32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# the std of a standard normal truncated at +-2 (flax's variance_scaling)
TRUNC2_STD = 0.87962566103423978


def _threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 hash of the counter pairs ``(x0, x1)`` (20 rounds)."""
    k1, k2 = _U32(key[0]), _U32(key[1])
    ks = (k1, k2, _U32(k1 ^ k2 ^ _U32(0x1BD11BDA)))
    x0, x1 = np.array(x0, _U32), np.array(x1, _U32)
    with np.errstate(over="ignore"):
        x0 += ks[0]
        x1 += ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 += x1
                x1 = (x1 << _U32(r)) | (x1 >> _U32(32 - r))
                x1 ^= x0
            x0 += ks[(i + 1) % 3]
            x1 += ks[(i + 2) % 3] + _U32(i + 1)
    return x0, x1


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)``'s two words (a seed below 2^31, as JAX
    takes it without 64-bit mode)."""
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], _U32)


def _hash_counts(key: np.ndarray, n: int) -> Tuple[np.ndarray, np.ndarray]:
    count = np.arange(n, dtype=np.uint64)
    return _threefry2x32(key, (count >> np.uint64(32)).astype(_U32),
                         (count & np.uint64(0xFFFFFFFF)).astype(_U32))


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: ``[num, 2]`` keys."""
    return np.stack(_hash_counts(key, num), axis=1)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)``."""
    seed = prng_key(int(data) & 0xFFFFFFFF)
    b0, b1 = _threefry2x32(key, seed[:1], seed[1:])
    return np.concatenate([b0, b1])


def _bits(key: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    b0, b1 = _hash_counts(key, int(np.prod(shape)))
    return (b0 ^ b1).reshape(shape)


def uniform(key: np.ndarray, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> np.ndarray:
    """``jax.random.uniform`` in float32 (its scale and shift one fused
    multiply-add, as XLA evaluates it: the float32 product is exact in
    float64)."""
    lo, hi = np.float32(minval), np.float32(maxval)
    f = ((_bits(key, shape) >> _U32(9)) | _U32(0x3F800000)).view(np.float32) - np.float32(1.0)
    scaled = (f.astype(np.float64) * np.float64(hi - lo) + np.float64(lo)).astype(np.float32)
    return np.maximum(lo, scaled)


def _erf(x: np.ndarray) -> np.ndarray:
    return torch.special.erf(torch.from_numpy(np.asarray(x, np.float64))).numpy().astype(np.float32)


def _erfinv(u: np.ndarray) -> np.ndarray:
    return torch.special.erfinv(torch.from_numpy(np.asarray(u, np.float64))).numpy().astype(np.float32)


def truncated_normal(key: np.ndarray, lower: float, upper: float,
                     shape: Sequence[int]) -> np.ndarray:
    """``jax.random.truncated_normal`` in float32."""
    sqrt2 = np.float32(np.sqrt(2))
    lower, upper = np.float32(lower), np.float32(upper)
    u = uniform(key, shape, _erf(lower / sqrt2), _erf(upper / sqrt2))
    return np.clip(sqrt2 * _erfinv(u), np.nextafter(lower, np.float32(np.inf)),
                   np.nextafter(upper, np.float32(-np.inf)))


def flax_key(key: np.ndarray, path: Sequence[Union[str, int]]) -> np.ndarray:
    """The key flax hands a parameter initialiser: the module path below the
    init key, then the scope's draw count (1 for a layer's first parameter,
    2 for its second), hashed with SHA-1 and folded in."""
    m = hashlib.sha1()
    for x in path:
        m.update(x.encode("utf-8") if isinstance(x, str)
                 else x.to_bytes((x.bit_length() + 7) // 8, byteorder="big"))
    return fold_in(key, int.from_bytes(m.digest()[:4], byteorder="big"))


def lecun_normal(key: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """flax's default kernel initialiser for a ``[..., fan_in_last, out]``
    kernel: a normal truncated at +-2, scaled to variance 1 / fan_in."""
    fan_in = int(np.prod(shape[:-1]))
    std = np.float32(np.sqrt(1.0 / fan_in)) / np.float32(TRUNC2_STD)
    return truncated_normal(key, -2.0, 2.0, shape) * std
