"""The reference's synthetic serving traffic, bit for bit, in numpy.

The reference's sessions draw their prompts with
``jax.random.randint(PRNGKey(seed), (batch, prompt_len), 0, vocab)``, and
each later batch under ``fold_in(key, chunk)``.  This module is a numpy
copy of what those calls compute in jax 0.9 with the default
``jax_threefry_partitionable=True``:

* ``threefry2x32``: the Threefry-2x32 block cipher, 20 rounds
  (``jax/_src/prng.py`` ``_threefry2x32_lowering``);
* :func:`prng_key`: ``threefry_seed`` of a 32-bit seed, ``[hi, lo]`` of
  the seed as jax's 32-bit mode holds it (``hi`` is 0);
* :func:`fold_in`: ``threefry_2x32(key, threefry_seed(uint32(data)))``;
* :func:`split`: the fold-like split, keys ``threefry2x32(key, (hi, lo))``
  of the 64-bit counters ``0 .. n-1``;
* :func:`random_bits`: the partitionable 32-bit bits, ``b1 ^ b2`` of the
  cipher applied to the flat element index split as ``(hi, lo)``;
* :func:`randint`: ``jax.random._randint``'s int32 draw, two words per
  value (from the two halves of ``split(key)``) folded into the span by
  ``(hi % span) * (2**32 % span) + lo % span``, with jax's uint32
  wrap-around kept (``2**16 % span`` squared can wrap to 0);
* :func:`uniform`: ``jax.random._uniform`` for float32 in [0, 1): the
  top 23 bits of :func:`random_bits` as the mantissa of a float in
  [1, 2), minus 1.
* :func:`normal_bf16`: ``jax.random.normal(key, shape, jnp.bfloat16)``:
  a bf16 uniform on (nextafter(-1, 0), 1) from the low 8 bits of
  :func:`random_bits` (bf16 has 7 mantissa bits, so jax draws 8-bit
  words), then ``sqrt(2) * erfinv(u)``, every step rounded to bf16 as
  XLA rounds it on the CPU (erfinv computed in fp32).  Only 128 values
  can come out; ``tests/test_torch_encdec.py`` checks each of them
  against jax.

Keys are ``(2,)`` uint32 arrays.  All arithmetic is uint32 with
wrap-around; ``np.errstate`` silences numpy's overflow notes.
"""

from __future__ import annotations

import numpy as np
import torch

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(v: np.ndarray, d: int) -> np.ndarray:
    return (v << np.uint32(d)) | (v >> np.uint32(32 - d))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray) -> tuple:
    """The Threefry-2x32 hash of the word pairs ``(x0, x1)`` under ``key``."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    with np.errstate(over="ignore"):
        x = [np.asarray(x0, np.uint32) + ks[0], np.asarray(x1, np.uint32) + ks[1]]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` for a seed that fits 32 bits signed."""
    seed = int(seed)
    if not -(2**31) <= seed < 2**31:
        raise ValueError(f"seed {seed} does not fit the reference's 32-bit seeds")
    return np.array([0, seed & 0xFFFFFFFF], np.uint32)


def _counters(n: int) -> tuple:
    idx = np.arange(n, dtype=np.uint64)
    return (idx >> np.uint64(32)).astype(np.uint32), (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)``."""
    hi, lo = threefry2x32(key, np.zeros(1, np.uint32),
                          np.array([int(data) & 0xFFFFFFFF], np.uint32))
    return np.array([hi[0], lo[0]], np.uint32)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: ``(num, 2)`` keys."""
    b1, b2 = threefry2x32(key, *_counters(num))
    return np.stack([b1, b2], axis=1)


def random_bits(key: np.ndarray, shape: tuple) -> np.ndarray:
    """32-bit ``random_bits(key, 32, shape)`` as uint32."""
    n = int(np.prod(shape, dtype=np.int64))
    b1, b2 = threefry2x32(key, *_counters(n))
    return (b1 ^ b2).reshape(shape)


def randint(key: np.ndarray, shape: tuple, minval: int, maxval: int) -> np.ndarray:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32), for
    bounds within int32."""
    if not (-(2**31) <= minval and maxval <= 2**31 - 1):
        raise ValueError("randint bounds must fit int32")
    k1, k2 = split(key)
    higher, lower = random_bits(k1, shape), random_bits(k2, shape)
    span = np.uint32(1 if maxval <= minval else (maxval - minval) & 0xFFFFFFFF)
    with np.errstate(over="ignore"):
        multiplier = np.uint32(2**16) % span
        multiplier = (multiplier * multiplier) % span
        offset = ((higher % span) * multiplier + lower % span) % span
    return (np.int64(minval) + offset.astype(np.int64)).astype(np.int32)


def uniform(key: np.ndarray, shape: tuple) -> np.ndarray:
    """``jax.random.uniform(key, shape)`` (float32 in [0, 1))."""
    bits = (random_bits(key, shape) >> np.uint32(9)) | np.uint32(0x3F800000)
    return np.maximum(np.float32(0.0), bits.view(np.float32) - np.float32(1.0))


def normal_bf16(key: np.ndarray, shape: tuple) -> torch.Tensor:
    """``jax.random.normal(key, shape, jnp.bfloat16)`` as a bf16 CPU tensor."""
    bits = (random_bits(key, shape) & np.uint32(0xFF)) >> np.uint32(1)  # 7 mantissa bits
    one = torch.from_numpy((bits | np.uint32(0x3F80)).astype(np.int16)).view(torch.bfloat16)
    floats = one - 1  # exact: [0, 1) on bf16's grid
    lo = torch.tensor(-1 + 2.0**-8, dtype=torch.bfloat16)  # nextafter(-1, 0) in bf16
    u = torch.maximum(lo, floats * (1 - lo) + lo)
    e = torch.erfinv(u.to(torch.float32)).to(torch.bfloat16)
    return torch.tensor(np.sqrt(2), dtype=torch.bfloat16) * e
