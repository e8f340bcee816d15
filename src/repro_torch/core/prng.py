"""Counter-based random numbers, bit for bit as ``jax.random`` draws them
with its default threefry2x32 keys (the port's twin of the parts of
``jax.random`` the serving path and the synthetic data reach: ``PRNGKey``,
``fold_in``, ``split``, ``bits``, ``uniform``, ``normal``, ``gumbel``,
``categorical``, ``randint`` and ``bernoulli``).

A key is an int64 tensor ``[..., 2]`` holding two uint32 words, as
``jax.random.key_data`` shows them.  Every 32-bit word lives in an int64
tensor and every add and shift is masked back to 32 bits: torch's
``uint32`` has no add or shift kernels on CUDA that can be relied on.  All
work stays on the device of its inputs.

Random bits follow jax's *partitionable* layout (``jax_threefry_
partitionable``, on by default since jax 0.5): element ``n`` of a draw of
shape ``shape`` hashes the counter pair ``(n >> 32, n & 0xFFFFFFFF)`` of
its flat index under the key, and its 32 bits are the XOR of the two hash
words.  ``split`` hashes the same counters and keeps both words as the new
key, so ``split(key, n)[i]`` is ``fold_in(key, i)``.

``normal`` is jax's ``sqrt(2) * erf_inv(u)`` with ``u`` uniform on
``[nextafter(-1, 0), 1)``.  ``erf_inv`` is Giles' single-precision
polynomial, the one XLA expands ``erf_inv`` into, with each fused
multiply-add of XLA's CPU code done in float64 and rounded once to
float32; ``torch.erfinv`` is another approximation, up to hundreds of
ulps away.  What remains is ``log1p``: about 1% of draws land within 3
ulps of jax's instead of on them.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_F32_TINY = torch.finfo(torch.float32).tiny
_ONE_BITS = 0x3F800000           # the bits of float32 1.0
_F32_MANTISSA = 23
_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2 = float(np.float32(np.sqrt(2.0)))
# Giles' erf_inv coefficients (w < 5 and w >= 5), highest power first
_ERFINV_LT = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
              -4.39150654e-06, 0.00021858087, -0.00125372503,
              -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE = (-0.000200214257, 0.000100950558, 0.00134934322,
              -0.00367342844, 0.00573950773, -0.0076224613,
              0.00943887047, 1.00167406, 2.83297682)


def threefry_2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                  x1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The threefry2x32 block function (jax's ``threefry2x32_p``), 20
    rounds: the counter words ``(x0, x1)`` hashed under the key words
    ``(k0, k1)``; all four broadcast against each other."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    x0, x1 = torch.broadcast_tensors(x0, x1)
    x0, x1 = x0.contiguous(), x1.contiguous()
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0.add_(x1).bitwise_and_(MASK)
            x1 = ((x1 << r) | (x1 >> (32 - r))).bitwise_and_(MASK)
            x1.bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(MASK)
        x1.add_(ks[(i + 2) % 3] + (i + 1)).bitwise_and_(MASK)
    return x0, x1


def threefry_seed(seed: torch.Tensor) -> torch.Tensor:
    """``jax.random.PRNGKey`` of int32 seeds: ``[..., 2]`` keys whose
    first word is ``seed >> 32`` (0 for a 32-bit seed) and whose second is
    the seed's 32-bit pattern (a negative seed wraps)."""
    seed = seed.to(torch.int64)
    return torch.stack([torch.zeros_like(seed), seed & MASK], dim=-1)


def fold_in(key: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """``jax.random.fold_in``: the hash of the counter ``(0, uint32(data))``
    under ``key``, per key of a batch ``[..., 2]`` (``data`` broadcasts
    against the batch)."""
    if isinstance(data, int):     # made on the device: no host copy
        data = torch.full((), data & MASK, dtype=torch.int64,
                          device=key.device)
    data = torch.as_tensor(data, device=key.device).to(torch.int64) & MASK
    x0, x1 = threefry_2x32(key[..., 0], key[..., 1], torch.zeros_like(data),
                           data)
    return torch.stack([x0, x1], dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` per key of a batch ``[..., 2]``:
    returns ``[..., num, 2]``, key ``i`` the hash of the counter
    ``(i >> 32, i & 0xFFFFFFFF)`` with both words kept."""
    n = torch.arange(num, dtype=torch.int64, device=key.device)
    x0, x1 = threefry_2x32(key[..., 0:1], key[..., 1:2], n >> 32, n & MASK)
    return torch.stack([x0, x1], dim=-1)


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` per key of a batch
    ``[..., 2]``: returns ``[..., *shape]`` int64 holding uint32 values."""
    shape = tuple(int(s) for s in shape)
    n = torch.arange(math.prod(shape), dtype=torch.int64,
                     device=key.device).reshape(shape)
    lead = key.shape[:-1]
    k0 = key[..., 0].reshape(*lead, *([1] * len(shape)))
    k1 = key[..., 1].reshape(*lead, *([1] * len(shape)))
    bits1, bits2 = threefry_2x32(k0, k1, n >> 32, n & MASK)
    return bits1 ^ bits2


def uniform(key: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32: 23 random mantissa bits under
    the exponent of 1.0, minus 1, scaled to ``[minval, maxval)`` and
    floored at ``minval``."""
    bits = random_bits(key, shape)
    floats = (((bits >> (32 - _F32_MANTISSA)) | _ONE_BITS)
              .to(torch.int32).view(torch.float32) - 1.0)
    # the bounds and their span as float32 values (Python floats keep the
    # draw free of host-to-device copies, so a CUDA graph can hold it)
    lo = float(np.float32(minval))
    span = float(np.float32(maxval) - np.float32(minval))
    # XLA's CPU code fuses the scale and shift into one fma (one rounding):
    # the product is exact in float64, the sum rounds once to float32
    return torch.clamp_min((floats.double() * span + lo).float(), lo)


def randint(key: torch.Tensor, shape: Sequence[int], minval: int,
            maxval: int) -> torch.Tensor:
    """``jax.random.randint`` into int32 for int32 bounds: two 32-bit draws
    under ``split(key)``, ``hi`` and ``lo``, folded into ``[minval,
    maxval)`` as jax does it, ``((hi % span) * m + lo % span) % span`` in
    wrapping uint32 with ``m = (2**16 % span)**2 % span`` (the square wraps
    too: 0 for spans above 2**16)."""
    keys = split(key, 2)
    hi = random_bits(keys[..., 0, :], shape)
    lo = random_bits(keys[..., 1, :], shape)
    span = (maxval - minval) & MASK if maxval > minval else 1
    mult = ((2 ** 16 % span) ** 2 & MASK) % span
    # the product of two words below 2**32 may wrap int64: its low 32 bits
    # stay right, and those are all uint32 arithmetic keeps
    off = (((hi % span) * mult & MASK) + lo % span) & MASK
    return (minval + off % span).to(torch.int32)


def bernoulli(key: torch.Tensor, p: float,
              shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.bernoulli`` with a float32 ``p`` (mode ``"low"``): a
    float32 uniform below ``p``."""
    return uniform(key, shape) < float(np.float32(p))


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """float32 inverse error function as XLA computes it (module
    docstring); +-1 map to +-inf."""
    w = -torch.log1p(x * -x)
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0).double()
    coef = lambda i: torch.where(small, _ERFINV_LT[i], _ERFINV_GE[i]).double()
    p = coef(0).float()
    for i in range(1, len(_ERFINV_LT)):
        p = (p.double() * w + coef(i)).float()      # one rounding, as an fma
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


def normal(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.normal`` in float32 (module docstring)."""
    return _SQRT2 * erf_inv(uniform(key, shape, _NORMAL_LO, 1.0))


def gumbel(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.gumbel`` in float32, mode ``"low"``:
    ``-log(-log(u))`` with ``u`` uniform on ``[tiny, 1)``."""
    return -torch.log(-torch.log(uniform(key, shape, _F32_TINY, 1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` over the last axis, one key per row of
    a batch: the gumbel-max draw, ties to the lowest index."""
    noise = gumbel(key, logits.shape[-1:])
    return torch.argmax(noise + logits, dim=-1)
