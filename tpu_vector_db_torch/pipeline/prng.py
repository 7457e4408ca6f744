"""The JAX package's random numbers, without JAX: Threefry-2x32 bits and
``jax.random.normal``.

Only ``encoders.HashingEncoder`` uses this. Its token table is
``jax.random.normal(PRNGKey(seed), (vocab, dim))`` in the JAX package
(``tpu_vector_db/pipeline/encoders.py:231-236``); a table drawn from a
``torch.Generator`` would embed every text differently, and a store
indexed by one package would answer the other's queries with noise.

- ``bits(seed, shape)``: ``jax.random.bits(PRNGKey(seed), shape)``
  (uint32) bit for bit, as JAX draws them with
  ``jax_threefry_partitionable`` on: Threefry-2x32 (20 rounds) under the
  key (0, seed), over the row-major flat index split into a high and a
  low 32-bit word, the two output words xor-ed.
- ``normal(seed, shape)``: ``jax.random.normal(PRNGKey(seed), shape,
  float32)``. The mantissa bits make a uniform in [nextafter(-1, 0), 1),
  exactly as JAX does; ``sqrt(2) * erfinv(u)`` then runs XLA's own
  float32 inverse error function (Giles' polynomial, the one XLA's
  ``ErfInv`` emits). What differs is the last bits of ``log1p`` inside
  it: within 7.2e-7 of JAX's table at (30522, 384), 95% of entries
  equal (``tests/test_torch_encoders.py``).

numpy for the bits (uint32 arithmetic wraps), torch for the float part.
"""

from __future__ import annotations

import numpy as np
import torch

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_MASK32 = 0xFFFFFFFF

# XLA's ErfInv32 coefficients, for w = -log1p(-x*x) < 5 and >= 5
_W_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
          -4.39150654e-06, 0.00021858087, -0.00125372503,
          -0.00417768164, 0.246640727, 1.50140941)
_W_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
          -0.00367342844, 0.00573950773, -0.0076224613,
          0.00943887047, 1.00167406, 2.83297682)


def threefry2x32(key: tuple[int, int], x0: np.ndarray,
                 x1: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32, 20 rounds, on uint32 counter words (x0, x1)."""
    k0, k1 = key[0] & _MASK32, key[1] & _MASK32
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = x0 + np.uint32(ks[0])
    x1 = x1 + np.uint32(ks[1])
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 += x1
            x1 = (x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))
            x1 ^= x0
        x0 += np.uint32(ks[(i + 1) % 3])
        x1 += np.uint32((ks[(i + 2) % 3] + i + 1) & _MASK32)
    return x0, x1


def bits(seed: int, shape: tuple[int, ...]) -> np.ndarray:
    """``jax.random.bits(jax.random.PRNGKey(seed), shape)`` (uint32)."""
    n = int(np.prod(shape))
    if n > _MASK32:
        raise ValueError(f"{n} values: the index's high word is kept 0")
    lo = np.arange(n, dtype=np.uint32)
    hi = np.zeros(n, np.uint32)
    # PRNGKey(seed) of a 32-bit seed (JAX without x64): key (0, seed)
    a, b = threefry2x32((0, seed), hi, lo)
    return (a ^ b).reshape(shape)


def _erfinv_xla(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 inverse error function (Giles' approximation)."""
    w = -torch.log1p(-x * x)
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(small, _W_LT5[0], _W_GE5[0])
    for lt, ge in zip(_W_LT5[1:], _W_GE5[1:]):
        p = torch.where(small, lt, ge) + p * w
    return p * x


def normal(seed: int, shape: tuple[int, ...]) -> torch.Tensor:
    """``jax.random.normal(jax.random.PRNGKey(seed), shape, float32)``
    as a CPU float32 tensor."""
    mant = (bits(seed, shape) >> np.uint32(9)) | np.uint32(0x3F800000)
    floats = torch.from_numpy(mant.view(np.float32)) - 1.0
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    # maxval - minval rounds to 2.0 in float32, as in jax.random.uniform
    u = torch.clamp(floats * 2.0 + lo, min=lo)
    return float(np.float32(np.sqrt(2.0))) * _erfinv_xla(u)
