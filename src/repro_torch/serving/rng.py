"""Counter-based sampling uniforms, bit-exact with the JAX package.

The JAX serving stack draws the uniform that samples the token at
sequence index ``pos`` of a request with key ``seed`` as

    uniform(fold_in(fold_in(PRNGKey(0), seed), pos))

(``repro/serving/device_state.py: counter_uniform``), with JAX's default
threefry2x32 PRNG and ``jax_threefry_partitionable`` on.  Unrolled, that
is three threefry2x32 hashes:

  * ``PRNGKey(0)`` is the key pair ``(0, 0)`` (``threefry_seed`` splits a
    64-bit seed into high and low words; the high word of an int32 seed
    is 0);
  * ``fold_in(key, d)`` hashes the counter pair ``(0, d)`` under ``key``
    (``threefry_seed(d)`` as the count) and the two output words are the
    new key;
  * ``uniform`` of shape ``()`` hashes the counter pair ``(0, 0)`` (the
    partitionable ``iota_2x32_shape`` of a scalar), XORs the two output
    words, keeps the top 23 bits as the mantissa of a float in [1, 2)
    (``bits >> 9 | 0x3F800000``) and subtracts 1.

:func:`counter_uniform` does this on int64 tensors, every sum and shift
masked to 32 bits, so it runs inside the fused step on the card (or the
CPU) for a whole batch of ``(seed, pos)`` pairs at once;
:func:`counter_uniform_np` is its numpy twin on uint32 arrays.  Both
return float32 uniforms bit-identical to JAX 0.9's.
"""

from __future__ import annotations

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA  # threefry's key-schedule constant


def _threefry2x32(k0, k1, x0, x1, *, add, rotl):
    """The 20-round threefry2x32 hash of the counter pair ``(x0, x1)``
    under the key pair ``(k0, k1)``, written once for both array types:
    ``add`` is a 32-bit wrapping sum and ``rotl`` a 32-bit left rotation.
    """
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = add(x0, ks[0])
    x1 = add(x1, ks[1])
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = add(x0, x1)
            x1 = rotl(x1, r) ^ x0
        x0 = add(x0, ks[(i + 1) % 3])
        x1 = add(add(x1, ks[(i + 2) % 3]), i + 1)
    return x0, x1


def _add_t(a, b):
    return (a + b) & _MASK


def _rotl_t(x, r: int):
    return ((x << r) & _MASK) | (x >> (32 - r))


def counter_uniform(seed: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """float32 uniforms in [0, 1) for elementwise ``(seed, pos)`` pairs
    (integer tensors of one shape, on any device; each value is read as
    its low 32 bits, as ``fold_in`` converts to uint32)."""
    seed = seed.to(torch.int64) & _MASK
    pos = pos.to(torch.int64) & _MASK
    zero = torch.zeros_like(seed)
    k0, k1 = _threefry2x32(zero, zero, zero, seed, add=_add_t, rotl=_rotl_t)
    k0, k1 = _threefry2x32(k0, k1, zero, pos, add=_add_t, rotl=_rotl_t)
    b0, b1 = _threefry2x32(k0, k1, zero, zero, add=_add_t, rotl=_rotl_t)
    bits = ((b0 ^ b1) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def _add_np(a, b):
    return (a + np.uint32(b)).astype(np.uint32)


def _rotl_np(x, r: int):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def counter_uniform_np(seed, pos) -> np.ndarray:
    """The numpy twin of :func:`counter_uniform` (uint32 arithmetic)."""
    with np.errstate(over="ignore"):
        seed = np.asarray(seed, np.int64).astype(np.uint32)
        pos = np.asarray(pos, np.int64).astype(np.uint32)
        seed, pos = np.broadcast_arrays(seed, pos)
        zero = np.zeros(seed.shape, np.uint32)
        k0, k1 = _threefry2x32(zero, zero, zero, seed, add=_add_np,
                               rotl=_rotl_np)
        k0, k1 = _threefry2x32(k0, k1, zero, pos, add=_add_np,
                               rotl=_rotl_np)
        b0, b1 = _threefry2x32(k0, k1, zero, zero, add=_add_np,
                               rotl=_rotl_np)
        bits = ((b0 ^ b1) >> np.uint32(9)) | np.uint32(0x3F800000)
    return bits.view(np.float32) - np.float32(1.0)
