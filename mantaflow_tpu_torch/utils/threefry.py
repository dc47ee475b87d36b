"""JAX's counter-based PRNG, threefry-2x32, as ``jax.random`` computes it.

``PRNGKey``, ``split`` and float32 ``uniform`` give ``jax.random``'s bits
bit for bit under JAX 0.9.0 with ``jax_threefry_partitionable`` True (its
default there): a key is two uint32 words; ``split`` hashes the 64-bit
iota of the key array's shape (``_threefry_split_foldlike``); ``uniform``
hashes the 64-bit iota of the draw's shape and takes the two words' xor
(``_threefry_random_bits_partitionable``), then fills the float32
mantissa. The ports of the JAX package's whitewater and surface
turbulence draw from this stream, so their candidates are the JAX
package's.

PyTorch has no full uint32 arithmetic on the card, so the 32-bit words
live in int64 tensors, masked to 32 bits after every add and left
rotation. The draws run on the key's device: ``uniform`` returns its
floats there, with no host copy.
"""

from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def PRNGKey(seed: int, device=None):
    """jax.random.PRNGKey for a 32-bit seed: (0, seed) as two words (int64
    tensor of shape (2,))."""
    if not -2 ** 31 <= int(seed) < 2 ** 31:
        raise ValueError(f"seed {seed} outside int32")
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.int64,
                        device=device)


def _rotl(x, r: int):
    return ((x << r) & _MASK) | (x >> (32 - r))


def threefry2x32(k1, k2, x0, x1):
    """The threefry-2x32 hash, 20 rounds (jax._src.prng.threefry2x32)."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def _iota_2x32(shape, device):
    """The (hi, lo) words of the row-major 64-bit iota over ``shape``."""
    n = 1
    for d in shape:
        n *= int(d)
    idx = torch.arange(n, dtype=torch.int64, device=device).reshape(shape)
    return idx >> 32, idx & _MASK


def split(key, num: int = 2):
    """jax.random.split: (num, 2) keys."""
    hi, lo = _iota_2x32((num,), key.device)
    b1, b2 = threefry2x32(key[0], key[1], hi, lo)
    return torch.stack([b1, b2], dim=1)


def random_bits(key, shape):
    """32-bit draws of ``shape`` (int64 tensor holding uint32 values)."""
    hi, lo = _iota_2x32(tuple(shape), key.device)
    b1, b2 = threefry2x32(key[0], key[1], hi, lo)
    return b1 ^ b2


def uniform(key, shape, dtype=torch.float32):
    """jax.random.uniform in [0, 1), float32 only."""
    if dtype != torch.float32:
        raise ValueError("threefry.uniform: float32 only")
    bits = (random_bits(key, shape) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0
