"""JAX's default random numbers (threefry2x32, partitionable bits) in torch.

The reference's simulator (gnsstpu/sim/generator.py) draws its noise as
jax.random.normal(fold_in(PRNGKey(seed), ms0), shape) and
jax.random.normal(fold_in(that key, 1), shape). With these functions the
port's IFSimulator(noise="jax") draws the same numbers on any device, so
a reference test's signal is made again without JAX. The bits are equal
to JAX's (the threefry2x32 block cipher over the 64-bit linear index,
jax_threefry_partitionable, the default since JAX 0.5); the normals
differ from JAX's only where the two libraries' float32 erfinv differ in
the last bits.

u32 values ride int64 tensors masked with 0xFFFFFFFF (device.U32_MASK).
"""

from __future__ import annotations

import numpy as np
import torch

from gnsstpu_torch.device import U32_MASK, f32

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & U32_MASK


def threefry2x32(key: tuple, x0: torch.Tensor, x1: torch.Tensor) -> tuple:
    """Threefry-2x32 (20 rounds) of the counter words (x0, x1) under the
    key (k0, k1) (Python ints): the reference's threefry2x32_p."""
    k0, k1 = int(key[0]) & U32_MASK, int(key[1]) & U32_MASK
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & U32_MASK
    x1 = (x1 + ks[1]) & U32_MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & U32_MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & U32_MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & U32_MASK
    return x0, x1


def prng_key(seed: int) -> tuple:
    """jax.random.PRNGKey(seed) for a 32-bit seed: (0, seed)."""
    return (0, int(seed) & U32_MASK)


def fold_in(key: tuple, data: int) -> tuple:
    """jax.random.fold_in(key, data): the cipher of the counter
    (0, data)."""
    y0, y1 = threefry2x32(key, torch.zeros(1, dtype=torch.int64),
                          torch.full((1,), int(data) & U32_MASK,
                                     dtype=torch.int64))
    return (int(y0[0]), int(y1[0]))


def random_bits(key: tuple, shape: tuple, device) -> torch.Tensor:
    """jax.random.bits(key, shape) (32-bit): the cipher of each element's
    64-bit linear index, its two output words xored."""
    n = int(np.prod(shape))
    idx = torch.arange(n, dtype=torch.int64, device=device)
    y0, y1 = threefry2x32(key, idx >> 32, idx & U32_MASK)
    return (y0 ^ y1).reshape(shape)


def uniform(key: tuple, shape: tuple, minval: float, maxval: float,
            device) -> torch.Tensor:
    """jax.random.uniform (float32): 23 random mantissa bits under the
    exponent of 1.0, shifted and scaled into [minval, maxval)."""
    bits = random_bits(key, shape, device)
    one = torch.tensor(1.0, dtype=torch.float32, device=device)
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(
        torch.float32) - one
    lo = torch.tensor(minval, dtype=torch.float32, device=device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def normal(key: tuple, shape: tuple, device) -> torch.Tensor:
    """jax.random.normal (float32): sqrt(2) * erfinv of a uniform draw on
    (-1, 1)."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(key, shape, lo, 1.0, device)
    return f32(np.sqrt(2)) * torch.erfinv(u)
