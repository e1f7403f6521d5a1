"""The reference's PRNG draw, bit for bit: JAX's threefry2x32 `fold_in`,
`random_bits` (the partitionable form, `jax_threefry_partitionable` True,
the default since jax 0.5), `uniform` and the Gumbel noise of
`jax.random.categorical`, as plain functions on tensors on any device.

uint32 values live in int64 tensors masked with 0xFFFFFFFF (torch's uint32
lacks CUDA add and shift kernels); threefry needs only add, xor and rotate.
The integer bits and the uniforms are exact on every device; `log` may
round differently by an ulp across backends, so a Gumbel-max token can
differ from the reference's only where the top two values lie within a
few ulps.
"""
from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# float32 smallest normal: jax.random.uniform's minval under _gumbel
TINY = torch.finfo(torch.float32).tiny


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & M32) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds (jax/_src/prng.py::_threefry2x32_lowering)
    on uint32 values held in int64; the arguments broadcast. → (y0, y1)."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = x0 ^ _rotl(x1, r)
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def fold_in(keys: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """`jax.vmap(jax.random.fold_in)`: keys [n, 2], data [n] (any integer
    dtype, taken mod 2^32) → keys [n, 2] int64, the threefry hash of the
    count pair (0, data)."""
    k0, k1 = keys[:, 0].long() & M32, keys[:, 1].long() & M32
    d = data.long() & M32
    y0, y1 = threefry2x32(k0, k1, torch.zeros_like(d), d)
    return torch.stack([y0, y1], dim=1)


def random_bits32(keys: torch.Tensor, V: int) -> torch.Tensor:
    """`jax.vmap(lambda k: jax.random.bits(k, (V,)))` for keys [n, 2]: the
    counts are a 64-bit iota over the shape split as (hi 0, lo arange(V)),
    the 32 bits `y0 ^ y1` (prng.py::_threefry_random_bits_partitionable).
    → [n, V] int64 holding uint32 values."""
    k0 = keys[:, 0:1].long() & M32
    k1 = keys[:, 1:2].long() & M32
    lo = torch.arange(V, device=keys.device, dtype=torch.long)[None]
    y0, y1 = threefry2x32(k0, k1, torch.zeros_like(lo), lo)
    return y0 ^ y1


def uniform(bits: torch.Tensor, minval: float = TINY) -> torch.Tensor:
    """`jax.random.uniform(..., minval=minval, maxval=1.0)` in float32 from
    its 32 random bits: the top 23 bits as the mantissa of a float in
    [1, 2), minus 1, scaled to [minval, 1) and floored at minval."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = float(np.float32(minval))          # the float32 operands, exactly
    span = float(np.float32(1.0) - np.float32(minval))
    return torch.clamp_min(f * span + lo, lo)


def gumbel(keys: torch.Tensor, V: int) -> torch.Tensor:
    """`jax.vmap(lambda k: jax.random.gumbel(k, (V,)))` in mode "low" (the
    default): -log(-log(u)), u uniform in [tiny, 1). → [n, V] float32."""
    return -torch.log(-torch.log(uniform(random_bits32(keys, V))))
