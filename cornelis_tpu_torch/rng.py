"""Root key words and hemisphere sampling.

Counterpart of `cornelis_tpu/rng.py` for what the megakernel uses. The
kernel's key words are `jax.random.key_data(jax.random.key(seed))`
(pallas_integrator.py:1044). For threefry2x32 keys with 64-bit mode off
that is (0, seed) for every seed in [0, 2^32); `tests/test_torch_rng.py`
pins it against jax. Seeds outside that range raise rather than guess.

The kernel's third key word roots the Sobol scrambles:
`hash32(jax.random.bits(fold_in(key, 0x50B0), (), uint32))`
(pallas_integrator.py:1045-1049). With jax's partitionable Threefry that is
hash32(b0 ^ b1), where (f0, f1) = threefry2x32((0, seed), (0, 0x50B0)) and
(b0, b1) = threefry2x32((f0, f1), (0, 0)); `tests/test_torch_sampling.py`
pins it against jax.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .math.vec import PI, Basis, Vec3
from .ops.threefry import threefry2x32
from .sampling import hash32

# Reference default seed (PRNG.hpp:12).
DEFAULT_SEED = 19791102


def key_words(seed: int) -> Tuple[int, int]:
    """Seed -> the (k0, k1) Threefry key words of the JAX megakernel."""
    seed = int(seed)
    if not 0 <= seed < 1 << 32:
        raise ValueError(f"seed must be in [0, 2^32) (got {seed})")
    return 0, seed


def key_row(seed: int) -> Tuple[int, int, int]:
    """Seed -> the kernel's key row (k0, k1, Sobol root word)."""
    k0, k1 = key_words(seed)
    zero = torch.zeros(1, dtype=torch.int64)
    f0, f1 = threefry2x32(k0, k1, zero, zero + 0x50B0)
    b0, b1 = threefry2x32(f0, f1, zero, zero)
    return k0, k1, int(hash32(b0 ^ b1)[0])


def hemisphere_sample(x1: torch.Tensor, x2: torch.Tensor) -> Vec3:
    """Uniform hemisphere direction in the canonical frame (PRNG.hpp:39-46):
    z = x1, azimuth 2 pi x2."""
    a = 2.0 * PI * x2
    b = torch.sqrt(torch.clamp_min(1.0 - x1 * x1, 0.0))
    return Vec3(torch.cos(a) * b, torch.sin(a) * b, x1)


def hemisphere_sample_basis(x1: torch.Tensor, x2: torch.Tensor, basis: Basis) -> Vec3:
    """Hemisphere sample placed in a surface basis (PRNG.hpp:52-55): the
    canonical v lands as v0*B + v1*T + v2*N (B first)."""
    v = hemisphere_sample(x1, x2)
    return basis.b * v.x + basis.t * v.y + basis.n * v.z


def hemisphere_pdf() -> float:
    """Uniform hemisphere pdf = 1/(2 pi) (PRNG.hpp:62)."""
    return 1.0 / (2.0 * PI)
