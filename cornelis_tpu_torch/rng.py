"""Keys, per-ray draws and hemisphere sampling.

Counterpart of `cornelis_tpu/rng.py`: the megakernel's key row, and the
XLA wavefront's per-ray streams with the `jax.random` functions they use
(`make_key`, `fold_in`, `split`, `bits`, `uniform`), bit for bit under
jax's partitionable Threefry. A key is a (..., 2) int64 tensor of two
32-bit words. `fold_in(k, x)` is threefry2x32(k, (0, x)); `split` and
`bits` count with a 64-bit iota over the output shape, split into
(hi, lo) counter words; `bits` xors the two output words; `uniform` maps
bits to floats by jax's mantissa fill, (bits >> 9) | 0x3F800000 read as
a float32, minus 1 (not the kernel's `to_unit_float`).
`tests/test_torch_rng.py` pins each against jax.

`make_ray_streams` and `stream_uniforms` (sampler "uniform") dispatch on
the device of their tensors: on a CUDA device each call is one launch of
the draws kernel (ops/draws.py, ops/csrc/draws.cu), bit for bit the torch
code here, which runs for tensors on the CPU.

The kernel's key words are `jax.random.key_data(jax.random.key(seed))`
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

from typing import NamedTuple, Tuple

import torch

from .math.vec import PI, Basis, Vec3
from .ops import draws
from .ops.threefry import threefry2x32
from .sampling import hash32
from .utils import trace

# Reference default seed (PRNG.hpp:12).
DEFAULT_SEED = 19791102

# Stream ids of the wavefront's draw groups: the camera jitter, then
# bounce d on STREAM_BOUNCE_BASE + d (rng.py:30-35 of the JAX package).
STREAM_CAMERA = 0
STREAM_BOUNCE_BASE = 1

_MASK = 0xFFFFFFFF
# The word 1.0f, under which `uniform` fills 23 random mantissa bits.
_ONE_BITS = 0x3F800000
# Sobol seeds take one word of root entropy, from fold_in(root, 0x50B0).
_SOBOL_ROOT = 0x50B0


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


def make_key(seed: int = DEFAULT_SEED, device="cpu") -> torch.Tensor:
    """`jax.random.key(seed)`'s words, as a (2,) int64 tensor."""
    return torch.tensor(key_words(seed), dtype=torch.int64, device=device)


def _iota_2x32(n: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) words of a 64-bit iota of length n."""
    i = torch.arange(n, dtype=torch.int64, device=device)
    return i >> 32, i & _MASK


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """`jax.random.fold_in`: threefry2x32(key, (0, data)). key (..., 2);
    data an int or an int64 tensor broadcasting against key[..., 0]."""
    if torch.is_tensor(data):
        b0, b1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data), data)
    else:
        b0, b1 = threefry2x32(key[..., 0], key[..., 1], 0, int(data) & _MASK)
    return torch.stack(torch.broadcast_tensors(b0, b1), dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """`jax.random.split` of one (2,) key: (num, 2) keys."""
    hi, lo = _iota_2x32(num, key.device)
    b0, b1 = threefry2x32(key[0], key[1], hi, lo)
    return torch.stack([b0, b1], dim=-1)


def bits(key: torch.Tensor, num: int) -> torch.Tensor:
    """`jax.random.bits(key, (num,), uint32)` for a batch of keys (..., 2):
    (..., num) words in int64."""
    hi, lo = _iota_2x32(num, key.device)
    b0, b1 = threefry2x32(key[..., 0, None], key[..., 1, None], hi, lo)
    return b0 ^ b1


def bits_to_uniform(words: torch.Tensor) -> torch.Tensor:
    """uint32 words -> float32 in [0, 1) as `jax.random.uniform` maps them."""
    fill = ((words >> 9) | _ONE_BITS).to(torch.int32)
    return fill.view(torch.float32) - 1.0


def uniform(key: torch.Tensor, num: int) -> torch.Tensor:
    """`jax.random.uniform(key, (num,))` for a batch of keys (..., 2)."""
    return bits_to_uniform(bits(key, num))


def ray_keys(root: torch.Tensor, ray_ids: torch.Tensor) -> torch.Tensor:
    """Per-ray keys fold_in(root, ray_id) from global ray ids (uint32
    values): (N, 2)."""
    return fold_in(root, ray_ids.to(torch.int64) & _MASK)


def pixel_sample_keys(root: torch.Tensor, pixel_ids: torch.Tensor,
                      sample_idx: torch.Tensor) -> torch.Tensor:
    """Per-ray keys fold_in(fold_in(root, pixel), sample): (N, 2)."""
    return fold_in(fold_in(root, pixel_ids), sample_idx)


def ray_uniforms(ray_key: torch.Tensor, stream: int, num: int) -> torch.Tensor:
    """`num` uniforms per ray of draw group `stream`: (N, num) float32."""
    return uniform(fold_in(ray_key, stream), num)


class RayStreams(NamedTuple):
    """Per-ray sampler state: the Threefry keys (N, 2) drive the uniform
    sampler, the per-pixel seed and the sample index the Sobol one."""

    key: torch.Tensor
    pixel_seed: torch.Tensor
    sample_idx: torch.Tensor


def make_ray_streams(root: torch.Tensor, pixel_ids: torch.Tensor,
                     sample_idx: torch.Tensor) -> RayStreams:
    """Sampler state from global (pixel, sample) pairs, so that any
    partition of pixels or samples draws the same numbers. The Sobol seed
    is hash32(pixel ^ hash32(one word of fold_in(root, 0x50B0)))."""
    with trace.span("ct.rng.draws"):
        pixel_ids = pixel_ids.to(torch.int64)
        sample_idx = sample_idx.to(torch.int64)
        if pixel_ids.device.type == "cuda":
            key, pixel_seed = draws.ray_streams(
                root.to(pixel_ids.device, torch.int64).contiguous(), pixel_ids.contiguous(),
                sample_idx.contiguous())
            return RayStreams(key=key, pixel_seed=pixel_seed, sample_idx=sample_idx)
        root_word = bits(fold_in(root, _SOBOL_ROOT), 1)[0]
        return RayStreams(
            key=pixel_sample_keys(root, pixel_ids, sample_idx),
            pixel_seed=hash32(pixel_ids ^ hash32(root_word)),
            sample_idx=sample_idx,
        )


def stream_uniforms(streams: RayStreams, stream: int, num: int, sampler: str = "uniform",
                    index_bits: int = 32) -> torch.Tensor:
    """`num` draws per ray of draw group `stream`, (N, num) float32: the
    Threefry uniforms, or the Owen-scrambled Sobol ones."""
    with trace.span("ct.rng.draws"):
        if sampler == "uniform":
            key = streams.key
            if key.device.type == "cuda":
                u = draws.stream_uniforms(key.reshape(-1, 2).contiguous(), stream, num)
                return u.reshape(*key.shape[:-1], num)
            return ray_uniforms(key, stream, num)
        if sampler == "sobol":
            from .sampling import sobol_uniforms

            return sobol_uniforms(streams.pixel_seed, streams.sample_idx, stream, num,
                                  index_bits)
    raise ValueError(f"unknown sampler '{sampler}' (expected uniform|sobol)")


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
