"""Owen-scrambled Sobol (0,2) draws on torch tensors.

Counterpart of `cornelis_tpu/sampling.py`, bit for bit: the same base-2
Sobol point (van der Corput in dimension 0, the v ^= v >> 1 recurrence in
dimension 1), the same Laine-Karras-style Owen scramble and index shuffle
(Burley, JCGT 2020), the same per-(pixel, stream, pair, role) keys, and the
same (x >> 8) * 2^-24 mapping to [0, 1). The CUDA kernel
(ops/csrc/megakernel.cu) computes these in native uint32_t.

uint32 words are held in int64 tensors in [0, 2^32), as in ops/threefry.py.
The hashes multiply two 32-bit words, whose product can exceed int64. So
`_mul32` splits the multiplier into 16-bit halves: each partial product is
below 2^48, and the low 32 bits of the sum are the exact uint32 product.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

Word = Union[int, torch.Tensor]  # a uint32 value, held in int64

_MASK = 0xFFFFFFFF


def _mul32(x: torch.Tensor, m: Word) -> torch.Tensor:
    """x * m modulo 2^32, for words x and m in [0, 2^32)."""
    lo = x * (m & 0xFFFF)
    hi = ((x * ((m >> 16) & 0xFFFF)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def reverse_bits32(x: torch.Tensor) -> torch.Tensor:
    """Bit-reverse each uint32 word."""
    x = ((x >> 1) & 0x55555555) | ((x & 0x55555555) << 1)
    x = ((x >> 2) & 0x33333333) | ((x & 0x33333333) << 2)
    x = ((x >> 4) & 0x0F0F0F0F) | ((x & 0x0F0F0F0F) << 4)
    x = ((x >> 8) & 0x00FF00FF) | ((x & 0x00FF00FF) << 8)
    return ((x >> 16) | (x << 16)) & _MASK


def hash32(x: torch.Tensor) -> torch.Tensor:
    """Low-bias integer hash (xmur3-style avalanche) for scramble keys."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _laine_karras(x: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """Burley's Laine-Karras hash: bit j of the output depends only on bits
    <= j of the input."""
    x = x ^ _mul32(x, 0x3D20ADEA)
    x = (x + seed) & _MASK
    x = _mul32(x, (seed >> 16) | 1)
    x = x ^ _mul32(x, 0x05526C56)
    return x ^ _mul32(x, 0x53A22864)


def owen_scramble(x: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """Owen-scramble uint32 sample bits with a per-lane seed."""
    return reverse_bits32(_laine_karras(reverse_bits32(x), seed))


def shuffle_index(index: torch.Tensor, bits: int, seed: torch.Tensor) -> torch.Tensor:
    """A seeded bijection of [0, 2^bits): the index in the top bits,
    Owen-scrambled, shifted back."""
    shift = 32 - max(1, min(32, bits))
    return owen_scramble((index << shift) & _MASK, seed) >> shift


def sobol2d_bits(index: torch.Tensor, bits: int = 32) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unscrambled (0,2) Sobol point as uint32 bit patterns. Only the low
    `bits` index bits can be set, so the recurrence stops there."""
    d0 = reverse_bits32(index)
    d1 = torch.zeros_like(index)
    v = 0x80000000
    idx = index
    for _ in range(max(1, min(32, bits))):
        d1 = torch.where((idx & 1) != 0, d1 ^ v, d1)
        v ^= v >> 1
        idx = idx >> 1
    return d0, d1


def bits_to_unit_float(x: torch.Tensor) -> torch.Tensor:
    """uint32 -> float32 in [0, 1): (x >> 8) * 2^-24."""
    return (x >> 8).to(torch.float32) * (1.0 / (1 << 24))


def sobol_pair(
    pixel_seed: torch.Tensor, sample_idx: torch.Tensor, stream: Word, pair: int,
    index_bits: int = 32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One Owen-scrambled (0,2) draw pair of (pixel seed, sample, stream,
    pair). Pair p of stream s is keyed by s * 8 + 4p + role, so pairs 2
    and 3 of stream s share their keys with pairs 0 and 1 of stream s + 1,
    as in the JAX package."""

    def group_key(role: int) -> torch.Tensor:
        g = torch.as_tensor((stream * 8 + 4 * pair + role) & _MASK, dtype=torch.int64)
        return hash32(pixel_seed ^ hash32(g.to(pixel_seed.device)))

    idx = shuffle_index(sample_idx, index_bits, group_key(0))
    d0, d1 = sobol2d_bits(idx, index_bits)
    return (
        bits_to_unit_float(owen_scramble(d0, group_key(1))),
        bits_to_unit_float(owen_scramble(d1, group_key(2))),
    )


def sobol_uniforms(
    pixel_seed: torch.Tensor, sample_idx: torch.Tensor, stream: Word, num: int,
    index_bits: int = 32,
) -> torch.Tensor:
    """`num` Owen-scrambled Sobol draws per lane, (N, num) float32: pairs
    0, 1, ... of `sobol_pair`, the last one cut to `num`."""
    cols = []
    for pair in range((num + 1) // 2):
        cols.extend(sobol_pair(pixel_seed, sample_idx, stream, pair, index_bits))
    return torch.stack(cols[:num], dim=-1)
