"""Threefry-2x32 counter-based RNG on torch tensors.

Counterpart of `cornelis_tpu/ops/threefry.py`: the standard 20-round
Threefry-2x32 (Salmon et al., SC'11) and the megakernel's draw packing,
bit for bit. torch's uint32 lacks shifts on the CPU, so words are held in
int64 tensors and masked to 32 bits after every add and shift; the CUDA
kernel (ops/csrc/megakernel.cu) does the same in native uint32_t.

Every uniform is keyed by (root key, pixel, sample, stream, pair), so
draws do not depend on chunking or evaluation order.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

Word = Union[int, torch.Tensor]  # a uint32 value, held in int64

_MASK = 0xFFFFFFFF
_ROTATIONS = (13, 15, 26, 6, 17, 29, 16, 24)
_PARITY = 0x1BD11BDA  # key-schedule parity constant (Skein/Threefish)

# Draw-id packing: counter word 1 = sample * 256 + stream * 2 + pair.
DRAWS_PER_SAMPLE = 256


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _MASK) | (x >> (32 - r))


def threefry2x32(k0: Word, k1: Word, c0: Word, c1: Word) -> Tuple[torch.Tensor, torch.Tensor]:
    """20-round Threefry-2x32: (key, counter) -> two 32-bit blocks, as
    int64 tensors in [0, 2^32). Inputs are ints or int64 tensors that
    broadcast; at least one counter word must be a tensor."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (c0 + ks[0]) & _MASK
    x1 = (c1 + ks[1]) & _MASK
    for block in range(5):
        rots = _ROTATIONS[0:4] if block % 2 == 0 else _ROTATIONS[4:8]
        for r in rots:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(block + 1) % 3]) & _MASK
        x1 = (x1 + ks[(block + 2) % 3] + (block + 1)) & _MASK
    return x0, x1


def to_unit_float(bits: torch.Tensor) -> torch.Tensor:
    """uint32 -> float32 in [0, 1): (x >> 8) * 2^-24, the reference's
    FloatFromBits quantization (external/XoshiroCpp.hpp:649-654)."""
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def pair_uniforms(
    k0: Word, k1: Word, pixel: torch.Tensor, sample: torch.Tensor, stream: Word, pair: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two uniforms for draw pair `pair` of (pixel, sample, stream).
    Stream 0 is the camera; bounce d draws on stream d + 1."""
    c1 = (sample * DRAWS_PER_SAMPLE + stream * 2 + pair) & _MASK
    b0, b1 = threefry2x32(k0, k1, pixel, c1)
    return to_unit_float(b0), to_unit_float(b1)
