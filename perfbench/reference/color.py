"""Color transfer and 8-bit quantization on torch tensors.

Counterpart of `cornelis_tpu/math/color.py`. Quirk kept from the reference:
the sRGB linear-segment slope is 12.95, not the standard 12.92
(src/Color.cpp:47,68); `standard=True` selects 12.92.
"""

from __future__ import annotations

import torch

_SRGB_A = 0.055


def _linear_slope(standard: bool) -> float:
    return 12.92 if standard else 12.95


def srgb_encode(linear: torch.Tensor, standard: bool = False) -> torch.Tensor:
    """Linear -> sRGB gamma correction (src/Color.cpp:64-78)."""
    lo = linear * _linear_slope(standard)
    hi = (1.0 + _SRGB_A) * torch.pow(torch.clamp_min(linear, 0.0), 1.0 / 2.4) - _SRGB_A
    return torch.where(linear <= 0.0031308, lo, hi)


def quantize_to_8bit(v: torch.Tensor) -> torch.Tensor:
    """round(255*v) clamped to [0, 255], uint8 (FrameBuffer.hpp:91-100).
    torch.round rounds half to even, as jnp.round does."""
    return torch.clamp(torch.round(255.0 * v), 0.0, 255.0).to(torch.uint8)
