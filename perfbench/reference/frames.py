"""The reference's side of a frame: any pixels' radiance means over a
frame's samples, traced by the megakernel's plain version, and the 8-bit
sRGB encode that a PNG holds."""

from __future__ import annotations

import numpy as np
import torch

from .color import quantize_to_8bit, srgb_encode
from .compile import SceneTables
from .lights import Lights
from .megakernel import index_bits_for, render_rays_reference
from .rng import key_row


def pixel_means(tables: SceneTables, lights: Lights, seed: int, pixels: torch.Tensor, *,
                width: int, height: int, spp: int, max_depth: int, integrator: str,
                sampler: str, block_rays: int = 1 << 18) -> torch.Tensor:
    """(len(pixels), 3) float32: each pixel's radiance summed over samples
    0..spp-1 of the frame rendered with `seed`, over spp; traced in blocks
    of about `block_rays` rays on the tables' device."""
    k0, k1, root = key_row(seed)
    device = tables.camera.device
    pixels = pixels.to(device=device, dtype=torch.int64)
    per_block = max(1, block_rays // spp)
    out = []
    for i in range(0, pixels.shape[0], per_block):
        px = pixels[i:i + per_block]
        pixel = px.repeat_interleave(spp)
        sample = torch.arange(spp, dtype=torch.int64, device=device).repeat(px.shape[0])
        rays = render_rays_reference(
            tables, k0, k1, width, height, 0, 0, max_depth, device, root=root, sampler=sampler,
            mode=integrator, index_bits=index_bits_for(spp),
            lights=lights if integrator == "nee" else None, pixel=pixel, sample=sample,
        )
        out.append(rays.view(px.shape[0], spp, 3).sum(dim=1) / spp)
    return torch.cat(out)


def srgb8(image: np.ndarray, standard: bool = False) -> np.ndarray:
    """(H, W, 3) uint8: linear RGB through the reference's sRGB encode
    (the 12.95 slope unless `standard`) and 8-bit rounding."""
    return quantize_to_8bit(srgb_encode(torch.from_numpy(np.ascontiguousarray(image)),
                                        standard=standard)).numpy()
