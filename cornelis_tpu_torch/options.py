"""Render options.

Counterpart of `cornelis_tpu/options.py` for what the port runs so far,
with the reference's defaults (RenderOptions.hpp:6-16, Render.cpp:264,307):
512x512, 256 spp, max_depth 64, the reference seed, the path integrator
and the uniform sampler. New here: `device`. The tables' device decides
what runs: a CUDA device launches the hand-written kernel, the CPU runs
its plain version. The JAX package's TPU scheduling fields (`backend`,
`warmup_threshold_s`, `warm_device_max_age_s`, `backend_schedule`) have
no counterpart: `device` takes their place.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from .rng import DEFAULT_SEED


@dataclass
class RenderOptions:
    samples_aa: int = 256
    width: int = 512
    height: int = 512
    # Bound on the RR-terminated bounce loop: survival after depth 3 is
    # <= 0.55 per bounce, so P(alive at 64) < 1e-16.
    max_depth: int = 64
    seed: int = DEFAULT_SEED
    # Samples per kernel launch; 0 = auto (about 8M rays per launch on a
    # CUDA device, 2M elsewhere).
    spp_chunk: int = 0
    # Output path; None = don't save (reference: "cornelisrender2.png").
    output: Optional[str] = "cornelisrender2.png"
    # Use the standard sRGB 12.92 linear slope instead of the reference's
    # 12.95 quirk (src/Color.cpp:47,68).
    standard_srgb: bool = False
    # Checkpoint file updated after every chunk, and resumed from when it
    # exists (the JAX package's npz keys); None disables.
    checkpoint: Optional[str] = None
    # "uniform" (Threefry) or "sobol" (Owen-scrambled Sobol).
    sampler: str = "uniform"
    # "path" replicates the reference; "nee" is the corrected estimator
    # (MIS-combined light sampling and the true BSDF density).
    integrator: str = "path"
    # NEE firefly clamp base: None = 16 x the brightest emission channel
    # (floored at 1); math.inf disables the clamp. Ignored in path mode.
    nee_clamp: Optional[float] = None
    # Where the render runs: "cuda" (the kernel) or "cpu" (its plain
    # version). There is no automatic choice of the CPU.
    device: str = "cuda"
    # Mesh shape (tiles, samples) over the ranks of the process group
    # (parallel.initialize_distributed); None = one process. The
    # replacement for the reference's TBB tile pool (Render.cpp:335-354):
    # pixels shard over tiles, spp over samples.
    mesh_shape: Optional[tuple] = None
    # Image-tile edge for the mesh's pixel sharding (FrameTiling as a
    # sharding spec; the reference's 32x32 parallel grain, Render.cpp:327).
    # 0 = flat row-band split. Ignored without mesh_shape.
    tile_size: int = 32
    # Progressive mode: stop dispatching new sample chunks once this many
    # seconds have elapsed (the reference's planned "sample for x seconds",
    # README Milestone 4). The image normalizes by the samples actually
    # taken; combine with `checkpoint` to keep refining across runs.
    # 0 = no time budget (render all samples_aa).
    time_budget_s: float = 0.0

    def validate(self) -> None:
        if self.samples_aa <= 0:
            raise ValueError(f"AA Samples must be > 0 (not {self.samples_aa}).")
        if self.width <= 0 or self.height <= 0:
            raise ValueError("Resolution must be positive.")
        if self.max_depth <= 0:
            raise ValueError("max_depth must be positive.")
        if self.spp_chunk < 0:
            raise ValueError("spp_chunk must be >= 0 (0 = auto).")
        if self.tile_size < 0:
            raise ValueError("tile_size must be >= 0 (0 = flat split).")
        if self.time_budget_s < 0:
            raise ValueError("time_budget_s must be >= 0 (0 = unlimited).")
        if self.sampler not in ("uniform", "sobol"):
            raise ValueError(f"sampler must be 'uniform' or 'sobol' (not {self.sampler!r}).")
        if self.integrator not in ("path", "nee"):
            raise ValueError(f"integrator must be 'path' or 'nee' (not {self.integrator!r}).")
        if self.nee_clamp is not None and not self.nee_clamp > 0:
            raise ValueError(
                f"nee_clamp must be > 0 (math.inf disables clamping; None "
                f"selects the scale-aware default), not {self.nee_clamp}."
            )
        try:
            kind = torch.device(self.device).type
        except (RuntimeError, ValueError):
            kind = None
        if kind not in ("cuda", "cpu"):
            raise ValueError(f"device must be a CUDA device or 'cpu' (not {self.device!r}).")

    def resolved_spp_chunk(self) -> int:
        if self.spp_chunk > 0:
            return min(self.spp_chunk, self.samples_aa)
        on_cuda = torch.device(self.device).type == "cuda"
        target_rays = (8 if on_cuda else 2) * 1024 * 1024
        chunk = max(1, target_rays // (self.width * self.height))
        return min(chunk, self.samples_aa)
