"""Render session: chunks of samples through the megakernel into a film.

Counterpart of `cornelis_tpu/render.py:289-` for what the port runs so far.
The frame is rendered in chunks of `spp_chunk` samples per pixel, one
kernel launch each; chunk sums accumulate on the device and reach the
host film once, at the end, so launches queue back to back on the
stream. Every chunk gets the sampler, the integrator mode, the NEE clamp
and spp_total = samples_aa (render.py:383-416 of the JAX package); in
mode "nee" the light table is built once, on the host, before the first
chunk. Progress callbacks, abort, checkpoints and the time budget come
in later work. The TPU-only scheduling machinery (warmth stamps, the
XLA -> Pallas switchover, schedule replay, host-scene memo, completion
probes) has no job on CUDA and is not carried over.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import Optional

import numpy as np

from .film import Film
from .ops.lights import light_table
from .ops.megakernel import render_chunk
from .options import RenderOptions
from .rng import key_row
from .scene.compile import compile_scene
from .scene.description import SceneDescription


class RenderStatus(Enum):
    # Abort and failure states come with the progress callback.
    DONE = "done"


@dataclass
class RenderResult:
    image: np.ndarray  # linear RGB (H, W, 3)
    film: Film
    status: RenderStatus
    chunks: int = 0  # kernel launches (or plain-version chunks) made


class RenderSession:
    """Compile once, render in chunks (Render.hpp:16-49)."""

    def __init__(self, scene: SceneDescription, options: Optional[RenderOptions] = None):
        self.options = options or RenderOptions()
        self.options.validate()
        self.scene_description = scene
        self.tables = compile_scene(scene, device=self.options.device)
        # Two Threefry evaluations in small host torch ops: derive them once.
        self.key = key_row(self.options.seed)
        self.lights = None
        if self.options.integrator == "nee":
            self.lights = light_table(self.tables, self.options.nee_clamp)

    def render(self) -> RenderResult:
        opts = self.options
        spp_chunk = opts.resolved_spp_chunk()
        accum = None
        starts = range(0, opts.samples_aa, spp_chunk)
        for offset in starts:
            chunk = render_chunk(
                self.tables,
                self.key,
                offset,
                width=opts.width,
                height=opts.height,
                spp_chunk=min(spp_chunk, opts.samples_aa - offset),
                spp_total=opts.samples_aa,
                max_depth=opts.max_depth,
                sampler=opts.sampler,
                mode=opts.integrator,
                nee_clamp=opts.nee_clamp,
                lights=self.lights,
            )
            accum = chunk if accum is None else accum + chunk

        film = Film(opts.width, opts.height)
        film.add_samples(accum, opts.samples_aa)
        if opts.output:
            film.save_png(opts.output)
        return RenderResult(
            image=film.image(), film=film, status=RenderStatus.DONE, chunks=len(starts)
        )
