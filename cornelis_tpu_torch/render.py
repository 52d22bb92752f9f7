"""Render session: chunks of samples through the megakernel into a film.

Counterpart of `cornelis_tpu/render.py:289-` for what the port runs so far.
The frame is rendered in chunks of `spp_chunk` samples per pixel, one
kernel launch each; chunk sums accumulate on the device and reach the
host film once, at the end, so launches queue back to back on the
stream. Every chunk gets the sampler, the integrator mode, the NEE clamp
and spp_total = samples_aa (render.py:383-416 of the JAX package); in
mode "nee" the light table is built once, on the host, before the first
chunk. With `mesh_shape` every rank of the process group runs the session:
each chunk is rendered by `parallel.render_chunk_mesh_megakernel` on the
rank's shard (the kernel on CUDA tables, its plain version on CPU ones, as
without a mesh), every rank accumulates the whole frame, and rank 0 writes
the PNG (render.py:352-406 and :684-685 of the JAX package). Progress
callbacks, abort, checkpoints and the time budget come in later work;
under a mesh they need the ranks to agree (render.py:316-322). The
TPU-only scheduling machinery (warmth stamps, the XLA -> Pallas
switchover, schedule replay, host-scene memo, completion probes) has no
job on CUDA and is not carried over.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import Optional

import numpy as np
import torch.distributed as dist

from .film import Film
from .ops.lights import light_table
from .ops.megakernel import render_chunk
from .options import RenderOptions
from .parallel import make_mesh, render_chunk_mesh_megakernel
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
    chunks: int = 0  # this rank's kernel launches (or plain-version chunks)


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
        # Collective: every rank makes the mesh's process groups.
        self.mesh = None
        if self.options.mesh_shape is not None:
            self.mesh = make_mesh(self.options.mesh_shape)

    def render(self) -> RenderResult:
        opts = self.options
        spp_chunk = opts.resolved_spp_chunk()
        mesh = self.mesh
        if mesh is not None and mesh.n_samples > 1:
            # Every chunk must split evenly over the samples axis.
            spp_chunk = max(mesh.n_samples, spp_chunk - spp_chunk % mesh.n_samples)
            if opts.samples_aa % mesh.n_samples != 0:
                raise ValueError(
                    f"samples_aa ({opts.samples_aa}) must be divisible by the samples "
                    f"mesh axis ({mesh.n_samples})"
                )
        accum = None
        starts = range(0, opts.samples_aa, spp_chunk)
        for offset in starts:
            common = dict(
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
            if mesh is None:
                chunk = render_chunk(self.tables, self.key, offset, **common)
            else:
                chunk = render_chunk_mesh_megakernel(
                    self.tables, self.key, offset, mesh=mesh, tile_size=opts.tile_size, **common
                )
            accum = chunk if accum is None else accum + chunk

        film = Film(opts.width, opts.height)
        film.add_samples(accum, opts.samples_aa)
        if opts.output and (not dist.is_initialized() or dist.get_rank() == 0):
            film.save_png(opts.output)
        return RenderResult(
            image=film.image(), film=film, status=RenderStatus.DONE, chunks=len(starts)
        )
