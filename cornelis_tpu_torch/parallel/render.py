"""Mesh-sharded render: the TBB tile loop (src/Render.cpp:335-354) over a
(tiles, samples) mesh of ranks.

Counterpart of `cornelis_tpu/parallel/render.py`, where a `shard_map` runs
the render on each device. Here each rank runs it on its own shard, and
`torch.distributed` collectives stand in for shard_map's:

  * one TBB tile task          -> a run of whole tiles of the tile-major
                                  pixel order on one rank;
  * dynamic work stealing      -> a static equal split;
  * the samples-axis `psum`    -> an all-reduce over the samples group,
                                  only when the samples axis is sharded;
  * out_specs P('tiles')       -> an all-gather over the tiles group, so
                                  every rank holds the whole frame.

`render_chunk_mesh` runs the torch wavefront (integrator.py) on the shard;
`render_chunk_mesh_megakernel`, the port of `render_chunk_mesh_pallas`,
launches the CUDA megakernel on the shard through its pixel-id operand.
Draws depend only on (pixel, sample), so the frame equals a single-process
render: bit for bit with a tiles-only mesh, up to the order of the float
sum over the samples axis otherwise.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..integrator import integrate_pixel_samples
from ..math.tiles import tile_major_order
from ..ops import lights as L
from ..ops.megakernel import index_bits_for, render_rays
from .mesh import Mesh


def _check_divisible(value: int, by: int, what: str) -> None:
    if value % by != 0:
        raise ValueError(f"{what} ({value}) must be divisible by the mesh axis size {by}")


@functools.lru_cache(maxsize=32)
def _pixel_order(width: int, height: int, tile_size: int) -> np.ndarray:
    """The frame's pixel ids in the order the tiles axis splits them:
    tile-major, or row-major when tile_size is 0."""
    if tile_size > 0:
        return tile_major_order(width, height, tile_size, tile_size).astype(np.int64)
    return np.arange(width * height, dtype=np.int64)


@functools.lru_cache(maxsize=32)
def _shard_pixels(width: int, height: int, tile_size: int, n_tiles: int, tile_index: int,
                  device: torch.device) -> torch.Tensor:
    """Tile `tile_index`'s pixel ids, int32 on `device`: the mesh render's
    `px` operand, built once per frame, tiling and mesh (the JAX package
    bakes it in at trace time)."""
    order = _pixel_order(width, height, tile_size)
    n = order.shape[0] // n_tiles
    ids = order[tile_index * n:(tile_index + 1) * n].astype(np.int32)
    return torch.from_numpy(ids).to(device)


@functools.lru_cache(maxsize=32)
def _unpermute(width: int, height: int, tile_size: int, device: torch.device) -> torch.Tensor:
    """Row k of the gathered frame is pixel order[k]'s; taking rows
    argsort(order) puts them back in row-major order."""
    return torch.from_numpy(np.argsort(_pixel_order(width, height, tile_size))).to(device)


class Shard(NamedTuple):
    """One rank's share of a chunk: its pixels (int32 frame ids) and the
    contiguous samples [sample_start, sample_start + spp) of each."""

    pixel_ids: torch.Tensor
    sample_start: int
    spp: int


def shard(mesh: Mesh, width: int, height: int, spp_chunk: int, sample_offset: int,
          tile_size: int, device) -> Shard:
    """This rank's shard of the chunk of `spp_chunk` samples that starts at
    `sample_offset`: tile t of the pixel order (tile-major in tile_size x
    tile_size tiles, row-major with tile_size 0) split in mesh.n_tiles
    equal runs, and sample slice s of the chunk split in mesh.n_samples.
    Raises ValueError when either does not split evenly."""
    _check_divisible(width * height, mesh.n_tiles, "pixel count")
    _check_divisible(spp_chunk, mesh.n_samples, "spp chunk")
    spp = spp_chunk // mesh.n_samples
    ids = _shard_pixels(width, height, tile_size, mesh.n_tiles, mesh.tile_index,
                        torch.device(device))
    return Shard(ids, int(sample_offset) + mesh.sample_index * spp, spp)


def assemble(mesh: Mesh, part: torch.Tensor, *, width: int, height: int,
             tile_size: int) -> torch.Tensor:
    """The (H, W, 3) frame on every rank from this rank's (pixels, 3)
    partial sums: summed over the samples group (only when the samples
    axis is sharded; in place), gathered over the tiles group, and put back
    in row-major order (JAX's psum, out_specs P('tiles') and img[inv])."""
    if mesh.n_samples > 1:
        dist.all_reduce(part, group=mesh.samples_group)
    if mesh.tiles_group is not None:
        shards = [torch.empty_like(part) for _ in range(mesh.n_tiles)]
        dist.all_gather(shards, part, group=mesh.tiles_group)
        part = torch.cat(shards)
    if tile_size > 0:
        part = part.index_select(0, _unpermute(width, height, tile_size, part.device))
    return part.view(height, width, 3)


def render_chunk_mesh(
    scene,
    root_key: torch.Tensor,
    sample_offset: int,
    *,
    mesh: Mesh,
    width: int,
    height: int,
    spp_chunk: int,
    spp_total: int,
    max_depth: int,
    unroll_bounces: bool = False,
    sampler: str = "uniform",
    tile_size: int = 32,
    mode: str = "path",
    nee_clamp=None,
    detach_sampling: bool = False,
) -> torch.Tensor:
    """One chunk of samples over the mesh through the torch wavefront:
    (H, W, 3) radiance sums on every rank, without gradient, equal (up to
    the float order of the samples sum when that axis is sharded) to
    `integrator.render_chunk`. `scene` is a SceneArrays, `root_key` a (2,)
    key (rng.make_key). The differentiable form is diff/sharded.py's."""
    device = scene.device
    sh = shard(mesh, width, height, spp_chunk, sample_offset, tile_size, device)
    sample_idx = sh.sample_start + torch.arange(sh.spp, dtype=torch.int64, device=device)
    with torch.no_grad():
        part = integrate_pixel_samples(
            scene, root_key.to(device), sh.pixel_ids.long(), sample_idx, width=width,
            height=height, spp_total=spp_total, max_depth=max_depth,
            unroll_bounces=unroll_bounces, detach_sampling=detach_sampling, sampler=sampler,
            mode=mode, nee_clamp=nee_clamp,
        )
    return assemble(mesh, part, width=width, height=height, tile_size=tile_size)


def render_chunk_mesh_megakernel(
    tables,
    key: tuple,
    sample_offset: int,
    *,
    mesh: Mesh,
    width: int,
    height: int,
    spp_chunk: int,
    spp_total: int,
    max_depth: int,
    sampler: str = "uniform",
    tile_size: int = 32,
    mode: str = "path",
    nee_clamp: Optional[float] = None,
    lights: Optional[L.Lights] = None,
) -> torch.Tensor:
    """The megakernel over the mesh: the port of
    `cornelis_tpu.parallel.render.render_chunk_mesh_pallas`
    (`_build_mesh_pallas_renderer`). Each rank launches the CUDA kernel
    once on its shard, its pixel ids as the kernel's pixel-id operand and
    its sample slice as the sample offset (the plain version on CPU
    tables), sums each pixel's samples as `ops.megakernel.render_chunk`
    does, and the frame is assembled on every rank: (H, W, 3) radiance
    sums. `key` is the key row (k0, k1, root) of `rng.key_row`; mode "nee"
    builds K1's light table unless `lights` brings one. The persistent
    kernel takes exactly the shard's rays: no padding to whole blocks."""
    k0, k1, root = key
    device = tables.camera.device
    sh = shard(mesh, width, height, spp_chunk, sample_offset, tile_size, device)
    if mode == "nee" and lights is None:
        lights = L.light_table(tables, nee_clamp)
    rays = render_rays(
        tables, k0, k1, width, height, sh.spp, sh.sample_start, max_depth, root=root,
        sampler=sampler, mode=mode, index_bits=index_bits_for(spp_total), lights=lights,
        pixel_ids=sh.pixel_ids,
    )
    part = rays.view(sh.pixel_ids.shape[0], sh.spp, 3).sum(dim=1)
    return assemble(mesh, part, width=width, height=height, tile_size=tile_size)
