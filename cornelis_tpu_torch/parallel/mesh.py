"""The (tiles, samples) mesh of ranks, and multi-process bring-up.

Counterpart of `cornelis_tpu/parallel/mesh.py`. The reference's only
parallelism is TBB work-stealing over 32x32 image tiles inside one process
(src/Render.cpp:327-354). The JAX package lays a `jax.sharding.Mesh` with
two logical axes over its devices; the torch idiom is one process (rank)
per device, so here the mesh is this rank's place in a (tiles, samples)
grid of ranks and the two families of process groups along its axes:

  * `tiles`   -- shards the pixel axis (the reference's tile decomposition,
                 Tiles.cpp:5-29, as a sharding spec); the tiles group
                 all-gathers the frame;
  * `samples` -- shards the chunk's samples per pixel; the samples group
                 all-reduces the per-pixel partial sums.

Rank r sits at tile r // S and sample slice r % S of a (T, S) mesh.
Because the draws are keyed by (pixel, sample), the image does not depend
on the mesh shape.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from datetime import timedelta
from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist

TILE_AXIS = "tiles"
SAMPLE_AXIS = "samples"

# How long a rank waits for the others at the rendezvous and in a
# collective before it raises.
TIMEOUT = timedelta(minutes=5)


@dataclass(frozen=True)
class Mesh:
    """This rank's place in a (tiles, samples) grid of ranks.

    `tiles_group` joins the ranks of this rank's sample slice (one per
    tile), `samples_group` the ranks of its tile (one per sample slice).
    Both are None in a process without a process group, which holds only
    the (1, 1) mesh."""

    shape: tuple
    tile_index: int = 0
    sample_index: int = 0
    tiles_group: Any = None
    samples_group: Any = None

    @property
    def n_tiles(self) -> int:
        return self.shape[0]

    @property
    def n_samples(self) -> int:
        return self.shape[1]


def make_mesh(shape: Optional[Sequence[int]] = None) -> Mesh:
    """This rank's (tiles, samples) mesh over the world's ranks.

    With no `shape`, every rank goes to the tiles axis -- pure image-space
    data parallelism, with no collective but the final gather. The shape
    must cover the world: prod(shape) == world size. The one exception is
    (1, 1) in a process without a process group, a plain single-process
    render. Every rank of the world must call this with the same shape, in
    the same order as its other group creations."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if shape is None:
        shape = (world, 1)
    shape = tuple(int(x) for x in shape)
    if len(shape) != 2 or any(x <= 0 for x in shape):
        raise ValueError(f"mesh shape must be (tiles, samples) > 0, not {shape}")
    if not dist.is_initialized():
        if shape != (1, 1):
            raise ValueError(
                f"mesh shape {shape} needs {math.prod(shape)} ranks, and no process group "
                "is initialized (parallel.initialize_distributed)"
            )
        return Mesh(shape)
    if math.prod(shape) != world:
        raise ValueError(f"mesh shape {shape} does not cover the {world} ranks of the world")
    n_tiles, n_samples = shape
    rank = dist.get_rank()
    tiles_group = samples_group = None
    # new_group is collective over the world: every rank creates every group.
    for s in range(n_samples):
        group = dist.new_group([t * n_samples + s for t in range(n_tiles)], timeout=TIMEOUT)
        if s == rank % n_samples:
            tiles_group = group
    for t in range(n_tiles):
        group = dist.new_group([t * n_samples + s for s in range(n_samples)], timeout=TIMEOUT)
        if t == rank // n_samples:
            samples_group = group
    return Mesh(shape, rank // n_samples, rank % n_samples, tiles_group, samples_group)


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device: str = "cuda",
) -> None:
    """Multi-process bring-up: `torch.distributed.init_process_group` over
    TCP at `coordinator_address` (HOST:PORT, served by rank 0), with early,
    loud failure. A no-op without an address.

    backend None means "nccl" for a CUDA `device` and "gloo" for the CPU.
    Ranks that share one card must name "gloo": NCCL refuses two ranks on
    one GPU. On CUDA, rank r's current device becomes
    cuda:(r % device count), before the process group is made."""
    if coordinator_address is None:
        return
    if num_processes is None or process_id is None:
        raise ValueError("a coordinator needs num_processes and process_id")
    on_cuda = torch.device(device).type == "cuda"
    if backend is None:
        backend = "nccl" if on_cuda else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo' (not {backend!r})")
    if on_cuda:
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    try:
        dist.init_process_group(
            backend=backend,
            init_method=f"tcp://{coordinator_address}",
            world_size=num_processes,
            rank=process_id,
            timeout=TIMEOUT,
        )
    except (RuntimeError, ValueError) as exc:
        raise RuntimeError(
            f"torch.distributed.init_process_group ({backend}) failed -- check the "
            f"coordinator address {coordinator_address} and that all {num_processes} "
            f"processes are launched: {exc}"
        ) from exc
