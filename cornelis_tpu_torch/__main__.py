"""Command line: render a scene with the port.

    python -m cornelis_tpu_torch                     # Cornell box, 512x512, 256 spp, CUDA kernel
    python -m cornelis_tpu_torch --scene sphere-plane --spp 64 -o out.png
    python -m cornelis_tpu_torch --integrator nee --sampler sobol
    python -m cornelis_tpu_torch --device cpu --width 64 --height 64   # the plain version
    # one rank of a 2x2 mesh (run once per --process-id 0..3):
    python -m cornelis_tpu_torch --mesh 2x2 --coordinator localhost:29500 \
        --num-processes 4 --process-id 0

A small subset of `cornelis_tpu/cli.py`; its other flags come later.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

from .options import RenderOptions
from .scene.description import SceneDescription
from .scene.library import BUILTIN_SCENES


def build_parser() -> argparse.ArgumentParser:
    d = RenderOptions()
    p = argparse.ArgumentParser(
        prog="cornelis_tpu_torch", description="Monte Carlo path tracer on PyTorch and CUDA."
    )
    p.add_argument(
        "--scene",
        default="cornell",
        help=f"Builtin scene ({', '.join(sorted(BUILTIN_SCENES))}) or a scene JSON file.",
    )
    p.add_argument("--width", type=int, default=d.width)
    p.add_argument("--height", type=int, default=d.height)
    p.add_argument("--spp", type=int, default=d.samples_aa, help="Samples per pixel.")
    p.add_argument("--max-depth", type=int, default=d.max_depth)
    p.add_argument("--seed", type=int, default=d.seed)
    p.add_argument("-o", "--output", default=d.output, help="Output PNG path.")
    p.add_argument(
        "--integrator",
        choices=("path", "nee"),
        default=d.integrator,
        help="'path' replicates the reference; 'nee' adds MIS-weighted light sampling.",
    )
    p.add_argument("--sampler", choices=("uniform", "sobol"), default=d.sampler)
    p.add_argument(
        "--nee-clamp",
        type=float,
        default=d.nee_clamp,
        metavar="RADIANCE",
        help="NEE per-bounce clamp base ('inf' disables; default 16 x brightest emission).",
    )
    p.add_argument(
        "--device",
        default=d.device,
        help="torch device: cuda runs the kernel, cpu its plain version.",
    )
    p.add_argument(
        "--mesh",
        default=None,
        metavar="TxS",
        help="Mesh of ranks: T shards the pixels (tiles), S the samples, e.g. 4x2; "
        "T*S ranks, each started with the same flags but --process-id.",
    )
    p.add_argument(
        "--tile-size",
        type=int,
        default=d.tile_size,
        help="Image-tile edge for mesh pixel sharding (reference grain 32x32, "
        "src/Render.cpp:327); 0 = flat row-band split. Only with --mesh.",
    )
    p.add_argument(
        "--coordinator",
        default=None,
        metavar="HOST:PORT",
        help="Multi-process bring-up: the address rank 0 serves the "
        "torch.distributed rendezvous on. Launch one process per rank.",
    )
    p.add_argument(
        "--num-processes",
        type=int,
        default=None,
        help="Total number of processes (ranks) in the job (with --coordinator).",
    )
    p.add_argument(
        "--process-id",
        type=int,
        default=None,
        help="This process's rank in the job (with --coordinator).",
    )
    p.add_argument(
        "--dist-backend",
        choices=("nccl", "gloo"),
        default=None,
        help="Collective backend (default: nccl on CUDA, gloo on the CPU); ranks "
        "that share one GPU need gloo.",
    )
    return p


def load_scene(spec: str) -> SceneDescription:
    if spec in BUILTIN_SCENES:
        return BUILTIN_SCENES[spec]()
    if os.path.exists(spec):
        return SceneDescription.load(spec)
    raise SystemExit(f"error: unknown scene '{spec}' (not a builtin and no such file)")


def parse_mesh(spec: Optional[str]) -> Optional[tuple]:
    if spec is None:
        return None
    try:
        parts = tuple(int(x) for x in spec.lower().split("x"))
    except ValueError:
        raise SystemExit(f"error: bad --mesh '{spec}' (expected e.g. 4x2)")
    if len(parts) == 1:
        parts = (parts[0], 1)
    if len(parts) != 2 or any(x <= 0 for x in parts):
        raise SystemExit(f"error: bad --mesh '{spec}' (expected e.g. 4x2)")
    return parts


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    mesh_shape = parse_mesh(args.mesh)
    if args.coordinator is None:
        return _render(args, mesh_shape)
    import torch.distributed as dist

    from .parallel import initialize_distributed

    # Bring-up precedes any device query; it fails loudly on a bad
    # coordinator rather than hanging in the first collective.
    initialize_distributed(
        coordinator_address=args.coordinator,
        num_processes=args.num_processes,
        process_id=args.process_id,
        backend=args.dist_backend,
        device=args.device,
    )
    try:
        return _render(args, mesh_shape)
    finally:
        dist.destroy_process_group()


def _render(args, mesh_shape) -> int:
    from .render import RenderSession, RenderStatus

    options = RenderOptions(
        samples_aa=args.spp,
        width=args.width,
        height=args.height,
        max_depth=args.max_depth,
        seed=args.seed,
        output=args.output,
        sampler=args.sampler,
        integrator=args.integrator,
        nee_clamp=args.nee_clamp,
        device=args.device,
        mesh_shape=mesh_shape,
        tile_size=args.tile_size,
    )
    result = RenderSession(load_scene(args.scene), options).render()
    return 0 if result.status == RenderStatus.DONE else 1


if __name__ == "__main__":
    sys.exit(main())
