"""Command line: render a scene with the port.

    python -m cornelis_tpu_torch                     # Cornell box, 512x512, 256 spp, CUDA kernel
    python -m cornelis_tpu_torch --scene sphere-plane --spp 64 -o out.png
    python -m cornelis_tpu_torch --integrator nee --sampler sobol
    python -m cornelis_tpu_torch --device cpu --width 64 --height 64   # the plain version
    python -m cornelis_tpu_torch --checkpoint film.npz --time-budget 60   # resumable, time-boxed
    python -m cornelis_tpu_torch --list-scenes
    python -m cornelis_tpu_torch --dump-scene cornell > my_scene.json
    # one rank of a 2x2 mesh (run once per --process-id 0..3):
    python -m cornelis_tpu_torch --mesh 2x2 --coordinator localhost:29500 \
        --num-processes 4 --process-id 0

Counterpart of `cornelis_tpu/cli.py`. Its TPU scheduling flags
(`--backend`, `--warmup-threshold`, `--warm-device-max-age`,
`--save-schedule`, `--replay-schedule`) have no counterpart; `--device`
and `--dist-backend` are the port's own. Exit code 0 when the render is
done, 1 otherwise.
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
    p.add_argument(
        "--spp-chunk",
        type=int,
        default=d.spp_chunk,
        help="Samples per kernel launch (progress/abort/checkpoint grain); 0 = auto "
        "(about 8M rays per launch on CUDA, 2M on the CPU).",
    )
    p.add_argument("-o", "--output", default=d.output, help="Output PNG path.")
    p.add_argument(
        "--checkpoint",
        default=None,
        help="Checkpoint file: saved after every chunk, resumed from if it exists "
        "(the JAX package's format: either package resumes the other's).",
    )
    p.add_argument(
        "--time-budget",
        type=float,
        default=d.time_budget_s,
        metavar="SECONDS",
        help="Progressive mode: stop after this many seconds (the reference's planned "
        "'sample for x seconds', README Milestone 4); the image uses the samples "
        "actually taken. 0 = render all --spp.",
    )
    p.add_argument(
        "--standard-srgb",
        action="store_true",
        help="Use the standard sRGB 12.92 linear slope instead of the reference's "
        "12.95 quirk (src/Color.cpp:47,68).",
    )
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
    p.add_argument(
        "--profile-dir",
        default=None,
        metavar="DIR",
        help="Write a torch.profiler trace of the session (its set-up and render) to DIR "
        "as a Chrome trace (view with Perfetto or TensorBoard), with the program's ct.* "
        "spans on.",
    )
    p.add_argument("--list-scenes", action="store_true", help="List builtin scenes and exit.")
    p.add_argument(
        "--dump-scene",
        metavar="NAME",
        default=None,
        help="Print a builtin scene as JSON (a starting point for custom scene files) "
        "and exit.",
    )
    p.add_argument("-q", "--quiet", action="store_true", help="Suppress progress logging.")
    return p


def load_scene(spec: str) -> SceneDescription:
    if spec in BUILTIN_SCENES:
        return BUILTIN_SCENES[spec]()
    if os.path.exists(spec):
        return SceneDescription.load(spec)
    raise SystemExit(
        f"error: unknown scene '{spec}' (not a builtin -- "
        f"{', '.join(sorted(BUILTIN_SCENES))} -- and no such file)"
    )


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
    if args.list_scenes:
        for name in sorted(BUILTIN_SCENES):
            print(name)
        return 0
    if args.dump_scene is not None:
        if args.dump_scene not in BUILTIN_SCENES:
            raise SystemExit(f"error: unknown builtin scene '{args.dump_scene}'")
        print(BUILTIN_SCENES[args.dump_scene]().to_json())
        return 0
    if args.quiet:
        from .utils.logging import logger

        logger.setLevel("WARNING")
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
        spp_chunk=args.spp_chunk,
        output=args.output,
        standard_srgb=args.standard_srgb,
        checkpoint=args.checkpoint,
        sampler=args.sampler,
        integrator=args.integrator,
        nee_clamp=args.nee_clamp,
        device=args.device,
        mesh_shape=mesh_shape,
        tile_size=args.tile_size,
        time_budget_s=args.time_budget,
    )
    scene = load_scene(args.scene)
    if args.profile_dir:
        result = _profiled(lambda: RenderSession(scene, options).render(), options.device,
                           args.profile_dir)
    else:
        result = RenderSession(scene, options).render()
    return 0 if result.status == RenderStatus.DONE else 1


def _profiled(render, device, profile_dir: str):
    """render() (the session's construction and its render) under
    torch.profiler with the program's spans on (utils/trace.py), its trace
    written into `profile_dir` as a Chrome trace (one file per process)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    from .utils import trace

    on_cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_cuda else [])
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(profile_dir)):
        with trace.collect():
            result = render()
        if on_cuda:
            torch.cuda.synchronize()
    return result


if __name__ == "__main__":
    sys.exit(main())
