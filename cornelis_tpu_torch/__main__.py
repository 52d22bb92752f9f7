"""Command line: render a scene with the port.

    python -m cornelis_tpu_torch                     # Cornell box, 512x512, 256 spp, CUDA kernel
    python -m cornelis_tpu_torch --scene sphere-plane --spp 64 -o out.png
    python -m cornelis_tpu_torch --integrator nee --sampler sobol
    python -m cornelis_tpu_torch --device cpu --width 64 --height 64   # the plain version

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
    return p


def load_scene(spec: str) -> SceneDescription:
    if spec in BUILTIN_SCENES:
        return BUILTIN_SCENES[spec]()
    if os.path.exists(spec):
        return SceneDescription.load(spec)
    raise SystemExit(f"error: unknown scene '{spec}' (not a builtin and no such file)")


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
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
    )
    result = RenderSession(load_scene(args.scene), options).render()
    return 0 if result.status == RenderStatus.DONE else 1


if __name__ == "__main__":
    sys.exit(main())
