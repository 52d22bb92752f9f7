#!/usr/bin/env python3
"""Where the time of the port's main path goes, on one CUDA device.

    python3 profile_render.py [--scene sdf-gallery] [--integrator nee] [--sampler sobol]

Renders `RenderSession(scene, RenderOptions(...))` (the Cornell box unless
--scene names another builtin; 512x512, 256 spp, max_depth 64, the CUDA
kernel; path/uniform unless the flags say otherwise) and prints, with the
card's name and power limit:

  - what warm_kernels() took (the libraries' and kernels' load, the first
    zero fill), called before anything else, and the first render after it;
  - the render's wall time with the PNG written and without it, five runs
    each after a warm-up, sorted, and their medians;
  - one render under torch.profiler: the busiest device operations, the
    device's busy time and its idle share of the wall time;
  - the kernel's time per 32-spp launch by CUDA events (20 launches);
  - the kernel's time per launch against max_depth (10 launches each).

Imports no JAX. The section "Where the time goes" of PERF.md reads these
lines.
"""

from __future__ import annotations

import argparse
import itertools
import os
import statistics
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))


def walls(session, runs=5):
    import torch

    out = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        session.render()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return sorted(out)


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--scene", default="cornell", help="a builtin scene (default cornell)")
    parser.add_argument("--integrator", choices=("path", "nee"), default="path")
    parser.add_argument("--sampler", choices=("uniform", "sobol"), default="uniform")
    args = parser.parse_args()

    if not torch.cuda.is_available():
        print("profile_render: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from cornelis_tpu_torch import BUILTIN_SCENES, RenderOptions, RenderSession
    from cornelis_tpu_torch.ops import megakernel
    from cornelis_tpu_torch.ops.warm import warm_kernels
    from cornelis_tpu_torch.rng import key_row
    from cornelis_tpu_torch.utils.timing import card_line, event_ms

    print(card_line())

    print(f"scene {args.scene}, integrator {args.integrator}, sampler {args.sampler}")
    if args.scene not in BUILTIN_SCENES:
        parser.error(f"--scene must be one of {sorted(BUILTIN_SCENES)}")
    scene = BUILTIN_SCENES[args.scene]
    warmed = warm_kernels()
    print(f"warm_kernels(): load {warmed['load_s'] * 1e3:.3f} ms, first zero fill "
          f"{warmed['first_launch_s'] * 1e3:.3f} ms")
    variant = dict(integrator=args.integrator, sampler=args.sampler)
    with tempfile.TemporaryDirectory() as tmp:
        with_png = RenderSession(scene(), RenderOptions(output=os.path.join(tmp, "p.png"), **variant))
        no_png = RenderSession(scene(), RenderOptions(output=None, **variant))
        t0 = time.perf_counter()
        with_png.render()
        torch.cuda.synchronize()
        print(f"first render after warm_kernels(), PNG written: "
              f"{(time.perf_counter() - t0) * 1e3:.2f} ms")
        for name, session in (("PNG written", with_png), ("no PNG", no_png)):
            w = walls(session)
            print(f"render wall, {name}: median {statistics.median(w) * 1e3:.2f} ms, "
                  f"runs {[round(x * 1e3, 2) for x in w]} ms")

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            with_png.render()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    averages = prof.key_averages()
    print(averages.table(sort_by="self_device_time_total", row_limit=8))
    # Device-side events only: a CPU op's self device time repeats its kernels'.
    busy_us = sum(
        e.self_device_time_total for e in averages
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation
    )
    print(f"profiled render, PNG written: wall {wall * 1e3:.2f} ms, device busy "
          f"{busy_us / 1e3:.2f} ms, idle share {1 - busy_us / 1e3 / (wall * 1e3):.3f}")

    tables = with_png.tables
    k0, k1, root = key_row(with_png.options.seed)
    kw = dict(root=root, sampler=args.sampler, mode=args.integrator, lights=with_png.lights,
              index_bits=megakernel.index_bits_for(with_png.options.samples_aa))

    def launch(offset, depth):
        return megakernel.render_rays(tables, k0, k1, 512, 512, 32, offset, depth, **kw)

    offsets = itertools.cycle(range(0, 256, 32))
    ms = event_ms(lambda: launch(next(offsets), 64), 20)
    print(f"kernel per 32-spp launch at 512x512 (events, 20 launches): {ms:.3f} ms")
    for depth in (1, 2, 4, 8, 16, 64):
        ms = event_ms(lambda: launch(0, depth), 10)
        print(f"kernel per launch at max_depth {depth} (events, 10 launches): {ms:.3f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
