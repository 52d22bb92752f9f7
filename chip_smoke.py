#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one GPU, and check them.

    python3 chip_smoke.py

Needs a CUDA device, nvcc, and the repository around this script; it
imports no JAX. Phases, each printed as it runs; every failed check
raises, so the exit code is not 0 and no result line is printed:

  1. card and tools: the device, its power limit, torch, CUDA, nvcc;
  2. build: every library of ops/csrc/ with nvcc, in parallel, timed, and
     the registers and spills of each kernel instantiation;
  3. kernel against plain: each megakernel instantiation (mode path or
     nee, sampler uniform or sobol) and its plain torch version on the
     same card, ray by ray, at 64x64, 16 spp, max_depth 64, on
     cornell_box, cornell_panel and a mixed sphere + panel scene; the
     dynamic-scene render (K3: the same kernel fed by the light table
     built on the device) on cornell_box and cornell_panel; the table
     kernel against its plain version; doubling every emission doubles
     K3's nee image; and neither that edit nor a moved sphere builds or
     loads a library again;
  4. the slices, each with the launch counts zeroed just before it and
     read just after: RenderSession(cornell_box(), RenderOptions(...))
     at 512x512, 256 spp, max_depth 64 with the PNG written, for the
     default path/uniform (checked region by region against the committed
     16384-spp render of the JAX package, tests/golden/ours_cornell_512.png)
     and for nee/sobol, path/sobol and nee/uniform (region means printed
     only: the nee estimator is not the golden's); the command line at
     128x128 for the default and for --integrator nee --sampler sobol;
     render_chunk_dynamic over the same frame in every mode and sampler;
  5. times: each instantiation and K3 against its plain version for one
     32-spp chunk at 512x512 (spp_total 256; median of 3 after a
     warm-up); the two outputs, and those of the last chunk (offset 224),
     held to the phase-3 bar ray by ray; then the pinned NEE firefly of
     tests/test_nee.py on the kernel, clamp off and on (printed only).

The last lines are a JSON record of the kernels and then
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(REPO, "tests", "golden", "ours_cornell_512.png")
SEED = 19791102

# Phase 3 bar. FMA contraction (mode path) and CUDA's sinf/cosf move ulps
# against the plain version's separate torch ops, and a knife-edge path
# (an RR draw or a closest-hit comparison within an ulp) then goes
# elsewhere: at least 99% of rays within 1e-4 abs + rel, per-channel means
# within 1%.
RAY_TOL = 1e-4
RAY_FRACTION = 0.99
MEAN_REL = 0.01
SMOKE = dict(width=64, height=64, spp=16, max_depth=64)
# Phase 4 bar: 256 spp against 16384 spp, 16x16 regions of 32x32 pixels.
# A region counts when under 0.1% of the golden's pixels clip (the rule of
# tests/test_golden_512.py) and under 1% of the 256-spp render's: at 256
# spp up to 16% of a bright region's pixels saturate the 8-bit PNG, which
# lowers its mean by up to 0.05 whatever the kernel does.
REGION_MAX = 0.03
REGION_BIAS = 0.01
MIN_REGIONS = 64
# Doubling every emission doubles K3's nee image (tests/test_dynamic.py).
DOUBLING_RTOL = 1e-5
# The pinned firefly (tests/test_nee.py::TestFireflyPinned).
FIREFLY_PIXEL, FIREFLY_SAMPLES, FIREFLY_SPP_TOTAL = 77580, (544, 576), 2048

VARIANTS = (("path", "uniform"), ("path", "sobol"), ("nee", "uniform"), ("nee", "sobol"))
CSRC = "cornelis_tpu_torch/ops/csrc/"
K1_TPU = "cornelis_tpu/ops/pallas_integrator.py:616"
K3_TPU = "cornelis_tpu/ops/pallas_dynamic.py:174"
TABLE = "light_table_dyn"


def phase(msg: str) -> None:
    print(f"== {msg}", flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def nvcc_release() -> str:
    from cornelis_tpu_torch.ops.build import _nvcc

    out = subprocess.run([_nvcc(), "--version"], capture_output=True, text=True, check=True).stdout
    return next(line for line in out.splitlines() if "release" in line).strip()


def kernel_name(kind: str, mode: str, sampler: str) -> str:
    return f"{kind} {mode}/{sampler}"


def panel_scene():
    """tests/test_nee.py::_panel_scene(with_sphere_light=True), rebuilt in
    the port: a grey floor lit by a ceiling panel and a sphere light."""
    from cornelis_tpu_torch.scene.description import (
        MaterialDescription,
        PerspectiveCameraDescription,
        PlaneDescription,
        SceneDescription,
        SphereDescription,
    )

    s = SceneDescription()
    s.set_camera(PerspectiveCameraDescription(origin=(0.0, 3.0, -8.0), look_at=(0.0, 0.0, 0.0),
                                              aspect=1.0))
    light = s.add_material(MaterialDescription(albedo=(0, 0, 0), emissive=(40.0,) * 3))
    grey = s.add_material(MaterialDescription(albedo=(0.6, 0.6, 0.6)))
    s.add_plane(PlaneDescription(normal=(0, 1, 0), point=(0, 0, 0), extents=(40, 40, 0),
                                 material=grey))
    s.add_plane(PlaneDescription(normal=(0, -1, 0), point=(0, 6, 0), extents=(2.0, 2.0, 0),
                                 material=light))
    s.add_sphere(SphereDescription(center=(3.0, 4.0, 2.0), radius=0.5, material=light))
    return s


def ptxas_report(logs: dict) -> dict:
    """{kernel name: (registers, stack bytes, spill store + load bytes)}
    from nvcc's -Xptxas=-v output."""
    report, current = {}, None
    for log in logs.values():
        for line in log.splitlines():
            entry = re.search(r"Compiling entry function '([^']+)'", line)
            if entry:
                m = re.search(r"megakernelILb([01])ELb([01])E", entry.group(1))
                current = (kernel_name("megakernel", ("path", "nee")[int(m.group(1))],
                                       ("uniform", "sobol")[int(m.group(2))])
                           if m else TABLE)
                report[current] = [None, None, None]
            frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if frame and current:
                report[current][1] = int(frame.group(1))
                report[current][2] = int(frame.group(2)) + int(frame.group(3))
            regs = re.search(r"Used (\d+) registers", line)
            if regs and current:
                report[current][0] = int(regs.group(1))
    return {k: tuple(v) for k, v in report.items()}


def agreement(a, b):
    import torch

    close = torch.isclose(a, b, rtol=RAY_TOL, atol=RAY_TOL).all(dim=1)
    ma, mb = a.double().mean(0), b.double().mean(0)
    rel = ((ma - mb).abs() / mb.abs().clamp_min(1e-12)).max().item()
    return close.double().mean().item(), (a - b).abs().max().item(), rel


def golden_regions(png_path: str):
    """(max clean-region difference, per-channel mean bias, clean regions)
    of 16x16-grid block means in linear RGB against the committed golden."""
    import numpy as np
    import torch

    from cornelis_tpu_torch.math.color import srgb_decode
    from cornelis_tpu_torch.utils.png import read_png

    def linear(path):
        raw8 = read_png(path)
        return raw8, srgb_decode(torch.from_numpy(raw8.astype(np.float32) / 255.0)).numpy()

    def blocks(img, grid=16):
        h, w, c = img.shape
        return img.reshape(grid, h // grid, grid, w // grid, c).mean(axis=(1, 3))

    def clipped(raw8):
        return (raw8.max(axis=-1) >= 250).reshape(16, 32, 16, 32).mean(axis=(1, 3))

    gold8, gold = linear(GOLDEN)
    ours8, ours = linear(png_path)
    check(ours.shape == gold.shape == (512, 512, 3), f"image shape {ours.shape}")
    clean = (clipped(gold8) < 0.001) & (clipped(ours8) < 0.01)
    diff = np.abs(blocks(ours) - blocks(gold)).max(axis=-1)
    bias = (blocks(ours) - blocks(gold))[clean].mean(axis=0)
    worst = float(diff[clean].max()) if clean.any() else math.nan
    return worst, [float(b) for b in bias], int(clean.sum())


def timed(fn, reps=3):
    """(median seconds of `reps` calls after one warm-up, synchronized;
    the last call's result)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times), out


def hold_to_plain(name, kern, plain):
    """Check one kernel output against its plain version to the phase-3
    bar; print and return (fraction within RAY_TOL, max |diff|)."""
    import torch

    check(bool(torch.isfinite(kern).all()), f"{name}: kernel output not finite")
    check(bool(torch.isfinite(plain).all()), f"{name}: plain output not finite")
    frac, err, rel = agreement(kern, plain)
    print(f"{name}: {frac:.4%} of rays within {RAY_TOL:g}, max |diff| {err:.6g}, "
          f"channel means {rel:.4%} apart")
    check(frac >= RAY_FRACTION, f"{name}: only {frac:.4%} of rays agree")
    check(rel <= MEAN_REL, f"{name}: channel means {rel:.4%} apart")
    return frac, err


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from cornelis_tpu_torch import RenderOptions, RenderSession, RenderStatus
    from cornelis_tpu_torch.__main__ import main as cli_main
    from cornelis_tpu_torch.ops import build, lights, megakernel
    from cornelis_tpu_torch.ops.dynamic import render_chunk_dynamic
    from cornelis_tpu_torch.rng import key_row
    from cornelis_tpu_torch.scene.compile import compile_scene
    from cornelis_tpu_torch.scene.library import cornell_box, cornell_panel
    from cornelis_tpu_torch.utils.png import read_png

    phase("1. card and tools")
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    print(nvcc_release())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase("2. build (one nvcc per source, in parallel)")
    t0 = time.perf_counter()
    built = build.build_all(force=True)
    print(f"built {len(built)} libraries in {time.perf_counter() - t0:.1f} s: "
          + ", ".join(f"{os.path.relpath(so, REPO)} ({s:.1f} s)" for so, s in built.values()))
    ptxas = ptxas_report(build.BUILD_LOGS)
    for name, (regs, stack, spill) in sorted(ptxas.items()):
        print(f"  {name}: {regs} registers, {stack} B stack, {spill} B spilled")
    check(len(ptxas) == 5, f"expected 5 kernel instantiations, ptxas reported {sorted(ptxas)}")

    # Every kernel of the report: {name: dict of the kernels line}.
    records = {}

    def record(name, source, replaces, instantiation):
        records[name] = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "registers": ptxas[instantiation][0],
            "launches": 0, "fracs": [], "errs": [], "ms": None, "plain_ms": None,
        }

    for mode, sampler in VARIANTS:
        src = CSRC + ("megakernel_nee.cu" if mode == "nee" else "megakernel.cu")
        inst = kernel_name("megakernel", mode, sampler)
        record(inst, src, K1_TPU, inst)
        record(kernel_name("dynamic", mode, sampler), src, K3_TPU, inst)
    record(TABLE, CSRC + "lights.cu", K3_TPU, TABLE)

    k0, k1, root = key_row(SEED)
    smoke_bits = megakernel.index_bits_for(SMOKE["spp"])

    def variant_args(tables, mode, sampler, dynamic, bits, lights_fn=None):
        if mode == "path":
            lt = None
        elif dynamic:
            lt = (lights_fn or lights.light_table_dyn)(tables)
        else:
            lt = lights.light_table(tables)
        return dict(root=root, sampler=sampler, mode=mode, index_bits=bits, lights=lt)

    phase("3. kernels against their plain versions (64x64, 16 spp, max_depth 64)")
    scenes = {"cornell_box": cornell_box(), "cornell_panel": cornell_panel(),
              "mixed_panel": panel_scene()}
    for scene_name, desc in scenes.items():
        tables = compile_scene(desc, device="cuda")
        args = (tables, k0, k1, SMOKE["width"], SMOKE["height"], SMOKE["spp"], 0,
                SMOKE["max_depth"])
        for dynamic in (False, True):
            if dynamic and scene_name == "mixed_panel":
                continue
            for mode, sampler in VARIANTS:
                name = kernel_name("dynamic" if dynamic else "megakernel", mode, sampler)
                kw = variant_args(tables, mode, sampler, dynamic, smoke_bits)
                kern = megakernel.render_rays(*args, **kw)
                torch.cuda.synchronize()
                if dynamic and mode == "nee":
                    kw["lights"] = lights.light_table_dyn_reference(tables)
                plain = megakernel.render_rays_reference(*args, device="cuda", **kw)
                frac, err = hold_to_plain(f"{name} on {scene_name}", kern, plain)
                records[name]["fracs"].append(frac)
                records[name]["errs"].append(err)

        kern_t = lights.light_table_dyn(tables)
        torch.cuda.synchronize()
        plain_t = lights.light_table_dyn_reference(tables)
        for got, want in zip(kern_t, plain_t):
            close = torch.isclose(got, want, rtol=2.0 ** -23, atol=0.0)
            check(got.shape == want.shape and bool(close.all()),
                  f"{TABLE} on {scene_name}: not equal to its plain version to float32 rounding")
            records[TABLE]["fracs"].append(close.double().mean().item())
            records[TABLE]["errs"].append((got - want).abs().max().item())
        print(f"{TABLE} on {scene_name}: {kern_t.rows.shape[0]} rows, max |diff| "
              f"{max(records[TABLE]['errs'][-2:]):.3g} against the plain version")

    # K3's point: a scene edit in place re-renders with no rebuild.
    tables = compile_scene(cornell_box(), device="cuda")
    kw = dict(width=64, height=64, spp_chunk=SMOKE["spp"], spp_total=SMOKE["spp"],
              max_depth=SMOKE["max_depth"], sampler="sobol", mode="nee")
    base = render_chunk_dynamic(tables, (k0, k1, root), 0, **kw)
    torch.cuda.synchronize()
    libs_before = build.load_library.cache_info().misses
    files_before = sorted((p.name, p.stat().st_mtime_ns) for p in build.BUILD_DIR.iterdir())
    tables.materials[:, 3:6] *= 2.0
    doubled = render_chunk_dynamic(tables, (k0, k1, root), 0, **kw)
    tables.spheres[0, 0] += 0.05 * tables.spheres[0, 3]
    moved = render_chunk_dynamic(tables, (k0, k1, root), 0, **kw)
    torch.cuda.synchronize()
    rel = ((doubled - 2.0 * base).abs() / (2.0 * base).abs().clamp_min(1e-30)).max().item()
    print(f"K3 nee/sobol, every emission doubled: max relative difference from 2x {rel:.3g}")
    check(bool(torch.allclose(doubled, 2.0 * base, rtol=DOUBLING_RTOL, atol=0.0)),
          f"doubling emission did not double the image (max rel {rel:.3g})")
    check(not torch.equal(moved, doubled), "moving a sphere changed nothing")
    files_after = sorted((p.name, p.stat().st_mtime_ns) for p in build.BUILD_DIR.iterdir())
    check(build.load_library.cache_info().misses == libs_before and files_after == files_before,
          "a scene edit built or loaded a library")
    print("the emission edit and the moved sphere built and loaded no library")

    phase("4. the slices at 512x512, 256 spp, max_depth 64 (counts zeroed before each)")

    def zero_counts():
        megakernel.LAUNCHES = 0
        lights.LAUNCHES = 0

    with tempfile.TemporaryDirectory() as tmp:
        for mode, sampler in VARIANTS:
            png = os.path.join(tmp, f"{mode}_{sampler}.png")
            opts = RenderOptions(output=png, device="cuda", integrator=mode, sampler=sampler)
            session = RenderSession(cornell_box(), opts)
            zero_counts()
            t0 = time.perf_counter()
            result = session.render()
            torch.cuda.synchronize()
            render_s = time.perf_counter() - t0
            launches, table_launches = megakernel.LAUNCHES, lights.LAUNCHES
            name = kernel_name("megakernel", mode, sampler)
            records[name]["launches"] = launches
            chunks = -(-opts.samples_aa // opts.resolved_spp_chunk())
            print(f"{name}: {opts.width}x{opts.height}, {opts.samples_aa} spp, max_depth "
                  f"{opts.max_depth}: {result.status.name} in {render_s:.3f} s, {launches} "
                  f"launches for {chunks} chunks")
            check(result.status == RenderStatus.DONE, f"status {result.status}")
            check(launches == chunks == result.chunks and table_launches == 0,
                  f"{launches} launches for {chunks} chunks")
            img = result.image
            check(img.shape == (512, 512, 3) and bool((img >= 0).all()), "bad image")
            check(bool(torch.isfinite(torch.from_numpy(img)).all()), "image not finite")
            worst, bias, n_clean = golden_regions(png)
            print(f"  against the 16384-spp path golden: max clean-region diff {worst:.4f} "
                  f"({n_clean} clean regions), mean bias {[round(b, 4) for b in bias]}")
            if (mode, sampler) == ("path", "uniform"):
                check(n_clean >= MIN_REGIONS, f"only {n_clean} regions clip-free")
                check(worst < REGION_MAX, f"max clean-region diff {worst:.4f}")
                check(all(abs(b) <= REGION_BIAS for b in bias), f"mean bias {bias}")

        for extra in ([], ["--integrator", "nee", "--sampler", "sobol"]):
            cli_png = os.path.join(tmp, "cli.png")
            zero_counts()
            rc = cli_main(["--width", "128", "--height", "128", "--spp", "16", "-o", cli_png,
                           *extra])
            img = read_png(cli_png)
            print(f"python -m cornelis_tpu_torch {' '.join(extra)} at 128x128, 16 spp: rc {rc}, "
                  f"{megakernel.LAUNCHES} launch, PNG {img.shape}")
            check(rc == 0 and img.shape == (128, 128, 3) and img.max() > 0, "CLI render failed")
            check(megakernel.LAUNCHES == 1, "the CLI did not launch the kernel")

    opts = RenderOptions()
    spp_chunk = opts.resolved_spp_chunk()
    tables = compile_scene(cornell_box(), device="cuda")
    for mode, sampler in VARIANTS:
        name = kernel_name("dynamic", mode, sampler)
        zero_counts()
        t0 = time.perf_counter()
        frame = sum(
            render_chunk_dynamic(
                tables, (k0, k1, root), offset, width=opts.width, height=opts.height,
                spp_chunk=spp_chunk, spp_total=opts.samples_aa, max_depth=opts.max_depth,
                sampler=sampler, mode=mode,
            )
            for offset in range(0, opts.samples_aa, spp_chunk)
        ) / opts.samples_aa
        torch.cuda.synchronize()
        render_s = time.perf_counter() - t0
        chunks = opts.samples_aa // spp_chunk
        launches, table_launches = megakernel.LAUNCHES, lights.LAUNCHES
        records[name]["launches"] = launches
        if mode == "nee":
            records[TABLE]["launches"] += table_launches
        print(f"render_chunk_dynamic {mode}/{sampler}: {chunks} chunks in {render_s:.3f} s, "
              f"{launches} launches, {table_launches} table builds, frame mean "
              f"{[round(v, 4) for v in frame.mean((0, 1)).tolist()]}")
        check(launches == chunks and table_launches == (chunks if mode == "nee" else 0),
              f"{launches} launches and {table_launches} table builds for {chunks} chunks")
        check(bool(torch.isfinite(frame).all()) and bool((frame >= 0).all()), "bad dynamic frame")

    phase("5. times and agreement at the main path's chunk (512x512, 32 spp, median of 3)")
    rays = 512 * 512 * 32
    bits = megakernel.index_bits_for(opts.samples_aa)
    for dynamic in (False, True):
        for mode, sampler in VARIANTS:
            name = kernel_name("dynamic" if dynamic else "megakernel", mode, sampler)

            def run(offset, plain):
                # K3's table is rebuilt per chunk, as render_chunk_dynamic does.
                build_fn = lights.light_table_dyn_reference if plain else None
                kw = variant_args(tables, mode, sampler, dynamic, bits, build_fn)
                args = (tables, k0, k1, 512, 512, 32, offset, 64)
                if plain:
                    return megakernel.render_rays_reference(*args, device="cuda", **kw)
                return megakernel.render_rays(*args, **kw)

            kernel_s, kern = timed(lambda: run(0, False))
            plain_s, plain = timed(lambda: run(0, True))
            records[name]["ms"], records[name]["plain_ms"] = kernel_s * 1e3, plain_s * 1e3
            print(f"{name}: kernel {rays / kernel_s / 1e6:.1f} Mrays/s ({kernel_s * 1e3:.2f} ms), "
                  f"plain {rays / plain_s / 1e6:.1f} Mrays/s ({plain_s * 1e3:.2f} ms) on {card}")
            for offset in (0, 224):
                if offset:
                    kern = run(offset, False)
                    torch.cuda.synchronize()
                    plain = run(offset, True)
                frac, err = hold_to_plain(f"  {name} 512x512, 32 spp, offset {offset}", kern, plain)
                records[name]["fracs"].append(frac)
                records[name]["errs"].append(err)
                del kern, plain

    tables = compile_scene(cornell_box(), device="cuda")
    kernel_s, _ = timed(lambda: lights.light_table_dyn(tables))
    plain_s, _ = timed(lambda: lights.light_table_dyn_reference(tables))
    records[TABLE]["ms"], records[TABLE]["plain_ms"] = kernel_s * 1e3, plain_s * 1e3
    print(f"{TABLE} on cornell_box: kernel {kernel_s * 1e3:.4f} ms, plain {plain_s * 1e3:.4f} ms "
          f"(host clock around a synchronize)")

    # The firefly of tests/test_nee.py: Cornell 512^2, nee + sobol, spp_total
    # 2048, pixel 77580, samples 544-575, rendered as the chunk that holds it.
    lo, hi = FIREFLY_SAMPLES
    spp = hi - lo
    ff_bits = megakernel.index_bits_for(FIREFLY_SPP_TOTAL)
    sample = torch.arange(lo, hi, device="cuda")
    pixel = torch.full_like(sample, FIREFLY_PIXEL)
    for label, clamp in (("clamp off", math.inf), ("default clamp", None)):
        lt = lights.light_table(tables, clamp)
        chunk = megakernel.render_rays(tables, k0, k1, 512, 512, spp, lo, 64, root=root,
                                       sampler="sobol", mode="nee", index_bits=ff_bits, lights=lt)
        own = chunk[FIREFLY_PIXEL * spp:(FIREFLY_PIXEL + 1) * spp]
        plain = megakernel.render_rays_reference(
            tables, k0, k1, 512, 512, 1, 0, 64, "cuda", root=root, sampler="sobol", mode="nee",
            index_bits=ff_bits, lights=lt, pixel=pixel, sample=sample,
        )
        print(f"firefly, pixel {FIREFLY_PIXEL}, samples {lo}-{hi - 1}, {label}: kernel: largest "
              f"sample {own.max().item():.6g}, pixel sum {own.sum(0).max().item():.6g}; plain "
              f"version: largest sample {plain.max().item():.6g}, pixel sum "
              f"{plain.sum(0).max().item():.6g}")

    kernels = []
    for rec in records.values():
        fracs, errs = rec.pop("fracs"), rec.pop("errs")
        check(rec["launches"] > 0, f"{rec['name']} was not launched by its main path")
        kernels.append({**rec, "min_fraction_within_tol": min(fracs), "max_abs_err": max(errs),
                        "tol": RAY_TOL if rec["name"] != TABLE else 2.0 ** -23})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
