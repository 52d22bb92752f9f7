#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one GPU, and check them.

    python3 chip_smoke.py

Needs a CUDA device, nvcc, and the repository around this script; it
imports no JAX. Phases, each printed as it runs; every failed check
raises, so the exit code is not 0 and no result line is printed:

  1. card and tools: the device, its power limit, torch, CUDA, nvcc;
  2. build: every library of ops/csrc/ with nvcc, in parallel, timed, and
     the registers, spills and SASS size of each kernel instantiation (no
     megakernel instantiation may spill, those that read a pixel list
     included, nor any probe or draws kernel; the probes library must be built with
     -fmad=false); the SASS instructions a ray spends on a sphere in K5
     and K6 and an (element, object) in K4, and their launch shapes; K4's
     "disc" design (probes/scan_designs.py: probes.cu with quad_root
     returning its disc) built beside them, whose SASS must be the
     production kernel's but for the root (scan_designs.quad_root_difference);
     then the warm-up path (K2):
     warm_kernels() loads every library and megakernel instantiation and
     launches the zero fill, whose output must equal torch.zeros, with
     the seconds of the load and of the first launch; and the first and
     second launch of every instantiation after it (the dynamic nee ones,
     which build K3's light table in the launch, too);
  3. kernel against plain: each megakernel instantiation (mode path or
     nee, sampler uniform or sobol) and its plain torch version on the
     same card, ray by ray, at 64x64, 16 spp, max_depth 64, on
     cornell_box, cornell_panel and a mixed sphere + panel scene, and
     each SDF instantiation on sdf_gallery and on a scene whose torus and
     box are turned and scaled, and path/uniform on sphere_grid(2200) and
     sphere_grid(3000), whose tables cross the kernel's 48 KB and 64 KB
     shared-memory marks; the dynamic-scene render (K3: the same
     kernel, whose nee launch builds the light table in every block) on
     cornell_box and cornell_panel, its nee rays also bit for bit those
     of K1's nee instantiation fed light_table_dyn_reference's table;
     the one-block table kernel bit for bit its plain version on those
     scenes, sphere_grid(64), (512) and (2200) and tables with a -0, an
     infinite and a NaN emission, ids off the material table and no
     emission; doubling every emission doubles K3's nee image; neither
     that edit nor a moved sphere builds or loads a library again; the
     zero fill (K2) and the probe kernels (K4 in float32 and bfloat16, K5
     at 512 and 8 spheres, K6) at their JAX shapes against their plain
     versions, K4 bit for bit also on its special input (every bfloat16
     pattern; float32 NaN, infinities, zeros, subnormals, overflowing
     inputs and random patterns) and, since its output is +0 on every
     input (no root fires), its "disc" design bit for bit
     scan_designs.disc_sum_reference on both inputs, the check that can
     fail a wrong chain; K5 and K6 also on the special lanes
     (NaN, infinities, zeros, huge origins, origins inside a sphere,
     grazing rays);
  4. the slices, each with the launch counts zeroed just before it and
     read just after: RenderSession(cornell_box(), RenderOptions(...))
     at 512x512, 256 spp, max_depth 64 with the PNG written, for the
     default path/uniform (checked region by region against the committed
     16384-spp render of the JAX package, tests/golden/ours_cornell_512.png)
     and for nee/sobol, path/sobol and nee/uniform (region means printed
     only: the nee estimator is not the golden's); the same four
     sessions on sdf_gallery, every launch through an SDF instantiation
     (region means printed); the command line at 128x128 for the default,
     for --integrator nee --sampler sobol and for --scene sdf-gallery;
     render_chunk_dynamic over the Cornell frame in every mode and
     sampler (nee: no table launch, every launch one that builds the
     table, the frame bit for bit render_chunk's with
     light_table_dyn_reference's table), and in nee/sobol over
     sphere_grid(512)'s frame and a 128x128, 32-spp chunk of
     sphere_grid(2200) (its nee tables past the shared-memory cap), held
     the same way; a nee/sobol session on sphere_grid(512) through
     RenderSession.update_scene (K1 until the edit, then one K3 launch a
     chunk and no table launch, the edited frame held the same way); the
     table kernel's own entry, light_table_dyn, on
     Cornell; the two probes' command lines (K5 and K6, K4);
  5. times: each instantiation and K3 for one 32-spp chunk at 512x512
     (spp_total 256; median of 3 after a warm-up) against one run of its
     plain version (the same chunk on Cornell; on sdf_gallery every
     SDF_STRIDE-th ray of it, traced as its (pixel, sample), as 128-step
     marches in torch ops over 8.4M rays take long); the two outputs, and
     those of the last chunk (offset 224), held to the phase-3 bar ray by
     ray, and the dynamic nee rays bit for bit K1's fed the plain table;
     the table kernel by the profiler on Cornell and sphere_grid(512);
     the probes at their JAX shapes (K4, K5 and K6 beside the floor their
     SASS instructions set at the SM clock nvidia-smi reads; K4 by the
     profiler's kernel time beside the chained launches' CUDA-event time,
     which the host's launch rate bounds) and the zero fill against
     torch.zeros (CUDA events, with torch.empty's time beside them: the
     allocation both pay); the wavefront's draws kernels (ops/csrc/draws.cu)
     at the inverse cell's 2,097,152 rays a render, bit for bit the torch
     version on the card, and stream_uniforms at num 4 and ray_streams
     timed beside it, their bytes bound and their issue floor by integer
     operations (`draws_phase`); then the pinned NEE firefly of
     tests/test_nee.py on the kernel, clamp off and on (printed only);
  6. the differentiable mode, torch ops under autograd and the draws
     kernels: (a) the wavefront's render_chunk against the megakernel's on
     Cornell at 256x256, 32 spp, max_depth 64, path/uniform and nee/sobol
     (different draws: per-channel image means within 2%); (b) render_diff
     and the gradients of all seven float fields on the card against the
     CPU, Cornell 32x32, 8 spp, max_depth 4, path and nee (pixels and
     gradients as tests/test_torch_diff.py holds them against JAX); (c)
     finite differences on the card as tests/test_diff.py's (albedo and
     emission in path and nee, roughness attached), 64x64, 16 spp,
     max_depth 4, over the pixels with no jump inside the window; (d)
     InverseRenderer steps at the JAX package's inverse-render shape
     (Cornell 256x256, 32 spp, max_depth 16, albedo and roughness, "dual",
     lr 5e-2) and at bench.py's (128x128, 32 spp, max_depth 8), each mode:
     a warm step (its draws-kernel launches checked: the streams twice, the
     uniforms 2 x (1 + 2 x max_depth); those of the demo path step are the
     kernels line's launches of both), 8 timed steps, the loss without gradient 8 times, peak
     memory; (e) the albedo recovery of tests/test_diff.py on the card
     (sphere_on_plane 24x24, 250 steps); (f) one profiled demo step: the
     busiest device operations and the share of the gather's backward. Its
     figures are the {"diff": ...} line before the kernels line;
  7. the mesh (B6: K1 on each rank's shard of a (tiles, samples) mesh):
     (a) every instantiation through its pixel-id operand (the ids
     instantiations) on each rank's shard of a 2x2 mesh, against its plain
     version on the same (pixel, sample) rays, the four shards together at
     phase 3's size and bar, and rank 3's shard bitwise against the
     contiguous launch's rows at the main chunk (512x512, 32 spp); that
     shard's launch timed (its row in the kernels line); then child ranks
     (this script with --rank, each under a timeout) that share the card
     over gloo: (b) four ranks through the command line, --mesh 2x2 at the
     main path's 512x512, 256 spp, max_depth 64 (every rank exits 0, one
     PNG, rank 0's) and --mesh 4x1, whose PNG must be byte-equal to the
     single-process command line's; (c) the (2, 2) Cornell session's linear
     image within rtol 1e-5 / atol 1e-6 of one process's, and sdf-gallery
     nee/sobol at 512x512, 32 spp on (1, 2), with each rank's launches,
     kernel ms (CUDA events, one rank at a time) and assembly ms, and the
     session walls beside one process's; (d) one rank over NCCL on (1, 1),
     bitwise equal to the render without a mesh (image and PNG); (e) the
     sharded train step at bench.py's diff shape on (2, 1) and (1, 2), its
     gradients within 1e-4 relative L2 of one process's; (f) two ranks on
     (2, 1) with a time budget, a checkpoint and a progress callback on
     rank 0 alone: both stop at rank 0's chunk, only rank 0's checkpoint
     exists. Its figures are the {"mesh": ...} line;
  8. the session at the main path's width (Cornell 512x512, 256 spp,
     max_depth 64, path/uniform), every branch launching K1: (a) a progress
     callback (completed <= dispatched, monotone, ending on the 8 chunks)
     and its wall against the plain session's, in turns; (b) an abort at
     the first callback (32 spp); (c) an abort after chunk 3 with a
     checkpoint (the JAX package's npz keys) and its resume, against the
     straight session; (d) a 0.05 s budget over 4096 spp against a
     straight render at the count it reached; (e) the command line with
     --checkpoint, --time-budget, --standard-srgb, --profile-dir and -q;
     (f) the native host library loaded, and the session's PNG byte-equal
     to the Python and the native encoders' on its uint8 image; (g) the PNG wall's split on the card's host
     (copy, accumulate, tonemap, encode; torch or numpy against native,
     median of 5); (h) tests/test_golden_image.py's 128x128 live golden on
     the port's wavefront. Its figures are the {"session": ...} line.

Each kernel's least time (bound_ms) is computed from this run's inputs:
for the megakernel, the float32 operations of the work the kernel does
for the timed rays (closest-hit scans, hits, bounces, light samples,
shadow rays and lit samples, SDF march steps below the best hit and below
t_max, and normals; counted by `counted_work` on a second run of the plain
version) at the per-part
counts of OPS, over 67 TFLOP/s; for the others, the larger of their
operations over the peak of their type (float32 67, bfloat16 outside the
tensor cores 133.8 TFLOP/s) and their bytes over 3.35 TB/s. The last
lines are a JSON record of the kernels and then {"ok": true, "device":
{...}}.
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
from concurrent.futures import ThreadPoolExecutor

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
K2_TPU = "cornelis_tpu/ops/pallas_integrator.py:224"
K3_TPU = "cornelis_tpu/ops/pallas_dynamic.py:174"
K4_TPU = "benchmarks/bf16_probe.py:36"
K5_TPU = "benchmarks/dynamic_scene_probe.py:61"
K6_TPU = "benchmarks/dynamic_scene_probe.py:94"
TABLE = "light_table_dyn"
# K1's staging of tables larger than its shared-memory cap (not on a main
# path: phase 3 drives it with sphere_grid(3000)).
STAGE = "stage_tables"
ZERO = "zero_fill"
BAKED, DYNAMIC = "scan_baked", "scan_dynamic"
QUAD = {"float32": "quad_probe f32", "bfloat16": "quad_probe bf16"}
# The wavefront's draws kernels (ops/csrc/draws.cu): the uniforms of a draw
# group and the ray-stream builder. They replace no TPU kernel: XLA fused
# cornelis_tpu/rng.py's draws into the wavefront.
DRAWS, RAY_STREAMS = "stream_uniforms", "ray_streams"
DRAWS_TPU = "none: cornelis_tpu/rng.py's draws, fused by XLA"
# The inverse-render cell's rays a render (256 x 256 pixels, 32 spp).
DRAWS_N = 256 * 256 * 32
# 32-bit integer operations of a Threefry-2x32 block: the third key word
# (2), the counter words (2), 20 rounds of add, rotate and xor (60) and 5
# key injections (15). A uniform adds 3 (xor, shift and or, subtract), a
# hash32 6.
THREEFRY_OPS = 79
# The SDF phase-5 plain version traces every SDF_STRIDE-th ray of the
# kernel's 32-spp chunk (a stride prime to 32, so every sample index of
# the chunk is among them): 270,601 rays.
SDF_STRIDE = 31
# Probe bars: K5 and K6 within 1 float32 ulp (rtol 2^-23); K4 bit for bit
# (its kernel rounds each operation as the plain version does).
F32_ULP = 2.0 ** -23

# The card's peaks at 700 W: float32 outside the tensor cores and device
# memory (NVIDIA's H100 SXM data sheet), bfloat16 outside the tensor cores
# (NVIDIA's H100 architecture whitepaper, SXM5).
PEAK_FP32 = 67e12
PEAK_BF16 = 133.8e12
PEAK_BYTES = 3.35e12
# Float32 operations of each part of the megakernel, counted from
# ops/csrc/megakernel.cu (a sqrt, division, sin, cos or exp counts as 1;
# integer hashing of the draws counts as 0; where the work takes one of
# two branches, the cheaper; so these are lower bounds):
#   camera: jitter, generate_rays and normalize, once per ray;
#   scan: ray_pre once per closest-hit scan, plus per sphere sphere_t,
#     the winner's point and normal, per plane plane_t (without its basis,
#     a per-plane constant), and with SDF rows sdf_ray plus per SDF its
#     load, final test and t conversion;
#   hit: emission, two draws' floats, Russian roulette;
#   bounce: construct_basis (30), the hemisphere lobe (25; the glossy one
#     takes 70), layered_eval (172), the throughput and origin update
#     (20); bounce_pdf: layered_sample's glossy_pdf mixture in mode path,
#     the layered_pdf_true that replaces it in mode nee;
#   nee_hit, every hit: sample_light at its plane branch without the
#     plane's basis (44; the sphere cone takes about 95), cos and its test;
#   nee_emission, every hit after the first: emission's MIS weight and
#     clamp; nee_shadow, every shadow ray cast: its origin and ray_pre (the
#     sphere and plane scan is not counted: it may stop at its first
#     occluder; its SDF march steps are, as sdf_step); nee_shade,
#     every unoccluded light sample: layered_eval, layered_pdf_true, MIS,
#     clamps and sum;
#   sdf_step: one march step by kind (point, centre, rotation, scale,
#     distance, tests, step), counted only below the limit the kernel's
#     march stops at (the best hit so far, t_max); sdf_normal: the
#     tetrahedron normal by kind.
OPS = {
    "camera": 25, "ray_pre": 14, "sphere": 25, "sphere_win": 20, "plane": 35,
    "sdf_ray": 16, "sdf": 6, "hit": 23, "bounce": 247, "bounce_pdf": {"path": 46, "nee": 47},
    "nee_hit": 50, "nee_emission": 13, "nee_shadow": 20, "nee_shade": 243,
    "sdf_step": {0: 44, 1: 55, 2: 48}, "sdf_normal": {0: 101, 1: 145, 2: 117},
}
# Operations per element and object of the probes, from csrc/probes.cu:
# the scan 23 (24 with K6's r * r); the quadratic chain 9 in the working
# type (x c + d, x x - 2c x + k, b b - cc, the sum) and 3 in float32
# (compare, max, sqrt), plus 2 conversions in bfloat16.
SCAN_OPS = {BAKED: 23, DYNAMIC: 24}
# The scheduler count of an H100 SM: each issues one warp instruction a
# clock, which with the SASS instructions a ray spends on a sphere sets
# K5's and K6's issue floor.
SCHEDULERS_PER_SM = 4
QUAD_OPS = {"float32": dict(fp32=12), "bfloat16": dict(bf16=9, fp32=5)}


def phase(msg: str) -> None:
    print(f"== {msg}", flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


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


def instantiation_name(entry: str) -> str:
    """The report name of a kernel from its mangled entry name."""
    m = re.search(r"megakernelILb([01])ELb([01])ELb([01])ELb([01])E", entry)
    if m:
        name = kernel_name("megakernel", ("path", "nee")[int(m.group(1))],
                           ("uniform", "sobol")[int(m.group(2))])
        return name + (" sdf" if m.group(3) == "1" else "") + (" ids" if m.group(4) == "1" else "")
    m = re.search(r"megakernel_dynILb([01])E", entry)
    if m:
        return kernel_name("megakernel_dyn", "nee", ("uniform", "sobol")[int(m.group(1))])
    if "stage_tables_dyn" in entry:
        return f"{STAGE}_dyn nee"
    m = re.search(r"stage_tablesILb([01])E", entry)
    if m:
        return f"{STAGE} {('path', 'nee')[int(m.group(1))]}"
    m = re.search(r"scan_bakedILi(\d+)E", entry)
    if m:
        return f"{BAKED} {m.group(1)}"
    for name in (DRAWS, RAY_STREAMS):
        if name in entry:
            return name
    if "quad_probe" in entry:
        return QUAD["bfloat16" if "bfloat16" in entry else "float32"]
    for name in (DYNAMIC, ZERO, TABLE):
        if name in entry:
            return name
    return entry


def ptxas_report(logs: dict) -> dict:
    """{kernel name: (registers, stack bytes, spill store + load bytes)}
    from nvcc's -Xptxas=-v output."""
    report, current = {}, None
    for log in logs.values():
        for line in log.splitlines():
            entry = re.search(r"Compiling entry function '([^']+)'", line)
            if entry:
                current = instantiation_name(entry.group(1))
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


def sass_listings(libraries: dict) -> dict:
    """{kernel name: [(address, SASS instruction)]} by cuobjdump, where the
    toolkit has it; {} otherwise."""
    from cornelis_tpu_torch.ops.build import _nvcc

    tool = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return {}
    listings, current = {}, None
    for so, _seconds in libraries.values():
        out = subprocess.run([tool, "-sass", str(so)], capture_output=True, text=True).stdout
        for line in out.splitlines():
            fn = re.search(r"Function : (\S+)", line)
            ins = re.match(r"\s+/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;?\s*/\*", line)
            if fn:
                current = instantiation_name(fn.group(1))
                listings[current] = []
            elif current and ins:
                listings[current].append((int(ins.group(1), 16), ins.group(2)))
    return listings


def innermost_loop(listing) -> int:
    """SASS instructions in the largest innermost loop of a listing: the
    widest span from a backward branch's target to the branch that holds
    no other backward branch's span."""
    loops = []
    for addr, text in listing:
        target = re.search(r"BRA(?:\.\S+)* (0x[0-9a-f]+)", text)
        if target and int(target.group(1), 16) < addr:
            loops.append((int(target.group(1), 16), addr))
    inner = [(a, b) for a, b in loops
             if not any(a <= c and d <= b and (c, d) != (a, b) for c, d in loops)]
    return max((sum(a <= addr <= b for addr, _ in listing) for a, b in inner), default=0)


def sass_per_sphere(listings: dict, shapes: dict) -> dict:
    """SASS instructions a ray spends on a sphere, in K5 (the 512-sphere
    instantiation less the 8-sphere one, over 504 spheres and its rays a
    thread) and K6 (its sphere loop's body over the spheres and rays of
    one pass)."""
    out = {}
    k5 = (f"{BAKED} 512", f"{BAKED} 8")
    if all(name in listings for name in k5):
        extra = len(listings[k5[0]]) - len(listings[k5[1]])
        out[BAKED] = extra / 504 / shapes[BAKED]["rays_per_thread"]
    if DYNAMIC in listings:
        shape = shapes[DYNAMIC]
        out[DYNAMIC] = (innermost_loop(listings[DYNAMIC])
                        / (shape["spheres_per_pass"] * shape["rays_per_thread"]))
    return out


def sm_clock_mhz() -> float:
    """The SM clock nvidia-smi reads now, in MHz."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True)
    return float(out.stdout.split()[0])


def counted_work(megakernel, run):
    """(run()'s result, the work the kernel does for the same rays): run()
    calls the plain version, whose `intersect`, `_sample_light` and
    `occluded` are wrapped for the call. The plain version traces every ray
    at every depth under a mask, and leaves a finished ray's origin and
    direction as they were; a ray is live at a depth (its kernel thread
    still runs) when they moved since the depth before. Counts: "traced"
    closest-hit scans, "hits" and "later_hits" (after the first bounce),
    "bounces" (live at the next depth: a bounce at the last depth is not
    seen), "sdf_hits" (each needing a normal), "march_steps" {kind: steps}
    (each SDF's march up to the best hit of the spheres, planes and earlier
    SDFs), and in mode nee "shadow_rays" (valid light samples facing the
    surface), "lit" (those unoccluded) and "shadow_steps" {kind: steps}
    (the SDF marches of shadow rays no sphere or plane occludes, each up
    to t_max, until one occludes)."""
    import torch

    from cornelis_tpu_torch.geometry import sdf_candidate, sdf_march_steps, sdf_objects
    from cornelis_tpu_torch.scene.compile import scene_arrays
    from cornelis_tpu_torch.math.vec import Vec3, dot

    names = ("intersect", "_sample_light", "occluded")
    orig = {name: getattr(megakernel, name) for name in names}
    counts, state = {}, {}

    def add(key, mask):
        counts[key] = counts.get(key, 0) + mask.sum()

    def intersect(tables, o, d):
        out = orig["intersect"](tables, o, d)
        _t, _p, n, _mid, prim, hit = out
        od = torch.stack([*o, *d])
        later = "od" in state
        live = (state["live"] & (od != state["od"]).any(0)) if later else torch.ones_like(hit)
        if later:
            add("bounces", live)
            add("later_hits", live & hit)
        state.update(od=od, live=live, shaded=live & hit, n=n)
        add("traced", live)
        add("hits", live & hit)
        add("sdf_hits", live & hit & (prim < 0))
        if tables.sdfs.shape[0]:
            lo, ld = Vec3(*(c[live] for c in o)), Vec3(*(c[live] for c in d))
            best = orig["intersect"](tables._replace(sdfs=tables.sdfs[:0]), lo, ld)[0]
            for kind, center, params, _m, rot, scale in sdf_objects(scene_arrays(tables)):
                add(("march", kind), sdf_march_steps(lo, ld, kind, center, params, rot, scale,
                                                     limit=best))
                t, _p, _n, valid = sdf_candidate(lo, ld, kind, center, params, rot=rot,
                                                 scale=scale, with_normal=False, limit=best)
                best = torch.where(valid & (best > t), t, best)
        return out

    def sample_light(*args):
        out = orig["_sample_light"](*args)
        wi, _t, _pdf, valid, _le = out
        state["cast"] = state["shaded"] & valid & (dot(wi, state["n"]) > 0.0)
        add("shadow_rays", state["cast"])
        return out

    def occluded(tables, o, d, t_max):
        occ = orig["occluded"](tables, o, d, t_max)
        add("lit", state["cast"] & ~occ)
        if tables.sdfs.shape[0]:
            left = state["cast"] & ~orig["occluded"](tables._replace(sdfs=tables.sdfs[:0]), o, d,
                                                     t_max)
            for kind, center, params, _m, rot, scale in sdf_objects(scene_arrays(tables)):
                idx = left.nonzero().flatten()
                so, sd = Vec3(*(c[idx] for c in o)), Vec3(*(c[idx] for c in d))
                add(("shadow", kind), sdf_march_steps(so, sd, kind, center, params, rot, scale,
                                                      limit=t_max[idx]))
                t, _p, _n, valid = sdf_candidate(so, sd, kind, center, params, rot=rot,
                                                 scale=scale, with_normal=False, limit=t_max[idx])
                left[idx] = ~(valid & (t < t_max[idx]))
        return occ

    wrappers = {"intersect": intersect, "_sample_light": sample_light, "occluded": occluded}
    try:
        for name in names:
            setattr(megakernel, name, wrappers[name])
        result = run()
    finally:
        for name in names:
            setattr(megakernel, name, orig[name])
    work = {"march_steps": {}, "shadow_steps": {}}
    for key, n in counts.items():
        if isinstance(key, tuple):
            work[f"{key[0]}_steps"][key[1]] = int(n)
        else:
            work[key] = int(n)
    return result, work


def megakernel_bound_ms(work: dict, n_rays: int, tables, mode: str, scale: float = 1.0) -> float:
    """The least time of one megakernel launch: the float32 operations of
    the work `counted_work` counted (times `scale` where the plain version
    traced a sample of the launch's rays) over PEAK_FP32; the launch reads
    tables of a few hundred bytes and writes 12 B a ray, far less by the
    bytes."""
    n_s, n_p, n_k = (tables.spheres.shape[0], tables.planes.shape[0], tables.sdfs.shape[0])
    scan = (OPS["ray_pre"] + n_s * OPS["sphere"] + (n_s > 0) * OPS["sphere_win"]
            + n_p * OPS["plane"] + (n_k > 0) * (OPS["sdf_ray"] + n_k * OPS["sdf"]))
    kinds = [int(k) for k in tables.sdfs[:, 0].tolist()]
    traced = (
        work["traced"] * scan
        + work["hits"] * OPS["hit"]
        + work.get("bounces", 0) * (OPS["bounce"] + OPS["bounce_pdf"][mode])
        + sum(OPS["sdf_step"][k] * n for k, n in work["march_steps"].items())
        + sum(OPS["sdf_step"][k] * n for k, n in work["shadow_steps"].items())
        + (work["sdf_hits"] * min(OPS["sdf_normal"][k] for k in kinds) if kinds else 0)
    )
    if mode == "nee":
        traced += (work["hits"] * OPS["nee_hit"] + work.get("later_hits", 0) * OPS["nee_emission"]
                   + work.get("shadow_rays", 0) * OPS["nee_shadow"]
                   + work.get("lit", 0) * OPS["nee_shade"])
    ops = n_rays * OPS["camera"] + scale * traced
    return max(ops / PEAK_FP32, n_rays * 12 / PEAK_BYTES) * 1e3


def bound_ms(nbytes: float, fp32: float = 0.0, bf16: float = 0.0):
    """(least milliseconds, "operations" or "bytes") of a kernel moving
    `nbytes` and doing `fp32` float32 and `bf16` bfloat16 operations
    outside the tensor cores."""
    t_ops, t_bytes = fp32 / PEAK_FP32 + bf16 / PEAK_BF16, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def timed(fn, reps=3, warmup=True, sync=None):
    """(median seconds of `reps` calls after one warm-up, synchronized by
    `sync`, the card's by default; the last call's result)."""
    import torch

    sync = sync or torch.cuda.synchronize
    if warmup:
        fn()
    sync()
    times = []
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
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


def draws_phase(ptxas: dict, listings: dict, card: str) -> dict:
    """The wavefront's draws kernels (ops/csrc/draws.cu) at the inverse
    cell's rays a render: bit for bit the torch version on the card, then
    `stream_uniforms` at num = 4 and `ray_streams` timed (the profiler's
    kernel time, and CUDA events over chained launches) beside the torch
    version, their bytes over 3.35 TB/s and their issue floor (their 32-bit
    integer operations a ray over the card's schedulers at the SM clock).
    Returns their kernels-line records, whose launches phase 6 counts on the
    main path."""
    import torch

    from cornelis_tpu_torch import rng
    from cornelis_tpu_torch.ops import draws
    from cornelis_tpu_torch.sampling import hash32
    from cornelis_tpu_torch.utils.timing import event_ms, kernel_ms

    for name in (DRAWS, RAY_STREAMS):
        regs, stack, spill = ptxas[name]
        print(f"{name}: {regs} registers, {stack} B stack, {spill} B spilled, "
              f"{len(listings.get(name, ())) or 'uncounted'} SASS instructions")
    n = DRAWS_N
    keys = torch.randint(0, 1 << 32, (n, 2), dtype=torch.int64, device="cuda")
    keys[::3, 1] |= 0x80000000
    for num in (2, 4, 7, 8):
        for stream in (0, 17, 2**32 - 1):
            got = draws.stream_uniforms(keys, stream, num)
            want = rng.ray_uniforms(keys, stream, num)
            check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
                  f"stream_uniforms num {num}, stream {stream}: not the torch version's bits")
    pixel = torch.arange(n // 32, device="cuda").repeat_interleave(32)
    sample = torch.arange(32, device="cuda").repeat(n // 32)
    root = rng.make_key(SEED, "cuda")
    got_keys, got_seed = draws.ray_streams(root, pixel, sample)
    root_word = rng.bits(rng.fold_in(root, 0x50B0), 1)[0]
    check(torch.equal(got_keys, rng.pixel_sample_keys(root, pixel, sample))
          and torch.equal(got_seed, hash32(pixel ^ hash32(root_word))),
          "ray_streams: not the torch version's keys and seeds")
    print(f"draws kernels bit for bit the torch version at {n} rays (num 2, 4, 7, 8; streams 0, "
          f"17, 2^32 - 1; ray_streams at 256^2 x 32 spp)")

    mhz = sm_clock_mhz()
    schedulers = torch.cuda.get_device_properties(0).multi_processor_count * SCHEDULERS_PER_SM
    out = {}
    for name, fn, plain, nbytes, ops in (
        (DRAWS, lambda: draws.stream_uniforms(keys, 17, 4),
         lambda: rng.ray_uniforms(keys, 17, 4), 16 * n + 16 * n, 5 * THREEFRY_OPS + 4 * 3),
        (RAY_STREAMS, lambda: draws.ray_streams(root, pixel, sample),
         lambda: (rng.pixel_sample_keys(root, pixel, sample), hash32(pixel ^ hash32(root_word))),
         16 * n + 16 * n + 8 * n, 4 * THREEFRY_OPS + 2 * 6 + 1),
    ):
        ms, kept = kernel_ms(fn, 64, name)
        chained = event_ms(fn, 200)
        plain_ms = event_ms(plain, 5)
        bound, bound_by = bound_ms(nbytes)
        floor = ops * n / 32 / schedulers / (mhz * 1e3)
        out[name] = {
            "name": name, "route": "cuda", "source": CSRC + "draws.cu", "replaces": DRAWS_TPU,
            "registers": ptxas[name][0], "spill_bytes": ptxas[name][2],
            "launches": 0, "fracs": [1.0], "errs": [0.0],
            "ms": ms, "chained_ms": chained, "profiler_kept": [kept, 64], "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": bound_by, "issue_floor_ms": floor, "int_ops": ops,
            "library_ms": None, "tol": 0.0, "rays": n,
        }
        print(f"{name}: kernel {ms:.5f} ms on the device (profiler, {kept} of 64 kept), "
              f"{chained:.5f} ms a chained launch (CUDA events), torch version {plain_ms:.4f} ms "
              f"({plain_ms / ms:.1f}x); bytes bound {bound:.5f} ms, issue floor {floor:.5f} ms "
              f"({ops} integer operations a ray, {schedulers} schedulers at {mhz:.0f} MHz) at "
              f"{n} rays on {card}")
    return out


# Phase 6. The seven float fields of tests/test_diff.py; each gradient
# within 2% relative L2 of the CPU's, over the pixels whose image agrees
# (the knife-edge rays of ROADMAP §C go elsewhere under another rounding)
# and without the light's albedo and tint rows, which only zero-throughput
# rays re-hitting the light carry (tests/test_torch_diff.py).
DIFF_FIELDS = ("mat_albedo", "mat_emission", "mat_tint", "mat_roughness", "sphere_center",
               "sphere_radius", "plane_point")
LIGHT_ROWS = ("mat_albedo", "mat_tint")
GRAD_REL = 0.02
WAVE_MEAN_REL = 0.02
# Finite differences: a pixel whose two one-sided differences part by
# more than JUMP_TOL x (1 + |value|) has a discontinuity (an RR kill, a
# below-horizon flip, a silhouette) inside the window, and is left out of
# both the loss and its difference; at least FD_SMOOTH of them must stay.
JUMP_TOL = 1e-5
FD_SMOOTH = 0.9
# (field, component, index or None for the light, eps, rtol, atol, detach)
# as tests/test_diff.py:113-194.
FD_CHECKS = (
    ("mat_albedo", "x", 1, 1e-2, 0.05, 2e-4, True),
    ("mat_emission", "x", None, 1e-2, 0.05, 2e-4, True),
    ("mat_roughness", None, 1, 2e-4, 0.05, 5e-4, False),
)
# The inverse-render shapes: tools/r5_inverse.py's demo and bench.py's.
DIFF_SHAPES = (("demo", 256, 32, 16), ("bench", 128, 32, 8))
DIFF_STEPS = 8


def diff_grads(scene, weight, key, fields=DIFF_FIELDS, **kw):
    """(render_diff image, {field: gradient}) of the weight-masked image
    mean, the gradients as numpy vectors (Vec3 rows concatenated)."""
    import torch

    from cornelis_tpu_torch.diff import render_diff
    from cornelis_tpu_torch.math.vec import Vec3
    from cornelis_tpu_torch.rng import make_key

    leaf = lambda t: t.detach().clone().requires_grad_(True)
    leaves = {f: Vec3(*(leaf(c) for c in v)) if isinstance(v, Vec3) else leaf(v)
              for f, v in ((f, getattr(scene, f)) for f in fields)}
    img = render_diff(scene._replace(**leaves), make_key(key, scene.device), **kw)
    (torch.sum(img * weight[:, :, None]) / (3.0 * weight.sum())).backward()
    grads = {f: torch.cat([c.grad.flatten() for c in (v if isinstance(v, Vec3) else (v,))])
             .cpu().numpy() for f, v in leaves.items()}
    return img.detach(), grads


def fd_check(scene, field, component, index, eps, key, **kw):
    """(gradient, finite difference, share of smooth pixels) of one float
    of `field`, over the pixels with no jump inside the window."""
    import torch

    from cornelis_tpu_torch.diff import render_diff
    from cornelis_tpu_torch.rng import make_key

    value = getattr(scene, field)
    base = value if component is None else getattr(value, component)
    onehot = (torch.arange(base.shape[0], device=base.device) == index).float()

    def at(t):
        return scene._replace(**{field: t if component is None else value._replace(**{component: t})})

    k = make_key(key, scene.device)
    with torch.no_grad():
        f0, fp, fm = (render_diff(at(base + d * onehot), k, **kw) for d in (0.0, eps, -eps))
    jump = ((fp - f0) - (f0 - fm)).abs()
    smooth = (jump <= JUMP_TOL * (1.0 + f0.abs())).all(dim=-1).float()
    norm = 3.0 * smooth.sum()
    leaf = base.detach().clone().requires_grad_(True)
    (render_diff(at(leaf), k, **kw) * smooth[:, :, None]).sum().div(norm).backward()
    fd = float(((fp - fm) * smooth[:, :, None]).sum() / norm) / (2 * eps)
    return float(leaf.grad[index]), fd, float(smooth.mean()), float((fp - fm).mean()) / (2 * eps)


def diff_phase(device: str, card: str, cpu_scale: int = 1) -> dict:
    """Phase 6 on `device`; the {"diff": ...} record. cpu_scale > 1 divides
    every frame's width (a rehearsal on the CPU)."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from cornelis_tpu_torch import integrator
    from cornelis_tpu_torch.diff import InverseRenderer, make_loss, render_diff
    from cornelis_tpu_torch.math.vec import Vec3
    from cornelis_tpu_torch.ops import draws, megakernel
    from cornelis_tpu_torch.rng import fold_in, key_row, make_key
    from cornelis_tpu_torch.scene.compile import compile_scene, scene_arrays
    from cornelis_tpu_torch.scene.library import cornell_box, sphere_on_plane

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    px = lambda n: max(4, n // cpu_scale)
    tables = compile_scene(cornell_box(), device=device)
    scene = scene_arrays(tables)
    light = int(torch.argmax(scene.mat_emission.x))
    record = {}

    # (a) The wavefront against the kernel: their Threefry draws differ, so
    # the bar is on the image means.
    for mode, sampler in (("path", "uniform"), ("nee", "sobol")):
        kw = dict(width=px(256), height=px(256), spp_chunk=32, spp_total=32, max_depth=64,
                  sampler=sampler, mode=mode)
        wave_s, wave = timed(lambda: integrator.render_chunk(scene, make_key(SEED, device), 0, **kw),
                             reps=1, sync=sync)
        kern_s, kern = timed(lambda: megakernel.render_chunk(tables, key_row(SEED), 0, **kw),
                             reps=1, sync=sync)
        mw, mk = wave.double().mean((0, 1)), kern.double().mean((0, 1))
        gap = ((mw - mk).abs() / mk.abs()).max().item()
        same = torch.isclose(wave, kern, rtol=1e-4, atol=1e-4).all(dim=-1).double().mean().item()
        print(f"(a) {mode}/{sampler}, Cornell {kw['width']}x{kw['height']}, 32 spp, max_depth 64: "
              f"wavefront {wave_s:.3f} s, megakernel {kern_s * 1e3:.3f} ms (second call each); "
              f"channel means {[round(v, 5) for v in (mw / 32).tolist()]} against "
              f"{[round(v, 5) for v in (mk / 32).tolist()]}, {gap:.4%} apart; {same:.2%} of pixel "
              f"sums within 1e-4 (the kernel's Sobol draws are the wavefront's, its Threefry "
              f"ones are not)")
        check(bool(torch.isfinite(wave).all()) and wave.shape == kern.shape, "bad wavefront image")
        check(gap <= WAVE_MEAN_REL, f"wavefront and kernel means {gap:.4%} apart")

    # (b) The same code on the card and on the CPU.
    if device != "cpu":
        cpu = scene_arrays(compile_scene(cornell_box(), device="cpu"))
        keep = np.arange(scene.mat_roughness.shape[0]) != light
        for mode in ("path", "nee"):
            kw = dict(width=32, height=32, spp=8, max_depth=4, mode=mode)
            ones = torch.ones((32, 32))
            img_c, _ = diff_grads(cpu, ones, 5, **kw)
            img_g, _ = diff_grads(scene, ones.to(device), 5, **kw)
            agree = torch.isclose(img_g.cpu(), img_c, rtol=1e-4, atol=1e-4).all(dim=-1)
            frac = agree.double().mean().item()
            bar = 0.99 if mode == "path" else 0.90
            _, g_c = diff_grads(cpu, agree.float(), 5, **kw)
            _, g_g = diff_grads(scene, agree.float().to(device), 5, **kw)
            rels = {}
            for f in DIFF_FIELDS:
                sel = np.tile(keep, 3) if f in LIGHT_ROWS else slice(None)
                check(bool(np.isfinite(g_g[f]).all()), f"(b) {f}: gradient not finite")
                rels[f] = float(np.linalg.norm(g_g[f][sel] - g_c[f][sel])
                                / max(np.linalg.norm(g_c[f][sel]), 1e-30))
            light_rel = {f: float(np.linalg.norm(g_g[f] - g_c[f]) / max(np.linalg.norm(g_c[f]), 1e-30))
                         for f in LIGHT_ROWS}
            print(f"(b) {mode}: card against CPU, 32x32x8 spp, max_depth 4: {frac:.4%} of pixels "
                  f"within 1e-4; gradients' relative L2 gap {rels}; with the light's rows "
                  f"{light_rel}")
            check(frac >= bar, f"(b) {mode}: only {frac:.4%} of pixels agree")
            check(all(r <= GRAD_REL for r in rels.values()), f"(b) {mode}: gradients apart {rels}")

    # (c) Finite differences on the card.
    for mode in ("path", "nee"):
        for field, comp, index, eps, rtol, atol, detach in FD_CHECKS:
            index = light if index is None else index
            kw = dict(width=px(64), height=px(64), spp=16, max_depth=4, detach=detach, mode=mode)
            g, fd, smooth, fd_all = fd_check(scene, field, comp, index, eps, 5, **kw)
            print(f"(c) {mode} {field}[{index}]{'.' + comp if comp else ''}, detach {detach}: "
                  f"gradient {g:.6g}, difference {fd:.6g} over {smooth:.2%} of pixels (all pixels: "
                  f"{fd_all:.6g})")
            check(np.isfinite(g) and abs(g - fd) <= atol + rtol * abs(fd),
                  f"(c) {mode} {field}: gradient {g} against difference {fd}")
            check(smooth >= FD_SMOOTH, f"(c) {mode} {field}: {smooth:.2%} of pixels smooth")

    # (d) Inverse-render steps at the demo's and bench.py's shapes.
    start = scene._replace(
        mat_albedo=Vec3(*(torch.clamp(c * 0.4 + 0.3, 0.02, 0.95) for c in scene.mat_albedo)),
        mat_roughness=torch.full_like(scene.mat_roughness, 0.35),
    )
    demo = {}
    for shape, width, spp, depth in DIFF_SHAPES:
        width = px(width)
        kw = dict(width=width, height=width, spp=spp, max_depth=depth)
        with torch.no_grad():
            target = (render_diff(scene, make_key(9, device), **kw) if shape == "demo"
                      else torch.zeros((width, width, 3), device=device))
        for mode in ("nee", "path"):
            prefix = "diff" + ("_nee" if mode == "nee" else "") + ("_demo" if shape == "demo" else "")
            if device == "cuda":
                torch.cuda.reset_peak_memory_stats()
            inv = InverseRenderer(start if shape == "demo" else scene, target,
                                  fields=("mat_albedo", "mat_roughness"), learning_rate=5e-2,
                                  seed=3, key_strategy="dual", mode=mode, **kw)
            draws.LAUNCHES.update(stream_uniforms=0, ray_streams=0)
            first = inv.step()
            sync()
            if device == "cuda":
                # Two renders ("dual"): the streams, the camera's draws, and
                # each bounce's forward and recomputed.
                launched = dict(draws.LAUNCHES)
                want = {DRAWS: 2 * (1 + 2 * depth), RAY_STREAMS: 2}
                print(f"(d) {shape} {mode}: draws kernels launched in one step {launched}")
                check(launched == want, f"(d) {prefix}: draws kernels launched {launched}, "
                      f"not {want}")
                if shape == "demo" and mode == "path":  # the inverse cell's step
                    record["draws_launches_a_step"] = launched
            t0 = time.perf_counter()
            losses = inv.run(DIFF_STEPS)
            sync()
            dt_step = (time.perf_counter() - t0) / DIFF_STEPS
            peak = torch.cuda.max_memory_allocated() / 2**20 if device == "cuda" else 0.0
            grads = {f: torch.cat([c.grad.flatten() for c in v]) if isinstance(v, Vec3) else v.grad
                     for f, v in inv.params.items()}
            loss_fn = make_loss(inv.base_scene, target, mode=mode, **kw)
            with torch.no_grad():
                loss_fn(inv.params, make_key(7, device))
                sync()
                t0 = time.perf_counter()
                fwd = sum(loss_fn(inv.params, fold_in(make_key(7, device), i))
                          for i in range(DIFF_STEPS))
                fwd = float(fwd)
                dt_fwd = (time.perf_counter() - t0) / DIFF_STEPS
            rays = width * width * spp * 2  # "dual": two renders a step
            record.update({
                f"{prefix}_shape": f"{width}x{width}x{spp}spp_d{depth}",
                f"{prefix}_steps_per_s": 1.0 / dt_step,
                f"{prefix}_step_ms": dt_step * 1e3,
                f"{prefix}_fwd_bwd_mrays": rays / dt_step / 1e6,
                f"{prefix}_fwd_mrays": rays / dt_fwd / 1e6,
                f"{prefix}_bwd_over_fwd": dt_step / dt_fwd - 1.0,
                f"{prefix}_peak_mib": peak,
            })
            print(f"(d) {shape} {mode} {width}x{width}x{spp} spp, max_depth {depth}: step "
                  f"{dt_step * 1e3:.1f} ms ({1 / dt_step:.3f} steps/s, {rays / dt_step / 1e6:.3f} "
                  f"Mrays/s fwd+bwd), loss without gradient {dt_fwd * 1e3:.1f} ms "
                  f"({rays / dt_fwd / 1e6:.3f} Mrays/s), bwd/fwd {dt_step / dt_fwd - 1.0:.3f}, peak "
                  f"{peak:.0f} MiB on {card}; losses {first:.6g} then "
                  f"{[round(v, 6) for v in losses]}")
            check(all(np.isfinite(v) for v in [first, fwd, *losses]), f"(d) {prefix}: loss not finite")
            for f, g in grads.items():
                check(bool(torch.isfinite(g).all()) and bool((g != 0).any()),
                      f"(d) {prefix}: {f} gradient not finite or all zero")
            if shape == "demo":
                demo[mode] = inv

    # (e) Recovery on the card (tests/test_diff.py::test_recovers_albedo).
    true = scene_arrays(compile_scene(sphere_on_plane(), device=device))
    with torch.no_grad():
        target = render_diff(true, make_key(9, device), width=24, height=24, spp=192, max_depth=4)
    a = true.mat_albedo
    corrupted = true._replace(mat_albedo=Vec3(a.x * 0.3 + 0.1, a.y * 0.5 + 0.3, a.z * 0.2 + 0.5))
    inv = InverseRenderer(corrupted, target, fields=("mat_albedo",), width=24, height=24, spp=24,
                          max_depth=4, learning_rate=0.1, seed=3, key_strategy="dual")
    t0 = time.perf_counter()
    losses = inv.run(250)
    sync()
    recover_s = time.perf_counter() - t0
    err = lambda alb: sum(float((c[1:3] - t[1:3]).abs().mean()) for c, t in zip(alb, a)) / 3
    err0, err1 = err(corrupted.mat_albedo), err(inv.scene().mat_albedo)
    print(f"(e) sphere_on_plane 24x24, 250 steps in {recover_s:.2f} s: visible albedo error "
          f"{err0:.4f} -> {err1:.4f}; loss {losses[0]:.4g} -> {losses[-1]:.4g}")
    check(err1 < 0.6 * err0, f"(e) albedo not recovered: {err0} -> {err1}")
    record.update(diff_recover_s=recover_s, diff_recover_err=[err0, err1])

    # (f) Where the backward spends its time: one demo step, path mode.
    if device == "cuda":
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            demo["path"].step()
            sync()
            wall = time.perf_counter() - t0
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
        busy = sum(e.self_device_time_total for e in rows)
        check(busy > 0, "(f) the profiler saw no device time")
        rows.sort(key=lambda e: -e.self_device_time_total)
        # The gather's backward: index_add_'s kernels (indexFunc*), and
        # advanced indexing's (indexing_backward*) should one come back.
        backward = sum(e.self_device_time_total for e in rows
                       if "indexFunc" in e.key or "indexing_backward" in e.key) / busy
        print(f"(f) one demo step, path: wall {wall * 1e3:.1f} ms, device busy {busy / 1e3:.1f} ms "
              f"(idle share {1 - busy / 1e3 / (wall * 1e3):.3f}); the gather's backward "
              f"{backward:.2%} of device time")
        for e in rows[:12]:
            print(f"    {e.self_device_time_total / 1e3:9.2f} ms  {e.count:6d}x  {e.key[:100]}")
        record.update(diff_profile_busy_ms=busy / 1e3, diff_profile_wall_ms=wall * 1e3,
                      diff_gather_backward_share=backward)
    return record


# Phase 7. B6: K1 on each rank's shard of a (tiles, samples) mesh.
B6 = "mesh_megakernel path/uniform"
B6_TPU = "cornelis_tpu/parallel/render.py:156"
# The main path's mesh, and the shard timed for its row: rank 3 of (2, 2),
# tile 1 and samples slice 1.
MAIN_MESH = (2, 2)
# A samples axis adds the ranks' partial sums in another float order: the
# bars of tests/test_multiprocess.py:101. The sharded train step's
# gradients against one process on the card, relative L2.
MESH_RTOL, MESH_ATOL = 1e-5, 1e-6
MESH_GRAD_REL = 1e-4
# Seconds a world of ranks may take, its start included; then every rank
# is killed and the phase fails.
RANK_TIMEOUT = 300
# Phase 7f's time budget: a few of the eight chunks of two ranks that
# share the card and stage their collectives through the host.
AGREE_BUDGET_S = 0.05


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(spec: dict, world: int, tmp: str) -> list:
    """Run `world` ranks of this script (`chip_smoke.py --rank R SPEC`) on
    `spec`, each with free coordinator ports of its own, in `tmp`; return
    each rank's record (the JSON of its last "RANK " line). Fails, with the
    rank's output, on the first rank that exits non-zero, and kills every
    rank past RANK_TIMEOUT."""
    spec = dict(spec, ports=[free_port() for _ in range(3)], world=world, tmp=tmp)
    path = os.path.join(tmp, f"spec-{spec['kind']}.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    # Each rank writes to a file of its own: a full pipe would stall a
    # rank, and the collectives every other rank with it.
    logs = [os.path.join(tmp, f"{spec['kind']}{r}.log") for r in range(world)]
    procs = []
    for r, log in enumerate(logs):
        with open(log, "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--rank", str(r), path], cwd=tmp,
                stdout=f, stderr=subprocess.STDOUT))
    records, deadline = [], time.monotonic() + RANK_TIMEOUT
    try:
        for r, p in enumerate(procs):
            try:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                raise AssertionError(f"{spec['kind']}: rank {r} still running after "
                                     f"{RANK_TIMEOUT} s")
            with open(logs[r]) as f:
                out = f.read()
            check(p.returncode == 0, f"{spec['kind']}: rank {r} exited {p.returncode}:\n"
                  f"{out[-6000:]}")
            lines = [ln for ln in out.splitlines() if ln.startswith("RANK ")]
            check(bool(lines), f"{spec['kind']}: rank {r} printed no record:\n{out[-3000:]}")
            records.append(json.loads(lines[-1][5:]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return records


def train_case(device: str, width: int):
    """bench.py's diff step: Cornell against a zero target, albedo and
    roughness, Adam lr 5e-2; (scene, target, params, optimizer)."""
    import torch

    from cornelis_tpu_torch.diff import extract_params
    from cornelis_tpu_torch.diff.inverse import _leaves
    from cornelis_tpu_torch.scene.compile import compile_scene, scene_arrays
    from cornelis_tpu_torch.scene.library import cornell_box

    scene = scene_arrays(compile_scene(cornell_box(), device=device))
    params = extract_params(scene, ("mat_albedo", "mat_roughness"))
    target = torch.zeros((width, width, 3), device=device)
    return scene, target, params, torch.optim.Adam(list(_leaves(params)), lr=5e-2)


def train_grads(mesh, device: str, width: int, spp: int, depth: int):
    """(loss, {name: gradient}) of one sharded step of train_case on `mesh`."""
    from cornelis_tpu_torch.diff import make_sharded_train_step
    from cornelis_tpu_torch.rng import make_key

    scene, target, params, optimizer = train_case(device, width)
    step = make_sharded_train_step(scene, target, mesh, optimizer, width=width, height=width,
                                   spp=spp, max_depth=depth)
    loss = float(step(params, make_key(3, device)))
    grads = {f"{f} {i}": leaf.grad.detach().cpu().numpy().tolist()
             for f, v in params.items() for i, leaf in enumerate(v if isinstance(v, tuple) else (v,))}
    return loss, grads


def rank_timings(mesh, tables, key, opts) -> dict:
    """This rank's launch of one 32-spp chunk on its shard (CUDA events,
    each rank in turn, the others waiting at a barrier, so the card is its
    own) and one assembly of the frame (host clock around a synchronize,
    every rank together)."""
    import torch
    import torch.distributed as dist

    from cornelis_tpu_torch.ops import megakernel
    from cornelis_tpu_torch.parallel.render import assemble, shard
    from cornelis_tpu_torch.utils.timing import event_ms

    k0, k1, root = key
    spp = 32 - 32 % mesh.n_samples
    sh = shard(mesh, opts.width, opts.height, spp, 0, opts.tile_size, "cuda")
    lt = None
    if opts.integrator == "nee":
        from cornelis_tpu_torch.ops.lights import light_table

        lt = light_table(tables)
    kernel_ms = None
    for r in range(dist.get_world_size()):
        dist.barrier()
        if r == dist.get_rank():
            kernel_ms = event_ms(lambda: megakernel.render_rays(
                tables, k0, k1, opts.width, opts.height, sh.spp, sh.sample_start, opts.max_depth,
                root=root, sampler=opts.sampler, mode=opts.integrator, lights=lt,
                index_bits=megakernel.index_bits_for(opts.samples_aa), pixel_ids=sh.pixel_ids), 5)
    part = torch.ones((sh.pixel_ids.shape[0], 3), device="cuda")
    times = []
    for _ in range(5):
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        assemble(mesh, part.clone(), width=opts.width, height=opts.height,
                 tile_size=opts.tile_size)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return dict(kernel_ms=kernel_ms, shard_rays=int(sh.pixel_ids.shape[0] * sh.spp),
                collective_ms=statistics.median(times) * 1e3)


def timed_session(scene, opts):
    """(result, wall seconds) of RenderSession(scene, opts).render(), the
    ranks started together."""
    import torch
    import torch.distributed as dist

    from cornelis_tpu_torch import RenderSession

    session = RenderSession(scene, opts)
    dist.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = session.render()
    torch.cuda.synchronize()
    return result, time.perf_counter() - t0


def rank_main(rank: int, spec_path: str) -> int:
    """One rank of phase 7, sharing the card with the others over gloo
    (NCCL refuses two ranks on one GPU), or alone over NCCL (kind "c").
    Prints its record as one "RANK {json}" line."""
    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, REPO)
    from cornelis_tpu_torch import RenderOptions, cornell_box, sdf_gallery
    from cornelis_tpu_torch.__main__ import main as cli_main
    from cornelis_tpu_torch.ops import megakernel
    from cornelis_tpu_torch.parallel import initialize_distributed, make_mesh
    from cornelis_tpu_torch.rng import key_row
    from cornelis_tpu_torch.scene.compile import compile_scene

    with open(spec_path) as f:
        spec = json.load(f)
    world, tmp, kind = spec["world"], spec["tmp"], spec["kind"]
    coordinator = [f"127.0.0.1:{port}" for port in spec["ports"]]
    rank_flags = ["--num-processes", str(world), "--process-id", str(rank)]
    key = key_row(SEED)
    out = {"rank": rank}
    os.chdir(os.path.join(tmp, f"{kind}{rank}"))

    def cli(name, argv):
        megakernel.LAUNCHES = 0
        t0 = time.perf_counter()
        check(cli_main(argv) == 0, f"{name}: the command line failed")
        out[name] = dict(launches=megakernel.LAUNCHES, wall_s=time.perf_counter() - t0)

    if kind == "a":  # 7b and 7c: Cornell on a world of 4
        gloo = ["--dist-backend", "gloo", *rank_flags]
        cli("cli 2x2", ["--mesh", "2x2", "-o", "mesh.png", "--coordinator", coordinator[0], *gloo])
        cli("cli 4x1", ["--mesh", "4x1", "-o", "tiles.png", "--coordinator", coordinator[1],
                        *gloo])
        initialize_distributed(coordinator[2], world, rank, backend="gloo")
        opts = RenderOptions(output=None, mesh_shape=MAIN_MESH)
        megakernel.LAUNCHES = 0
        result, wall = timed_session(cornell_box(), opts)
        out["session"] = dict(wall_s=wall, launches=megakernel.LAUNCHES, chunks=result.chunks)
        if rank == 0:
            np.save(os.path.join(tmp, "cornell_2x2.npy"), result.image)
        mesh = make_mesh(MAIN_MESH)
        out.update(rank_timings(mesh, compile_scene(cornell_box(), device="cuda"), key, opts))
    elif kind == "b":  # 7c's SDF scene and 7e on a world of 2
        initialize_distributed(coordinator[0], world, rank, backend="gloo")
        opts = RenderOptions(output=None, mesh_shape=(1, 2), samples_aa=32, integrator="nee",
                             sampler="sobol")
        megakernel.LAUNCHES = 0
        result, wall = timed_session(sdf_gallery(), opts)
        out["session"] = dict(wall_s=wall, launches=megakernel.LAUNCHES, chunks=result.chunks,
                              sdf_launches=megakernel.SDF_LAUNCHES)
        if rank == 0:
            np.save(os.path.join(tmp, "sdf_1x2.npy"), result.image)
        out.update(rank_timings(make_mesh((1, 2)), compile_scene(sdf_gallery(), device="cuda"),
                                key, opts))
        for shape in ((2, 1), (1, 2)):
            t0 = time.perf_counter()
            loss, grads = train_grads(make_mesh(shape), "cuda", *DIFF_SHAPES[1][1:])
            torch.cuda.synchronize()
            out[f"train {shape}"] = dict(loss=loss, wall_s=time.perf_counter() - t0)
            if rank == 0:
                with open(os.path.join(tmp, f"grads_{shape[0]}x{shape[1]}.json"), "w") as f:
                    json.dump(grads, f)
    elif kind == "d":  # 7f: the session's rank-agreed branches on a world of 2
        from cornelis_tpu_torch import RenderCommand, RenderSession

        initialize_distributed(coordinator[0], world, rank, backend="gloo")
        calls = []

        def on_progress(progress, status):
            calls.append(status.name)
            return RenderCommand.CONTINUE

        opts = RenderOptions(output=None, mesh_shape=(2, 1), time_budget_s=AGREE_BUDGET_S,
                             checkpoint=os.path.join(tmp, f"ck{rank}.npz"))
        session = RenderSession(cornell_box(), opts)
        megakernel.LAUNCHES = 0
        t0 = time.perf_counter()
        result = session.render(on_progress if rank == 0 else None)
        out["agree"] = dict(status=result.status.name, samples=result.film.sample_count,
                            chunks=result.chunks, launches=megakernel.LAUNCHES, calls=calls,
                            wall_s=time.perf_counter() - t0)
    elif kind == "c":  # 7d: one rank over NCCL
        initialize_distributed(coordinator[0], 1, 0, backend="nccl")
        check(dist.get_backend() == "nccl", f"backend {dist.get_backend()}")
        result, _wall = timed_session(cornell_box(), RenderOptions(output=None, mesh_shape=(1, 1)))
        np.save(os.path.join(tmp, "cornell_nccl.npy"), result.image)
        dist.destroy_process_group()
        cli("cli 1x1 nccl", ["--mesh", "1x1", "-o", "nccl.png", "--coordinator", coordinator[1],
                             *rank_flags])
    if dist.is_initialized():
        dist.destroy_process_group()
    print("RANK " + json.dumps(out), flush=True)
    return 0


def mesh_phase(records: dict, key, card: str) -> dict:
    """Phase 7: (a) K1 through its pixel-id operand against its plain
    version and against the contiguous launch; (b)-(e) the mesh's entry
    points in child ranks that share the card. Returns the {"mesh": ...}
    record."""
    import numpy as np
    import torch

    from cornelis_tpu_torch import RenderOptions, RenderSession, cornell_box, sdf_gallery
    from cornelis_tpu_torch.__main__ import main as cli_main
    from cornelis_tpu_torch.ops import lights, megakernel
    from cornelis_tpu_torch.parallel import make_mesh
    from cornelis_tpu_torch.parallel.mesh import Mesh
    from cornelis_tpu_torch.parallel.render import shard
    from cornelis_tpu_torch.scene.compile import compile_scene
    from cornelis_tpu_torch.utils.png import read_png
    from cornelis_tpu_torch.utils.timing import event_ms

    k0, k1, root = key
    mesh_record = {}
    rank3 = Mesh(MAIN_MESH, 1, 1)
    scenes = {False: compile_scene(cornell_box(), device="cuda"),
              True: compile_scene(sdf_gallery(), device="cuda")}
    rec = records[B6]

    # (a) Every instantiation through the pixel-id operand: each rank's
    # launch of a (2, 2) mesh, against the plain version on the same
    # (pixel, sample) rays, the four shards together held to phase 3's bar
    # on phase 3's chunk (a quarter of its rays alone moves a channel mean
    # by up to 4x as much for one knife-edge ray); and rank 3's shard
    # bitwise against the contiguous launch at the main path's chunk.
    def shard_rays(sh):
        pixel = sh.pixel_ids.long().repeat_interleave(sh.spp)
        sample = sh.sample_start + torch.arange(sh.spp, device="cuda").repeat(
            sh.pixel_ids.shape[0])
        return pixel, sample

    for sdf, tables in scenes.items():
        for mode, sampler in VARIANTS:
            name = kernel_name("megakernel", mode, sampler) + (" sdf" if sdf else "")
            lt = lights.light_table(tables) if mode == "nee" else None
            kw = dict(root=root, sampler=sampler, mode=mode, lights=lt)
            bits = megakernel.index_bits_for(SMOKE["spp"])
            kern, plain = [], []
            for t, s in ((t, s) for t in range(MAIN_MESH[0]) for s in range(MAIN_MESH[1])):
                sh = shard(Mesh(MAIN_MESH, t, s), SMOKE["width"], SMOKE["height"], SMOKE["spp"],
                           0, 32, "cuda")
                args = (tables, k0, k1, SMOKE["width"], SMOKE["height"], sh.spp, sh.sample_start,
                        SMOKE["max_depth"])
                kern.append(megakernel.render_rays(*args, index_bits=bits,
                                                   pixel_ids=sh.pixel_ids, **kw))
                torch.cuda.synchronize()
                pixel, sample = shard_rays(sh)
                plain.append(megakernel.render_rays_reference(
                    *args, "cuda", index_bits=bits, pixel=pixel, sample=sample, **kw))
                ok = agreement(kern[-1], plain[-1])[0]
                check(ok >= RAY_FRACTION, f"(a) {name}, shard ({t}, {s}): only {ok:.4%} of rays "
                      "agree with the plain version")
            frac, err = hold_to_plain(f"(a) {name}, pixel ids of the four ranks of {MAIN_MESH}, "
                                      f"{SMOKE['width']}x{SMOKE['height']}", torch.cat(kern),
                                      torch.cat(plain))
            if (mode, sampler, sdf) == ("path", "uniform", False):
                rec["fracs"].append(frac)
                rec["errs"].append(err)
            bits = megakernel.index_bits_for(256)
            full = megakernel.render_rays(tables, k0, k1, 512, 512, 32, 0, 64, index_bits=bits,
                                          **kw)
            sh = shard(rank3, 512, 512, 32, 0, 32, "cuda")
            part = megakernel.render_rays(tables, k0, k1, 512, 512, sh.spp, sh.sample_start, 64,
                                          index_bits=bits, pixel_ids=sh.pixel_ids, **kw)
            rows = (sh.pixel_ids.long()[:, None] * 32 + sh.sample_start
                    + torch.arange(sh.spp, device="cuda")).reshape(-1)
            same = torch.equal(part, full[rows])
            print(f"(a) {name}: rank 3's {part.shape[0]} rays of the 512x512 32-spp chunk "
                  f"{'bitwise equal to' if same else 'DIFFER from'} the contiguous launch's")
            check(same, f"{name}: a shard's rays differ from the contiguous launch's")
            del full, part

    # B6's row: rank 3's launch at the main path's chunk, on a card of its own.
    tables = scenes[False]
    sh = shard(rank3, 512, 512, 32, 0, 32, "cuda")
    args = (tables, k0, k1, 512, 512, sh.spp, sh.sample_start, 64)
    kw = dict(root=root, index_bits=megakernel.index_bits_for(256))
    n_rays = sh.pixel_ids.shape[0] * sh.spp
    rec["ms"] = event_ms(lambda: megakernel.render_rays(*args, pixel_ids=sh.pixel_ids, **kw), 10)
    pixel, sample = shard_rays(sh)
    plain = lambda: megakernel.render_rays_reference(*args, "cuda", pixel=pixel, sample=sample,
                                                     **kw)
    plain_s, _ = timed(plain, reps=1, warmup=False)
    _, work = counted_work(megakernel, plain)
    rec["plain_ms"] = plain_s * 1e3
    rec["bound_ms"] = megakernel_bound_ms(work, n_rays, tables, "path")
    print(f"{B6}: rank 3 of {MAIN_MESH}, {n_rays} rays: kernel {rec['ms']:.4f} ms, plain "
          f"{rec['plain_ms']:.2f} ms, bound {rec['bound_ms']:.4f} ms on {card}")

    with tempfile.TemporaryDirectory() as tmp:
        for kind, world in (("a", 4), ("b", 2), ("c", 1), ("d", 2)):
            for r in range(world):
                os.makedirs(os.path.join(tmp, f"{kind}{r}"))
        # The single-process references, on this process's card.
        t0 = time.perf_counter()
        single = RenderSession(cornell_box(), RenderOptions(output=None)).render()
        single_wall = time.perf_counter() - t0
        single_png = os.path.join(tmp, "single.png")
        check(cli_main(["-o", single_png]) == 0, "the single-process command line failed")

        # (b) and (c): four ranks, Cornell 512x512, 256 spp, max_depth 64.
        ranks = spawn_ranks({"kind": "a"}, 4, tmp)
        for r in ranks:
            print(f"(b) rank {r['rank']}: --mesh 2x2 {r['cli 2x2']['launches']} launches in "
                  f"{r['cli 2x2']['wall_s']:.3f} s, --mesh 4x1 {r['cli 4x1']['launches']} in "
                  f"{r['cli 4x1']['wall_s']:.3f} s")
        pngs = sorted(os.path.relpath(os.path.join(d, f), tmp) for d, _, fs in os.walk(tmp)
                      for f in fs if f.endswith(".png"))
        check(pngs == ["a0/mesh.png", "a0/tiles.png", "single.png"], f"PNGs written: {pngs}")
        check(read_png(os.path.join(tmp, "a0", "mesh.png")).shape == (512, 512, 3),
              "the 2x2 mesh's PNG is not 512x512")
        with open(single_png, "rb") as f:
            single_bytes = f.read()
        with open(os.path.join(tmp, "a0", "tiles.png"), "rb") as f:
            tiles_same = f.read() == single_bytes
        print(f"(b) --mesh 4x1 PNG {'byte-equal to' if tiles_same else 'DIFFERS from'} the "
              "single-process PNG")
        check(tiles_same, "the tiles-only mesh's PNG differs from the single-process PNG")
        chunks = single.chunks
        for r in ranks:
            check(r["cli 2x2"]["launches"] == r["cli 4x1"]["launches"] == chunks
                  == r["session"]["launches"] == r["session"]["chunks"],
                  f"rank {r['rank']}: launches {r} for {chunks} chunks")
        rec["launches"] = ranks[0]["cli 2x2"]["launches"]
        multi = np.load(os.path.join(tmp, "cornell_2x2.npy"))
        close = np.allclose(multi, single.image, rtol=MESH_RTOL, atol=MESH_ATOL)
        worst = float(np.abs(multi - single.image).max())
        print(f"(c) Cornell on {MAIN_MESH}: session wall per rank "
              f"{[round(r['session']['wall_s'], 4) for r in ranks]} s against "
              f"{single_wall:.4f} s in one process; kernel ms per rank (32-spp chunk on its "
              f"shard) {[round(r['kernel_ms'], 4) for r in ranks]}; assembly ms "
              f"{[round(r['collective_ms'], 3) for r in ranks]}; max |diff| from one "
              f"process {worst:.3g} on {card}")
        check(close, f"(c) Cornell {MAIN_MESH}: not within rtol {MESH_RTOL} / atol {MESH_ATOL}")
        mesh_record["cornell_2x2"] = dict(
            session_wall_s=[r["session"]["wall_s"] for r in ranks], single_wall_s=single_wall,
            kernel_ms=[r["kernel_ms"] for r in ranks], shard_rays=ranks[0]["shard_rays"],
            collective_ms=[r["collective_ms"] for r in ranks], max_abs_diff=worst)
        rec["collective_ms"] = statistics.median(mesh_record["cornell_2x2"]["collective_ms"])

        # (c) sdf-gallery nee/sobol on (1, 2) and (e) the sharded step.
        sdf_opts = dict(output=None, samples_aa=32, integrator="nee", sampler="sobol")
        sdf_single = RenderSession(sdf_gallery(), RenderOptions(**sdf_opts)).render().image
        grads_single = train_grads(make_mesh((1, 1)), "cuda", *DIFF_SHAPES[1][1:])
        ranks = spawn_ranks({"kind": "b"}, 2, tmp)
        multi = np.load(os.path.join(tmp, "sdf_1x2.npy"))
        worst = float(np.abs(multi - sdf_single).max())
        print(f"(c) sdf-gallery nee/sobol 512x512, 32 spp on (1, 2): session wall "
              f"{[round(r['session']['wall_s'], 4) for r in ranks]} s, SDF launches "
              f"{[r['session']['sdf_launches'] for r in ranks]}, kernel ms "
              f"{[round(r['kernel_ms'], 4) for r in ranks]}, assembly ms "
              f"{[round(r['collective_ms'], 3) for r in ranks]}, max |diff| {worst:.3g}")
        check(all(r["session"]["sdf_launches"] == r["session"]["launches"] == 1 for r in ranks),
              "(c) the SDF mesh did not launch the SDF kernel once a rank")
        check(np.allclose(multi, sdf_single, rtol=MESH_RTOL, atol=MESH_ATOL),
              f"(c) sdf-gallery (1, 2): not within rtol {MESH_RTOL} / atol {MESH_ATOL}")
        mesh_record["sdf_1x2"] = dict(
            session_wall_s=[r["session"]["wall_s"] for r in ranks],
            kernel_ms=[r["kernel_ms"] for r in ranks],
            collective_ms=[r["collective_ms"] for r in ranks], max_abs_diff=worst)
        loss_single, g_single = grads_single
        for shape in ((2, 1), (1, 2)):
            with open(os.path.join(tmp, f"grads_{shape[0]}x{shape[1]}.json")) as f:
                g_multi = json.load(f)
            rel = {name: float(np.linalg.norm(np.subtract(g_multi[name], g))
                               / max(np.linalg.norm(g), 1e-30)) for name, g in g_single.items()}
            losses = [r[f"train {shape}"]["loss"] for r in ranks]
            print(f"(e) sharded step on {shape}: losses {losses} against {loss_single:.8g}, "
                  f"step walls {[round(r[f'train {shape}']['wall_s'], 3) for r in ranks]} s; "
                  f"gradients' relative L2 from one process {rel}")
            check(max(rel.values()) <= MESH_GRAD_REL and all(
                abs(v - loss_single) <= 1e-4 * abs(loss_single) for v in losses),
                f"(e) {shape}: gradients {rel} or losses {losses} off")
            mesh_record[f"train_{shape[0]}x{shape[1]}"] = dict(grad_rel=rel, losses=losses)

        # (d) One rank over NCCL: the render and the command line's PNG.
        spawn_ranks({"kind": "c"}, 1, tmp)
        nccl = np.load(os.path.join(tmp, "cornell_nccl.npy"))
        with open(os.path.join(tmp, "c0", "nccl.png"), "rb") as f:
            nccl_png = f.read() == single_bytes
        same = np.array_equal(nccl, single.image)
        print(f"(d) NCCL, a world of one on (1, 1): image {'bitwise equal to' if same else 'DIFFERS from'}"
              f" the render without a mesh; PNG {'byte-equal' if nccl_png else 'DIFFERS'}")
        check(same and nccl_png, "(d) the NCCL (1, 1) render differs from the render without a mesh")

        # (f) The session's branches under a mesh: a time budget and a
        # checkpoint on (2, 1), a progress callback on rank 0 alone. Rank
        # 0's clock decides for both, and only rank 0 writes.
        ranks = spawn_ranks({"kind": "d"}, 2, tmp)
        agreed = [r["agree"] for r in ranks]
        for r in ranks:
            a = r["agree"]
            print(f"(f) rank {r['rank']} on (2, 1), budget {AGREE_BUDGET_S} s and a checkpoint: "
                  f"{a['status']} at {a['samples']} of 256 spp, {a['chunks']} chunks, "
                  f"{a['launches']} launches, {len(a['calls'])} callbacks, {a['wall_s']:.3f} s")
        check(all(a["status"] == "DONE" for a in agreed)
              and agreed[0]["samples"] == agreed[1]["samples"]
              and all(a["launches"] == a["chunks"] == agreed[0]["chunks"] > 0 for a in agreed),
              f"(f) the ranks took different branches: {agreed}")
        check(agreed[0]["calls"][-1:] == ["DONE"] and agreed[1]["calls"] == [],
              f"(f) callbacks {[a['calls'] for a in agreed]}")
        check(os.path.exists(os.path.join(tmp, "ck0.npz"))
              and not os.path.exists(os.path.join(tmp, "ck1.npz")),
              "(f) a rank other than 0 wrote its checkpoint, or rank 0 wrote none")
        mesh_record["agree_2x1"] = agreed
    return mesh_record


# Phase 8. The session's branches at the main path's full width.
# A resumed render against the straight one, and a budgeted render against
# a straight render at its sample count (tests/test_render.py's bars; the
# draws are keyed by (pixel, sample), so bitwise is expected).
RESUME_RTOL, RESUME_ATOL = 1e-4, 1e-5
BUDGET_RTOL, BUDGET_ATOL = 1e-5, 1e-6
# (d)'s budget over a 4096-spp render: tens of its 128 chunks.
BUDGET_SPP, BUDGET_S = 4096, 0.05
# The checkpoint keys of cornelis_tpu/film.py:72-93.
CHECKPOINT_KEYS = ["next_sample", "radiance_sum", "sample_count", "seed"]
# The 128x128 live golden of tests/test_golden_image.py on the port's
# wavefront: 96 spp as two chunks, 8x8 regions against the reference's
# 16384-spp render, regions where a golden pixel clips left out.
LIVE_GOLDEN = os.path.join(REPO, "tests", "golden", "reference_cornell_512.png")
LIVE = dict(width=128, spp=96, grid=8)


def medians_ms(fn, reps=5, sync=None):
    """(median, sorted runs) in ms of `reps` calls of fn(), each between
    two syncs (the card's by default)."""
    import torch

    sync = sync or torch.cuda.synchronize
    runs = []
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        runs.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(runs), sorted(runs)


def _host_steps(linear, tmp: str) -> dict:
    """The film's host steps on one linear frame, each way: {name: fn}."""
    import numpy as np
    import torch

    from cornelis_tpu_torch import native
    from cornelis_tpu_torch.math import color
    from cornelis_tpu_torch.utils import png

    dst = np.zeros_like(linear)
    srgb8 = color.quantize_to_8bit(color.srgb_encode(torch.from_numpy(linear))).numpy()
    path = os.path.join(tmp, f"split{os.getpid()}.png")
    return {
        "accumulate, numpy": lambda: np.add(dst, linear, out=dst),
        "accumulate, native": lambda: native.accumulate(dst, linear),
        "tonemap, torch on the host": lambda: color.quantize_to_8bit(
            color.srgb_encode(torch.from_numpy(linear))).numpy(),
        "tonemap, native": lambda: native.srgb_quantize(linear),
        "write, Python": lambda: png.write_png(path, srgb8),
        "write, native": lambda: native.write_png(path, srgb8),
    }


def cold_split(spec_path: str) -> int:
    """One fresh process of phase 8g: each host step's first call here,
    in the spec's order. Prints its record as one "COLD {json}" line."""
    import numpy as np

    sys.path.insert(0, REPO)
    with open(spec_path) as f:
        spec = json.load(f)
    steps = _host_steps(np.load(spec["linear"]), spec["tmp"])
    out = {}
    for name in spec["order"]:
        t0 = time.perf_counter()
        steps[name]()
        out[name] = (time.perf_counter() - t0) * 1e3
    print("COLD " + json.dumps(out), flush=True)
    return 0


def png_split(radiance_sum, samples: int, tmp: str, card: str) -> dict:
    """Where the PNG wall of a 512x512 frame goes on this host: the copy of
    the device accumulator to the host and the tonemap on the card (median
    of 5), then the film's accumulate, tonemap and PNG write each way, the
    port's numpy or torch step against the native library's, warm (20
    rounds in turns, the order swapped each round) and cold (the first
    call in a fresh process, six processes, the order swapped each)."""
    import numpy as np
    import torch

    from cornelis_tpu_torch.film import Film
    from cornelis_tpu_torch.math import color

    split = {}

    def report(name, runs, how):
        runs = sorted(runs)
        n = len(runs)
        split[f"{name}, {how}"] = dict(median_ms=statistics.median(runs), q1_ms=runs[n // 4],
                                       q3_ms=runs[(3 * n) // 4], runs_ms=runs)
        print(f"(g) {name}, {how}: median {statistics.median(runs):.3f} ms, quartiles "
              f"{runs[n // 4]:.3f}-{runs[(3 * n) // 4]:.3f}, {n} runs on {card}")

    for name, fn in (("copy to host", lambda: radiance_sum.cpu()),
                     ("tonemap, torch on the card + copy", lambda: color.quantize_to_8bit(
                         color.srgb_encode(radiance_sum / samples)).cpu())):
        fn()
        report(name, medians_ms(fn)[1], "warm")
    linear = radiance_sum.cpu().numpy() / samples
    steps = _host_steps(linear, tmp)
    pairs = [tuple(steps)[i:i + 2] for i in range(0, len(steps), 2)]
    runs = {name: [] for name in steps}
    for fn in steps.values():
        fn()
    for r in range(20):
        for pair in pairs:
            for name in pair[::-1] if r % 2 else pair:
                t0 = time.perf_counter()
                steps[name]()
                runs[name].append((time.perf_counter() - t0) * 1e3)
    for name, r in runs.items():
        report(name, r, "warm")

    np.save(os.path.join(tmp, "linear.npy"), linear)
    cold = {name: [] for name in steps}
    for i in range(6):
        order = [name for pair in pairs for name in (pair[::-1] if i % 2 else pair)]
        spec = os.path.join(tmp, "cold.json")
        with open(spec, "w") as f:
            json.dump(dict(linear=os.path.join(tmp, "linear.npy"), tmp=tmp, order=order), f)
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--cold-split", spec],
                              capture_output=True, text=True, timeout=RANK_TIMEOUT)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("COLD ")]
        check(proc.returncode == 0 and lines, f"(g) a cold process failed:\n{proc.stderr[-3000:]}")
        for name, ms in json.loads(lines[-1][5:]).items():
            cold[name].append(ms)
    for name, r in cold.items():
        report(name, r, "cold")

    film = Film(linear.shape[1], linear.shape[0])
    film.add_samples(linear * samples, samples)
    path = os.path.join(tmp, "film.png")
    film.save_png(path)
    report("Film.save_png (as chosen)", medians_ms(lambda: film.save_png(path))[1], "warm")
    return split


def live_golden() -> dict:
    """tests/test_golden_image.py's checks on the port's wavefront
    (integrator.render_chunk) on the card: Cornell at 128x128, 96 spp."""
    import numpy as np
    import torch

    from cornelis_tpu_torch.integrator import render_chunk
    from cornelis_tpu_torch.math.color import srgb_decode
    from cornelis_tpu_torch.rng import make_key
    from cornelis_tpu_torch.scene.compile import compile_scene, scene_arrays
    from cornelis_tpu_torch.scene.library import cornell_box
    from cornelis_tpu_torch.utils.png import read_png

    w, spp, grid = LIVE["width"], LIVE["spp"], LIVE["grid"]
    scene = scene_arrays(compile_scene(cornell_box(), device="cuda"))
    t0 = time.perf_counter()
    ours = sum(render_chunk(scene, make_key(SEED, "cuda"), off, width=w, height=w,
                            spp_chunk=spp // 2, spp_total=spp, max_depth=64)
               for off in (0, spp // 2)).cpu().numpy() / spp
    seconds = time.perf_counter() - t0
    raw8 = read_png(LIVE_GOLDEN)
    gold = srgb_decode(torch.from_numpy(raw8.astype(np.float32) / 255.0)).numpy()
    blocks = lambda img: img.reshape(grid, img.shape[0] // grid, grid, img.shape[1] // grid,
                                     3).mean(axis=(1, 3))
    g = raw8.shape[0] // grid
    clean = (raw8.max(axis=-1) >= 250).reshape(grid, g, grid, g).mean(axis=(1, 3)) < 0.001
    diff = np.abs(blocks(ours) - blocks(gold))
    px = (w // grid) ** 2
    tol = 6.0 * ours.reshape(grid, w // grid, grid, w // grid, 3).std(axis=(1, 3)) / np.sqrt(px) + 0.02
    bad = int((clean[..., None] & (diff >= tol)).sum())
    bias = (blocks(ours) - blocks(gold))[clean].mean(axis=0)

    def walls(img):
        h = img.shape[0]
        left = img[h // 4:3 * h // 4, :h // 8].mean(axis=(0, 1))
        right = img[h // 4:3 * h // 4, -h // 8:].mean(axis=(0, 1))
        return left[1] > max(left[0], left[2]) and right[0] > max(right[1], right[2])

    record = dict(seconds=seconds, clean_regions=int(clean.sum()), bad_regions=bad,
                  max_clean_diff=float(diff[clean].max()), bias=[float(b) for b in bias],
                  walls_ok=bool(walls(ours) and walls(gold)))
    print(f"(h) the live golden on the wavefront, {w}x{w}, {spp} spp, in {seconds:.2f} s: "
          f"{record['clean_regions']} clean regions, {bad} outside 6 sigma + 0.02, max clean "
          f"diff {record['max_clean_diff']:.4f}, bias {[round(b, 4) for b in record['bias']]}")
    check(np.isfinite(ours).all() and record["clean_regions"] >= 20,
          "(h) the golden is clip-dominated or the render not finite")
    check(bad == 0, f"(h) {bad} clean regions off the golden")
    check(bool(np.all(np.abs(bias) < 0.02) and np.all(bias > -0.01)), f"(h) bias {bias}")
    check(record["walls_ok"], "(h) the wall colours are wrong")
    return record


def session_phase(card: str) -> dict:
    """Phase 8: RenderSession at the main path's full width (Cornell
    512x512, 256 spp, max_depth 64, path/uniform) under every new branch,
    each launching K1: (a) a progress callback, against the plain
    session's wall; (b) an abort; (c) a checkpoint and its resume; (d) a
    time budget; (e) the command line with its new flags; (f) the native
    library and the PNG bytes; (g) the PNG wall's split on this host; (h)
    the 128x128 live golden on the wavefront. Returns the {"session": ...}
    record."""
    import numpy as np
    import torch

    from cornelis_tpu_torch import (
        RenderCommand,
        RenderOptions,
        RenderSession,
        RenderStatus,
        cornell_box,
        native,
    )
    from cornelis_tpu_torch.cli import main as cli_main
    from cornelis_tpu_torch.film import Film
    from cornelis_tpu_torch.ops import megakernel
    from cornelis_tpu_torch.utils import png
    from cornelis_tpu_torch.utils.logging import logger

    record = {}
    main_opts = dict(output=None)
    target = 256 // RenderOptions().resolved_spp_chunk()

    def run(session, on_progress=None):
        megakernel.LAUNCHES = 0
        result = session.render(on_progress)
        torch.cuda.synchronize()
        return result, megakernel.LAUNCHES

    plain = RenderSession(cornell_box(), RenderOptions(**main_opts))
    straight, launches = run(plain)
    check(straight.status == RenderStatus.DONE and launches == target == straight.chunks,
          f"the plain session: {straight.status}, {launches} launches")

    # (a) Progress, and its wall against the plain session's, in turns.
    events = []

    def on_progress(p, status):
        events.append((p.chunks_dispatched, p.chunks_completed, status, p.rays_per_second))
        return RenderCommand.CONTINUE

    # The three in turns, the order rotated and reversed each round:
    # "quiet" is the plain session with the logger at WARNING (-q).
    kinds = ("plain", "progress", "quiet")
    walls = {kind: [] for kind in kinds}
    level = logger.level
    for r in range(12):
        order = kinds[r % 3:] + kinds[:r % 3]
        for kind in order[::-1] if r % 2 else order:
            if kind == "progress":
                events.clear()
            logger.setLevel("WARNING" if kind == "quiet" else level)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = run(plain, on_progress if kind == "progress" else None)
            walls[kind].append((time.perf_counter() - t0) * 1e3)
            if kind == "progress":
                result, launches = out
    logger.setLevel(level)
    prev = 0
    for dispatched, done, _status, _rate in events:
        check(done <= dispatched <= target and done >= prev,
              f"(a) progress went wrong: {events}")
        prev = done
    final = events[-1]
    running = [e for e in events if e[2] == RenderStatus.RUNNING]
    check(final[:3] == (target, target, RenderStatus.DONE) and final[3] > 0
          and result.status == RenderStatus.DONE and launches == target,
          f"(a) final progress {final}, {launches} launches")
    lag = [d - c for d, c, _s, _r in running]
    med = {k: statistics.median(v) for k, v in walls.items()}
    quart = {k: f"{sorted(v)[len(v) // 4]:.3f}-{sorted(v)[3 * len(v) // 4]:.3f}"
             for k, v in walls.items()}
    print(f"(a) progress: {len(running)} callbacks while running, completed behind dispatched by "
          f"{lag}, final {final[:2]} of {target}, {final[3] / 1e6:.1f} Mrays/s; session wall "
          f"(no PNG, 12 each in turns), median and quartiles: with the callback "
          f"{med['progress']:.3f} ms {quart['progress']}, plain {med['plain']:.3f} ms "
          f"{quart['plain']}, plain at -q {med['quiet']:.3f} ms {quart['quiet']}; callback over "
          f"plain {med['progress'] / med['plain']:.4f}, plain over -q "
          f"{med['plain'] / med['quiet']:.4f} on {card}")
    record["progress"] = dict(walls_ms=walls, median_ms=med, lag=lag, callbacks=len(events),
                              rays_per_second=final[3])

    # (b) Abort at the first callback.
    result, launches = run(plain, lambda p, s: RenderCommand.ABORT)
    print(f"(b) abort at the first callback: {result.status.name}, {result.film.sample_count} "
          f"spp in the film, {launches} launch")
    check(result.status == RenderStatus.ABORTED and result.film.sample_count == 32
          and launches == 1, "(b) the abort did not stop after one chunk")
    record["abort"] = dict(status=result.status.name, samples=result.film.sample_count,
                           launches=launches)

    with tempfile.TemporaryDirectory() as tmp:
        # (c) Checkpoint: abort after chunk 3, then resume.
        ck = os.path.join(tmp, "film.npz")
        opts = RenderOptions(**main_opts, checkpoint=ck)
        aborted, launches_a = run(RenderSession(cornell_box(), opts), lambda p, s: (
            RenderCommand.ABORT if s == RenderStatus.RUNNING and p.chunks_dispatched >= 3
            else RenderCommand.CONTINUE))
        with np.load(ck) as data:
            keys, at = sorted(data.files), int(data["next_sample"])
        resumed, launches_r = run(RenderSession(cornell_box(), opts))
        diff = float(np.abs(resumed.image - straight.image).max())
        bitwise = bool(np.array_equal(resumed.image, straight.image))
        print(f"(c) checkpoint: aborted {aborted.status.name} after {launches_a} launches at "
              f"sample {at}, npz keys {keys}; resumed {resumed.status.name} with {launches_r} "
              f"launches; image {'bitwise equal to' if bitwise else 'differs from'} the straight "
              f"session's, max |diff| {diff:.3g}")
        check(aborted.status == RenderStatus.ABORTED and launches_a == 3 and at == 96
              and keys == CHECKPOINT_KEYS, "(c) the checkpoint run")
        check(resumed.status == RenderStatus.DONE and launches_r == target - 3
              and resumed.film.sample_count == 256, "(c) the resume")
        check(np.allclose(resumed.image, straight.image, rtol=RESUME_RTOL, atol=RESUME_ATOL),
              f"(c) resumed image off by {diff}")
        record["checkpoint"] = dict(launches=[launches_a, launches_r], max_abs_diff=diff,
                                    bitwise=bitwise)

        # (d) Time budget over a 4096-spp render.
        session = RenderSession(cornell_box(), RenderOptions(**main_opts, samples_aa=BUDGET_SPP,
                                                             time_budget_s=BUDGET_S))
        t0 = time.perf_counter()
        budgeted, launches = run(session)
        wall = time.perf_counter() - t0
        n = budgeted.film.sample_count
        check(budgeted.status == RenderStatus.DONE and n % 32 == 0 and 0 < n < BUDGET_SPP
              and launches == n // 32, f"(d) {budgeted.status}, {n} spp, {launches} launches")
        same_n, _ = run(RenderSession(cornell_box(), RenderOptions(**main_opts, samples_aa=n)))
        diff = float(np.abs(budgeted.image - same_n.image).max())
        print(f"(d) budget {BUDGET_S} s over {BUDGET_SPP} spp: {budgeted.status.name} at {n} spp "
              f"({launches} launches) in {wall:.4f} s; against a straight {n}-spp render max "
              f"|diff| {diff:.3g}")
        check(np.allclose(budgeted.image, same_n.image, rtol=BUDGET_RTOL, atol=BUDGET_ATOL),
              f"(d) budgeted image off by {diff}")
        record["budget"] = dict(samples=n, launches=launches, wall_s=wall, max_abs_diff=diff)

        # (e) The command line with its new flags.
        cli_png, cli_ck, prof = (os.path.join(tmp, f) for f in ("cli.png", "cli.npz", "prof"))
        level = logger.level
        megakernel.LAUNCHES = 0
        try:
            rc = cli_main(["--checkpoint", cli_ck, "--time-budget", str(BUDGET_S),
                           "--standard-srgb", "--profile-dir", prof, "-q", "-o", cli_png])
            quiet = logger.level
        finally:
            logger.setLevel(level)
        launches = megakernel.LAUNCHES
        traces = sorted(os.listdir(prof)) if os.path.isdir(prof) else []
        kernel_events = 0
        for name in traces:
            with open(os.path.join(prof, name)) as f:
                kernel_events += sum(e.get("cat") == "kernel" for e in json.load(f)["traceEvents"])
        film, next_sample, _ = Film.load_checkpoint(cli_ck)
        same = bool(np.array_equal(png.read_png(cli_png), film.to_srgb8(standard_srgb=True)))
        print(f"(e) python -m cornelis_tpu_torch --checkpoint --time-budget {BUDGET_S} "
              f"--standard-srgb --profile-dir -q: rc {rc}, {launches} launches, checkpoint at "
              f"sample {next_sample}, PNG {'equal to' if same else 'DIFFERS from'} the "
              f"checkpoint film's standard-sRGB tonemap, traces {traces} with {kernel_events} "
              f"kernel events")
        check(rc == 0 and launches > 0 and next_sample == film.sample_count == 32 * launches,
              "(e) the command line's render")
        check(quiet == 30 and same and len(traces) == 1, "(e) -q, --standard-srgb or the trace")
        record["cli"] = dict(launches=launches, samples=next_sample, kernel_events=kernel_events)

        # (f) The native library on this host, and the session's PNG.
        lib = native.build()
        session_png = os.path.join(tmp, "session.png")
        result, _ = run(RenderSession(cornell_box(), RenderOptions(output=session_png)))
        with open(session_png, "rb") as f:
            png_bytes = f.read()
        srgb8 = result.film.to_srgb8()
        equal = png_bytes == png.encode_png(srgb8)
        native_equal = png_bytes == native.encode_png(srgb8)
        print(f"(f) native library {'loaded' if native.available() else 'NOT loaded'} from "
              f"{os.path.relpath(lib, REPO) if lib else None}; the session's PNG "
              f"{'byte-equal to' if equal else 'DIFFERS from'} the Python encoder's and "
              f"{'byte-equal to' if native_equal else 'DIFFERS from'} the native encoder's "
              "on the same uint8 image")
        check(native.available() and lib is not None, "(f) the native library did not load")
        check(equal and native_equal, "(f) the session's PNG differs from an encoder's bytes")

        # (g) The PNG wall's split on this host.
        record["png_split"] = png_split(
            torch.from_numpy(straight.film.radiance_sum).cuda(), 256, tmp, card)
        with_png = RenderSession(cornell_box(), RenderOptions(output=session_png))
        run(with_png)
        record["wall_ms"] = {"PNG written": medians_ms(lambda: run(with_png))[0],
                             "no PNG": medians_ms(lambda: run(plain))[0]}
        print(f"(g) session wall, median of 5: PNG written {record['wall_ms']['PNG written']:.3f} "
              f"ms, no PNG {record['wall_ms']['no PNG']:.3f} ms on {card}")

    # (h) The live golden on the wavefront.
    record["live_golden"] = live_golden()
    return record


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from cornelis_tpu_torch import RenderOptions, RenderSession, RenderStatus, SceneDescription
    from cornelis_tpu_torch.__main__ import main as cli_main
    from cornelis_tpu_torch.ops import build, lights, megakernel, warm
    from cornelis_tpu_torch.ops.dynamic import render_chunk_dynamic
    from cornelis_tpu_torch.ops.megakernel import render_chunk
    from cornelis_tpu_torch.probes import bf16 as bf16_probe
    from cornelis_tpu_torch.probes import scan_designs, scene_table
    from cornelis_tpu_torch.rng import key_row
    from cornelis_tpu_torch.scene.compile import compile_scene
    from cornelis_tpu_torch.scene.library import (
        cornell_box,
        cornell_panel,
        sdf_gallery,
        sdf_gallery_transformed,
        sphere_grid,
    )
    from cornelis_tpu_torch.utils.png import read_png
    from cornelis_tpu_torch.utils.timing import card_line, event_ms, kernel_ms

    t_start = time.perf_counter()
    t_phase = [t_start]

    def phase_done():
        now = time.perf_counter()
        print(f"   ({now - t_phase[0]:.1f} s)")
        t_phase[0] = now

    phase("1. card and tools")
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    print(nvcc_release())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase("2. build (one nvcc per source, in parallel)")
    t0 = time.perf_counter()
    # K4's "disc" designs build beside the libraries.
    with ThreadPoolExecutor(len(QUAD)) as pool:
        disc_builds = {name: pool.submit(scan_designs.build_design, (dtype, "disc"))
                       for dtype, name in QUAD.items()}
        built = build.build_all(force=True)
        disc_built = {name: f.result() for name, f in disc_builds.items()}
    print(f"built {len(built)} libraries and K4's 2 disc designs in {time.perf_counter() - t0:.1f} s: "
          + ", ".join(f"{os.path.relpath(so, REPO)} ({s:.1f} s)" for so, s in built.values()))
    ptxas = ptxas_report(build.BUILD_LOGS)
    listings = sass_listings(built)
    for name, (regs, stack, spill) in sorted(ptxas.items()):
        print(f"  {name}: {regs} registers, {stack} B stack, {spill} B spilled"
              + (f", {len(listings[name])} SASS instructions" if name in listings else ""))
    check(len(ptxas) == 30, f"expected 30 kernel instantiations, ptxas reported {sorted(ptxas)}")
    check("-fmad=false" in build.EXTRA_FLAGS["probes"], "the probes library lost -fmad=false")
    # Checked at the end, so that a run that fails here still reports the rest.
    spilled = {name: spill for name, (_r, _s, spill) in ptxas.items()
               if name.startswith(("megakernel", STAGE, BAKED, DYNAMIC, "quad_probe",
                                   DRAWS, RAY_STREAMS)) and spill != 0}
    print(f"megakernel, probe and draws kernels that spill: {spilled or 'none'}")
    scan_shapes = {BAKED: scene_table.launch_shape("baked"),
                   DYNAMIC: scene_table.launch_shape("dynamic")}
    per_sphere = sass_per_sphere(listings, scan_shapes)
    for name, shape in scan_shapes.items():
        print(f"  {name}: launch {shape} over {scene_table.SHAPE[0] * scene_table.SHAPE[1]} "
              f"elements; {per_sphere.get(name, 'uncounted (no cuobjdump)')} SASS instructions a ray spends "
              "on a sphere")
    # K4 is straight-line code: its SASS over the (element, object) steps
    # of one thread.
    quad_shapes = {name: bf16_probe.launch_shape(getattr(torch, dtype)) for dtype, name in QUAD.items()}
    per_step = {name: len(listings[name]) / (bf16_probe.OBJECTS * shape["elements_per_thread"])
                for name, shape in quad_shapes.items() if name in listings}
    for name, shape in quad_shapes.items():
        print(f"  {name}: launch {shape} over {bf16_probe.SHAPE[0] * bf16_probe.SHAPE[1]} elements; "
              f"{per_step.get(name, 'uncounted (no cuobjdump)')} SASS instructions an (element, object)")
    # The disc design is held to its plain version in phase 3; here its
    # SASS to the production kernel's, so that what phase 3 shows of the
    # chain holds for the kernel the probe launches.
    root_difference = {}
    for dtype, name in QUAD.items():
        info = disc_built[name]
        check(info["spill_bytes"] == 0, f"{name}'s disc design spills {info['spill_bytes']} B")
        if listings:
            root_difference[name] = scan_designs.quad_root_difference(
                scan_designs.sass_opcodes(built["probes"][0], scan_designs.quad_kernel(dtype)),
                info["opcodes"], bf16_probe.OBJECTS * quad_shapes[name]["elements_per_thread"])
            print(f"  {name}: its disc design, {info['registers']} registers, {info['sass']} SASS "
                  f"instructions; apart from the kernel's but for the root: "
                  f"{root_difference[name] or 'nothing'}")
    check(not any(root_difference.values()),
          f"K4's SASS differs from its disc design's beyond the root: {root_difference}")

    # Every kernel of the report: {name: dict of the kernels line}.
    records = {}

    def record(name, source, replaces, instantiation, tol=RAY_TOL):
        records[name] = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "registers": ptxas[instantiation][0], "spill_bytes": ptxas[instantiation][2],
            "launches": 0, "fracs": [], "errs": [],
            "ms": None, "plain_ms": None, "bound_ms": None, "bound_by": "operations",
            "library_ms": None, "tol": tol,
        }

    for mode, sampler in VARIANTS:
        src = CSRC + ("megakernel_nee.cu" if mode == "nee" else "megakernel.cu")
        inst = kernel_name("megakernel", mode, sampler)
        record(inst, src, K1_TPU, inst)
        record(kernel_name("dynamic", mode, sampler), src, K3_TPU,
               inst if mode == "path" else kernel_name("megakernel_dyn", mode, sampler))
        record(inst + " sdf", src, K1_TPU, inst + " sdf")
    record(TABLE, CSRC + "lights.cu", K3_TPU, TABLE, tol=0.0)
    record(ZERO, CSRC + "warm.cu", K2_TPU, ZERO, tol=0.0)
    record(BAKED, CSRC + "probes.cu", K5_TPU, f"{BAKED} {scene_table.DEFAULT_N}", tol=F32_ULP)
    record(DYNAMIC, CSRC + "probes.cu", K6_TPU, DYNAMIC, tol=F32_ULP)
    for name, shape in scan_shapes.items():
        records[name].update(sass_per_sphere=per_sphere.get(name), launch={
            key: shape[key] for key in ("block", "blocks", "rays_per_thread")})
    for name, shape in quad_shapes.items():
        record(name, CSRC + "probes.cu", K4_TPU, name, tol=0.0)
        records[name].update(sass_per_step=per_step.get(name), launch=shape,
                             sass_root_only=name in root_difference and not root_difference[name])
    record(B6, CSRC + "megakernel.cu", B6_TPU, kernel_name("megakernel", "path", "uniform") + " ids")

    # K2's main path: the warm-up before anything is timed.
    warm.LAUNCHES = 0
    warmed = warm.warm_kernels()
    records[ZERO]["launches"] = warm.LAUNCHES
    zeros = warmed["zeros"]
    check(zeros.shape == (8, 128) and zeros.dtype == torch.float32
          and torch.equal(zeros, torch.zeros((8, 128), device="cuda")), "the zero fill is not zeros")
    records[ZERO]["fracs"].append(1.0)
    records[ZERO]["errs"].append(zeros.abs().max().item())
    print(f"warm_kernels(): load of every library and megakernel instantiation "
          f"{warmed['load_s'] * 1e3:.3f} ms, first zero fill {warmed['first_launch_s'] * 1e3:.3f} ms, "
          "output equal to torch.zeros((8, 128))")

    # Does the forced load take the load out of each instantiation's first
    # launch? The light-table kernel was not forced: its first launch shows
    # what a lazy load costs.
    k0, k1, root = key_row(SEED)
    tiny = {False: compile_scene(cornell_box(), device="cuda"),
            True: compile_scene(sdf_gallery(), device="cuda")}
    for sdf in (False, True):
        for mode, sampler in VARIANTS:
            lt = lights.light_table(tiny[sdf]) if mode == "nee" else None
            launch_s = []
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                megakernel.render_rays(tiny[sdf], k0, k1, 8, 8, 1, 0, 1, root=root,
                                       sampler=sampler, mode=mode, lights=lt)
                torch.cuda.synchronize()
                launch_s.append(time.perf_counter() - t0)
            name = kernel_name("megakernel", mode, sampler) + (" sdf" if sdf else "")
            print(f"  {name}, 8x8x1 at depth 1: first launch {launch_s[0] * 1e3:.3f} ms, "
                  f"second {launch_s[1] * 1e3:.3f} ms")
    for sampler in ("uniform", "sobol"):
        launch_s = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            megakernel.render_rays(tiny[False], k0, k1, 8, 8, 1, 0, 1, root=root, sampler=sampler,
                                   mode="nee", dynamic_table=True)
            torch.cuda.synchronize()
            launch_s.append(time.perf_counter() - t0)
        print(f"  {kernel_name('megakernel_dyn', 'nee', sampler)}, 8x8x1 at depth 1: first launch "
              f"{launch_s[0] * 1e3:.3f} ms, second {launch_s[1] * 1e3:.3f} ms")
    table_s = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lights.light_table_dyn(tiny[False])
        torch.cuda.synchronize()
        table_s.append(time.perf_counter() - t0)
    print(f"  {TABLE} (not forced): first launch {table_s[0] * 1e3:.3f} ms, "
          f"second {table_s[1] * 1e3:.3f} ms")
    phase_done()

    smoke_bits = megakernel.index_bits_for(SMOKE["spp"])

    def variant_args(tables, mode, sampler, dynamic, bits, plain=False):
        """render_rays's keywords for a row; dynamic nee: the kernel builds
        K3's table (`plain`: light_table_dyn_reference's table, for the
        plain version and for K1's nee instantiation)."""
        kw = dict(root=root, sampler=sampler, mode=mode, index_bits=bits, lights=None)
        if mode == "nee" and dynamic and not plain:
            kw["dynamic_table"] = True
        elif mode == "nee":
            kw["lights"] = (lights.light_table_dyn_reference if dynamic else lights.light_table)(tables)
        return kw

    def hold_bitwise(name, kern, want, nan_equal=False):
        """Check a kernel's output bit for bit against `want` (with
        `nan_equal`, any NaN matches any NaN); the share of equal values."""
        torch.cuda.synchronize()
        bits = torch.int16 if kern.dtype == torch.bfloat16 else torch.int32
        same = kern.view(bits) == want.contiguous().view(bits)
        nans = ""
        if nan_equal:
            both = torch.isnan(kern) & torch.isnan(want)
            nans = f", {int(both.sum())} NaN in both, {int((both & ~same).sum())} of other bits"
            same = same | both
        frac = same.double().mean().item()
        print(f"{name}: {frac:.4%} bitwise equal ({same.numel()} values{nans})")
        check(bool(same.all()), f"{name}: not bit for bit equal")
        return frac

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
                plain_kw = variant_args(tables, mode, sampler, dynamic, smoke_bits, plain=True)
                plain = megakernel.render_rays_reference(*args, device="cuda", **plain_kw)
                frac, err = hold_to_plain(f"{name} on {scene_name}", kern, plain)
                records[name]["fracs"].append(frac)
                records[name]["errs"].append(err)
                if dynamic and mode == "nee":
                    hold_bitwise(f"  {name} on {scene_name} against K1's nee fed the plain table",
                                 kern, megakernel.render_rays(*args, **plain_kw))

    # The table kernel bit for bit its plain version, on the scenes' tables
    # and at the edges of the emission pick (the direct pick and the masked
    # sum that an infinite or NaN emission forces; ids off the table).
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from torch_light_tables import table_cases

    for table_name, tables in table_cases("cuda"):
        kern_t = lights.light_table_dyn(tables)
        plain_t = lights.light_table_dyn_reference(tables)
        fracs = [hold_bitwise(f"{TABLE} on {table_name}, {part}", got, want)
                 for part, got, want in zip(("rows", "clamp"), kern_t, plain_t)]
        records[TABLE]["fracs"].append(min(fracs))
        records[TABLE]["errs"].append(0.0)

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

    # K1's SDF instantiations on the implicit-surface scenes.
    for scene_name, desc in (("sdf_gallery", sdf_gallery()),
                             ("sdf_transformed", sdf_gallery_transformed())):
        tables = compile_scene(desc, device="cuda")
        check(tables.sdfs.shape[0] == 3, f"{scene_name} has {tables.sdfs.shape[0]} SDF rows")
        args = (tables, k0, k1, SMOKE["width"], SMOKE["height"], SMOKE["spp"], 0,
                SMOKE["max_depth"])
        for mode, sampler in VARIANTS:
            name = kernel_name("megakernel", mode, sampler) + " sdf"
            kw = variant_args(tables, mode, sampler, False, smoke_bits)
            before = megakernel.SDF_LAUNCHES
            kern = megakernel.render_rays(*args, **kw)
            torch.cuda.synchronize()
            check(megakernel.SDF_LAUNCHES == before + 1, f"{name}: not an SDF launch")
            plain = megakernel.render_rays_reference(*args, device="cuda", **kw)
            frac, err = hold_to_plain(f"{name} on {scene_name}", kern, plain)
            records[name]["fracs"].append(frac)
            records[name]["errs"].append(err)

    # Tables past the shared-memory cap: sphere_grid(3000)'s are staged in
    # device memory by stage_tables, sphere_grid(2200)'s in 56 KB of shared
    # memory (above the 48 KB default); path/uniform at 8x8, 2 spp, depth 3.
    for n_grid in (2200, 3000):
        tables = compile_scene(sphere_grid(n_grid), device="cuda")
        args = (tables, k0, k1, 8, 8, 2, 0, 3)
        kern = megakernel.render_rays(*args, root=root)
        torch.cuda.synchronize()
        plain = megakernel.render_rays_reference(*args, "cuda", root=root)
        frac, err = hold_to_plain(f"megakernel path/uniform on sphere_grid({n_grid})", kern, plain)
        records[kernel_name("megakernel", "path", "uniform")]["fracs"].append(frac)
        records[kernel_name("megakernel", "path", "uniform")]["errs"].append(err)

    # K2 and the probes at their JAX shapes against their plain versions.
    zeros = warm.zero_block("cuda")
    torch.cuda.synchronize()
    check(torch.equal(zeros, warm.zero_block_reference("cuda")), "zero fill != torch.zeros")
    records[ZERO]["fracs"].append(1.0)
    records[ZERO]["errs"].append(zeros.abs().max().item())

    def hold_probe(name, kern, plain, rtol):
        torch.cuda.synchronize()
        k, p = kern.float(), plain.float()
        fin = torch.isfinite(p)
        check(torch.equal(torch.isfinite(k), fin), f"{name}: finite entries differ")
        close = torch.isclose(k, p, rtol=rtol, atol=0.0)
        err = (k[fin] - p[fin]).abs().max().item() if bool(fin.any()) else 0.0
        frac = close.double().mean().item()
        print(f"{name}: {frac:.4%} within rtol {rtol:g}, {(k == p).double().mean().item():.4%} "
              f"equal, max |diff| {err:.3g}, {fin.double().mean().item():.2%} finite")
        check(bool(close.all()), f"{name}: not within rtol {rtol:g} of its plain version")
        records[name]["fracs"].append(frac)
        records[name]["errs"].append(err)

    for o in (scene_table.probe_input("cuda"), scene_table.special_input("cuda")):
        for n_obj in scene_table.BAKED_COUNTS:
            tab = scene_table.table(n_obj, "cuda")
            hold_probe(BAKED, scene_table.scan_baked(o, n_obj),
                       scene_table.scan_baked_reference(o, n_obj), F32_ULP)
            hold_probe(DYNAMIC, scene_table.scan_dynamic(o, tab),
                       scene_table.scan_dynamic_reference(o, tab), F32_ULP)
    # K4's output is +0 on every input (probes/bf16.py), so its own check
    # alone cannot fail a kernel that stores 0; the disc design, the same
    # source but for quad_root (its SASS so checked in phase 2), sums the
    # chain's disc and is held bit for bit to that chain's plain version
    # (a NaN of the special input's NaN lanes to any NaN).
    for dtype, name in QUAD.items():
        disc_run, _shape = scan_designs.quad_runner(disc_built[name])
        for label, make in (("probe input", bf16_probe.probe_input),
                            ("special input", bf16_probe.special_input)):
            x = make(getattr(torch, dtype), "cuda")
            records[name]["fracs"].append(hold_bitwise(
                f"{name} on its {label}", bf16_probe.quad_probe(x), bf16_probe.quad_reference(x)))
            records[name]["errs"].append(0.0)
            hold_bitwise(f"{name}'s disc design on its {label}", disc_run(x),
                         scan_designs.disc_sum_reference(x), nan_equal=True)
        records[name]["disc_bitwise"] = True
    phase_done()

    phase("4. the slices at 512x512, 256 spp, max_depth 64 (counts zeroed before each)")

    def zero_counts():
        megakernel.LAUNCHES = 0
        megakernel.SDF_LAUNCHES = 0
        megakernel.DYNAMIC_TABLE_LAUNCHES = 0
        lights.LAUNCHES = 0
        scene_table.LAUNCHES.update(baked=0, dynamic=0)
        bf16_probe.LAUNCHES.update(float32=0, bfloat16=0)

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

        # The implicit-surface scene through the session, in every variant.
        for mode, sampler in VARIANTS:
            png = os.path.join(tmp, f"sdf_{mode}_{sampler}.png")
            opts = RenderOptions(output=png, device="cuda", integrator=mode, sampler=sampler)
            session = RenderSession(sdf_gallery(), opts)
            zero_counts()
            t0 = time.perf_counter()
            result = session.render()
            torch.cuda.synchronize()
            render_s = time.perf_counter() - t0
            launches, sdf_launches = megakernel.LAUNCHES, megakernel.SDF_LAUNCHES
            name = kernel_name("megakernel", mode, sampler) + " sdf"
            records[name]["launches"] = sdf_launches
            chunks = -(-opts.samples_aa // opts.resolved_spp_chunk())
            print(f"{name} sdf_gallery: {opts.width}x{opts.height}, {opts.samples_aa} spp, "
                  f"max_depth {opts.max_depth}: {result.status.name} in {render_s:.3f} s, "
                  f"{launches} launches ({sdf_launches} SDF) for {chunks} chunks")
            check(result.status == RenderStatus.DONE, f"status {result.status}")
            check(launches == sdf_launches == chunks == result.chunks,
                  f"{launches} launches, {sdf_launches} SDF, for {chunks} chunks")
            img = result.image
            check(img.shape == (512, 512, 3) and bool((img >= 0).all()) and img.mean() > 0,
                  "bad image")
            check(bool(torch.isfinite(torch.from_numpy(img)).all()), "image not finite")
            check(read_png(png).shape == (512, 512, 3), "PNG not written")
            quads = img.reshape(2, 256, 2, 256, 3).mean(axis=(1, 3))
            print(f"  image mean {[round(v, 4) for v in img.mean((0, 1)).tolist()]}; quadrant "
                  f"means (top left, top right, bottom left, bottom right) "
                  f"{[[round(v, 4) for v in q] for q in quads.reshape(4, 3).tolist()]}")

        cli_png = os.path.join(tmp, "cli_sdf.png")
        zero_counts()
        rc = cli_main(["--scene", "sdf-gallery", "--width", "128", "--height", "128", "--spp", "16",
                       "-o", cli_png])
        img = read_png(cli_png)
        print(f"python -m cornelis_tpu_torch --scene sdf-gallery at 128x128, 16 spp: rc {rc}, "
              f"{megakernel.SDF_LAUNCHES} SDF launch, PNG {img.shape}")
        check(rc == 0 and img.shape == (128, 128, 3) and img.max() > 0, "SDF CLI render failed")
        check(megakernel.LAUNCHES == megakernel.SDF_LAUNCHES == 1, "the CLI made no SDF launch")

    # The probes' command lines: the probe path of K5 and K6, and of K4.
    zero_counts()
    check(scene_table.main([]) == 0, "the scene-table probe failed")
    records[BAKED]["launches"] = scene_table.LAUNCHES["baked"]
    records[DYNAMIC]["launches"] = scene_table.LAUNCHES["dynamic"]
    zero_counts()
    check(bf16_probe.main() == 0, "the bf16 probe failed")
    for dtype, name in QUAD.items():
        records[name]["launches"] = bf16_probe.LAUNCHES[dtype]

    # The dynamic-scene render: 8 megakernel launches and no table launch
    # for a 512x512, 256-spp frame; in mode nee every launch builds K3's
    # table itself, and the frame is bit for bit render_chunk's fed
    # light_table_dyn_reference's table (K1's nee instantiation, the
    # parent's way). Then sphere_grid(512)'s frame and one chunk of
    # sphere_grid(2200), whose nee tables lie past the shared-memory cap.
    opts = RenderOptions()
    spp_chunk = opts.resolved_spp_chunk()
    tables = compile_scene(cornell_box(), device="cuda")
    dyn_cases = [("cornell_box", tables, mode, sampler, 512, opts.samples_aa)
                 for mode, sampler in VARIANTS]
    dyn_cases += [("sphere_grid(512)", compile_scene(sphere_grid(512), device="cuda"), "nee",
                   "sobol", 512, opts.samples_aa),
                  ("sphere_grid(2200)", compile_scene(sphere_grid(2200), device="cuda"), "nee",
                   "sobol", 128, spp_chunk)]
    for scene_name, dyn_tables, mode, sampler, size, spp in dyn_cases:
        name = kernel_name("dynamic", mode, sampler)
        kw = dict(width=size, height=size, spp_chunk=spp_chunk, spp_total=opts.samples_aa,
                  max_depth=opts.max_depth, sampler=sampler, mode=mode)
        offsets = range(0, spp, spp_chunk)
        zero_counts()
        t0 = time.perf_counter()
        frame = sum(render_chunk_dynamic(dyn_tables, (k0, k1, root), o, **kw) for o in offsets) / spp
        torch.cuda.synchronize()
        render_s = time.perf_counter() - t0
        chunks = len(offsets)
        launches, table_launches = megakernel.LAUNCHES, lights.LAUNCHES
        built = megakernel.DYNAMIC_TABLE_LAUNCHES
        if scene_name == "cornell_box":
            records[name]["launches"] = launches
        print(f"render_chunk_dynamic {mode}/{sampler} on {scene_name}, {size}x{size}, {spp} spp: "
              f"{chunks} chunks in {render_s:.3f} s, {launches} launches ({built} building the "
              f"table), {table_launches} table launches, frame mean "
              f"{[round(v, 4) for v in frame.mean((0, 1)).tolist()]}")
        check(launches == chunks and table_launches == 0
              and built == (chunks if mode == "nee" else 0),
              f"{launches} launches, {built} building the table and {table_launches} table "
              f"launches for {chunks} chunks")
        check(bool(torch.isfinite(frame).all()) and bool((frame >= 0).all()), "bad dynamic frame")
        if mode == "nee":
            fed = dict(kw, lights=lights.light_table_dyn_reference(dyn_tables))
            want = sum(render_chunk(dyn_tables, (k0, k1, root), o, **fed) for o in offsets) / spp
            hold_bitwise(f"  the frame against render_chunk fed the plain table", frame, want)
        del frame

    # The same through the session, an animation's path: a nee session on
    # sphere_grid(512) launches K1 until its first update_scene, and K3
    # from then on, one launch a chunk and no table launch; the edited
    # frame is bit for bit render_chunk's fed the plain table of the
    # session's edited tables.
    session = RenderSession(sphere_grid(512), RenderOptions(output=None, device="cuda",
                                                            integrator="nee", sampler="sobol"))
    chunks = len(range(0, opts.samples_aa, spp_chunk))
    zero_counts()
    session.render()
    check((megakernel.LAUNCHES, megakernel.DYNAMIC_TABLE_LAUNCHES) == (chunks, 0),
          f"a session never updated: {megakernel.LAUNCHES} launches, "
          f"{megakernel.DYNAMIC_TABLE_LAUNCHES} of K3, for {chunks} chunks")
    edit = json.loads(json.dumps(sphere_grid(512).to_dict()))
    for sphere in edit["spheres"][:512]:
        sphere["center"][1] += 0.5
    edit["materials"][2]["emissive"] = [20.0, 20.0, 20.0]
    zero_counts()
    t0 = time.perf_counter()
    session.update_scene(SceneDescription.from_dict(edit))
    image = session.render().image
    render_s = time.perf_counter() - t0
    print(f"an updated sphere_grid(512) session, 512x512, {opts.samples_aa} spp: {render_s:.3f} s, "
          f"{megakernel.LAUNCHES} launches ({megakernel.DYNAMIC_TABLE_LAUNCHES} of K3), "
          f"{lights.LAUNCHES} table launches")
    check((megakernel.LAUNCHES, megakernel.DYNAMIC_TABLE_LAUNCHES, lights.LAUNCHES)
          == (chunks, chunks, 0), "an updated session launches K3 once a chunk, nothing else")
    kw = dict(width=512, height=512, spp_chunk=spp_chunk, spp_total=opts.samples_aa,
              max_depth=opts.max_depth, sampler="sobol", mode="nee",
              lights=lights.light_table_dyn_reference(session.tables))
    want = sum(render_chunk(session.tables, session.key, o, **kw)
               for o in range(0, opts.samples_aa, spp_chunk)) / opts.samples_aa
    hold_bitwise("  the updated session's frame against render_chunk fed the plain table",
                 torch.from_numpy(image).cuda(), want)
    del session, image, want

    # The table kernel's own entry point: light_table_dyn on Cornell.
    zero_counts()
    lights.light_table_dyn(tables)
    torch.cuda.synchronize()
    records[TABLE]["launches"] = lights.LAUNCHES
    print(f"{TABLE} on cornell_box: {lights.LAUNCHES} launch")
    phase_done()

    phase("5. times and agreement at the main path's chunk (512x512, 32 spp; kernel median "
          "of 3, plain one run)")
    rays = 512 * 512 * 32
    bits = megakernel.index_bits_for(opts.samples_aa)
    scenes5 = {False: tables, True: compile_scene(sdf_gallery(), device="cuda")}
    strided = torch.arange(0, rays, SDF_STRIDE, device="cuda")
    for dynamic, sdf in ((False, False), (True, False), (False, True)):
        scene5 = scenes5[sdf]
        for mode, sampler in VARIANTS:
            name = (kernel_name("dynamic" if dynamic else "megakernel", mode, sampler)
                    + (" sdf" if sdf else ""))
            args = (scene5, k0, k1, 512, 512, 32)

            def kernel(offset):
                kw = variant_args(scene5, mode, sampler, dynamic, bits)
                return megakernel.render_rays(*args, offset, 64, **kw)

            def plain(offset):
                # K3's table is rebuilt per chunk, as the kernel builds it.
                kw = variant_args(scene5, mode, sampler, dynamic, bits, plain=True)
                if sdf:  # the strided rays, each traced as its (pixel, sample)
                    kw.update(pixel=strided // 32, sample=offset + strided % 32)
                return megakernel.render_rays_reference(*args, offset, 64, "cuda", **kw)

            kernel_s, kern = timed(lambda: kernel(0))
            plain_s, ref = timed(lambda: plain(0), reps=1, warmup=False)
            _, work = counted_work(megakernel, lambda: plain(0))
            n_plain = ref.shape[0]
            rec = records[name]
            rec["ms"], rec["plain_ms"], rec["plain_rays"] = kernel_s * 1e3, plain_s * 1e3, n_plain
            rec["bound_ms"] = megakernel_bound_ms(work, rays, scene5, mode, rays / n_plain)
            print(f"{name}: kernel {rays / kernel_s / 1e6:.1f} Mrays/s ({kernel_s * 1e3:.2f} ms), "
                  f"plain on {n_plain} rays {n_plain / plain_s / 1e6:.2f} Mrays/s "
                  f"({plain_s * 1e3:.2f} ms), bound {rec['bound_ms']:.4f} ms on {card}; work on "
                  f"{n_plain} rays {work}")
            for offset in (0, 224):
                if offset:
                    kern, ref = kernel(offset), plain(offset)
                frac, err = hold_to_plain(
                    f"  {name} 512x512, 32 spp, offset {offset}"
                    + (f", every {SDF_STRIDE}th ray" if sdf else ""),
                    kern[strided] if sdf else kern, ref)
                rec["fracs"].append(frac)
                rec["errs"].append(err)
                if dynamic and mode == "nee":
                    fed = variant_args(scene5, mode, sampler, dynamic, bits, plain=True)
                    hold_bitwise(f"  {name} offset {offset} against K1's nee fed the plain table",
                                 kern, megakernel.render_rays(*args, offset, 64, **fed))
                del kern, ref

    # The table kernel's own entry: its device time by the profiler, the
    # host clock around a call and a synchronize, and the plain version's,
    # on Cornell (its row) and on sphere_grid(512).
    for scene_name, desc in (("cornell_box", cornell_box()), ("sphere_grid(512)", sphere_grid(512))):
        tables = compile_scene(desc, device="cuda")
        device_ms, kept = kernel_ms(lambda: lights.light_table_dyn(tables), 32, TABLE)
        kernel_s, _ = timed(lambda: lights.light_table_dyn(tables))
        plain_s, _ = timed(lambda: lights.light_table_dyn_reference(tables))
        # About 30 operations per row; reads the tables, writes the rows.
        n_rows = tables.spheres.shape[0] + tables.planes.shape[0]
        bound = bound_ms(4 * (sum(t.numel() for t in tables) + n_rows * lights.LIGHT_COLS + 1),
                         fp32=30 * n_rows)
        if scene_name == "cornell_box":
            records[TABLE].update(ms=device_ms, profiler_kept=[kept, 32], host_ms=kernel_s * 1e3,
                                  plain_ms=plain_s * 1e3)
            records[TABLE]["bound_ms"], records[TABLE]["bound_by"] = bound
        print(f"{TABLE} on {scene_name} ({n_rows} rows): kernel {device_ms:.5f} ms on the device "
              f"(profiler, {kept} of 32 kernels kept), {kernel_s * 1e3:.4f} ms by the host clock around a synchronize; plain "
              f"{plain_s * 1e3:.4f} ms; bound {bound[0]:.3g} ms ({bound[1]}) on {card}")

    # K2 against torch.zeros, its plain version and its library call, each
    # given the same torch.device, in five alternating rounds of 200 calls
    # (medians); beside them the two parts of the zero fill's floor:
    # torch.empty, which it and torch.zeros both pay, and its C entry's
    # launch alone.
    rec = records[ZERO]
    dev = torch.device("cuda")
    block = torch.empty((8, 128), device=dev)
    fill = warm._kernel_fn()
    calls = {
        "ms": lambda: warm.zero_block(dev),
        "library_ms": lambda: torch.zeros((8, 128), device=dev),
        "plain_ms": lambda: warm.zero_block_reference(dev),
        "empty": lambda: torch.empty((8, 128), device=dev),
        "launch": lambda: fill(block.data_ptr(), block.numel(), torch._C._cuda_getCurrentRawStream(-1)),
    }
    readings = {key: [] for key in calls}
    for _ in range(5):
        for key, call in calls.items():
            readings[key].append(event_ms(call, 200))
    k2 = {key: statistics.median(ms) for key, ms in readings.items()}
    rec.update(ms=k2["ms"], plain_ms=k2["plain_ms"], library_ms=k2["library_ms"])
    rec["bound_ms"], rec["bound_by"] = bound_ms(8 * 128 * 4)
    print(f"{ZERO}: kernel {k2['ms']:.5f} ms, torch.zeros {k2['library_ms']:.5f} ms "
          f"({k2['ms'] / k2['library_ms']:.3f}x), plain version {k2['plain_ms']:.5f} ms; its floor: "
          f"torch.empty {k2['empty']:.5f} ms + the C entry's launch {k2['launch']:.5f} ms (CUDA "
          f"events, medians of 5 alternating rounds of 200 calls; readings {readings})")

    # The probes at their JAX shapes (CUDA events over 32 launches; the
    # plain versions one run by the host clock). Operations: SCAN_OPS and
    # QUAD_OPS per element and object; bytes: the input read, the output
    # written (and K6's table read).
    def time_probe(name, kern_fn, plain_fn, nbytes, **ops):
        rec = records[name]
        rec["ms"] = event_ms(kern_fn, 32)
        rec["plain_ms"] = timed(plain_fn, reps=1, warmup=False)[0] * 1e3
        rec["bound_ms"], rec["bound_by"] = bound_ms(nbytes, **ops)
        print(f"{name}: kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.2f} ms, bound "
              f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}) on {card}")

    # K4's, K5's and K6's issue floor: the warp instructions their lanes
    # spend on the objects, over the card's schedulers at the SM clock read
    # after the timing (under -fmad=false no product and sum share an FMA).
    def issue_floor(name, lane_objects, key="sass_per_sphere", what="a ray-sphere"):
        per = records[name][key]
        if per is None:  # no cuobjdump
            return
        mhz = sm_clock_mhz()
        schedulers = torch.cuda.get_device_properties(0).multi_processor_count * SCHEDULERS_PER_SM
        records[name]["issue_floor_ms"] = floor = per * lane_objects / 32 / schedulers / (mhz * 1e3)
        print(f"{name}: issue floor {floor:.4f} ms ({per:.2f} SASS instructions {what}, "
              f"{schedulers} schedulers at {mhz:.0f} MHz) on {card}")

    n_obj = scene_table.DEFAULT_N
    o = scene_table.probe_input("cuda")
    tab = scene_table.table(n_obj, "cuda")
    time_probe(BAKED, lambda: scene_table.scan_baked(o, n_obj),
               lambda: scene_table.scan_baked_reference(o, n_obj), 8 * o.numel(),
               fp32=SCAN_OPS[BAKED] * o.numel() * n_obj)
    time_probe(DYNAMIC, lambda: scene_table.scan_dynamic(o, tab),
               lambda: scene_table.scan_dynamic_reference(o, tab), 8 * o.numel() + 16 * n_obj,
               fp32=SCAN_OPS[DYNAMIC] * o.numel() * n_obj)
    for name in (BAKED, DYNAMIC):
        issue_floor(name, o.numel() * n_obj)
    # K4's launches are shorter than the host's: its row is the profiler's
    # kernel time, the chained launches' CUDA-event time beside it.
    for dtype, name in QUAD.items():
        x = bf16_probe.probe_input(getattr(torch, dtype), "cuda")
        time_probe(name, lambda: bf16_probe.quad_probe(x), lambda: bf16_probe.quad_reference(x),
                   2 * x.numel() * x.element_size(),
                   **{k: v * x.numel() * bf16_probe.OBJECTS for k, v in QUAD_OPS[dtype].items()})
        rec = records[name]
        rec["chained_ms"] = rec["ms"]
        rec["ms"], kept = kernel_ms(lambda: bf16_probe.quad_probe(x), 64, "quad_probe")
        rec["profiler_kept"] = [kept, 64]
        print(f"{name}: kernel {rec['ms']:.5f} ms on the device (profiler, {kept} of 64 kernels "
              "kept), "
              f"{rec['chained_ms']:.5f} ms a chained launch (CUDA events)")
        issue_floor(name, x.numel() * bf16_probe.OBJECTS, "sass_per_step", "an (element, object)")
    ms_f32, ms_bf16 = (records[QUAD[dtype]]["ms"] for dtype in ("float32", "bfloat16"))
    print(f"K4 bf16 / f32 throughput on the device: {ms_f32 / ms_bf16:.3f}x on {card}")

    records.update(draws_phase(ptxas, listings, card))

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
    phase_done()

    phase("6. the differentiable mode (torch wavefront under autograd)")
    diff_record = diff_phase("cuda", card)
    for name in (DRAWS, RAY_STREAMS):
        records[name]["launches"] = diff_record["draws_launches_a_step"][name]
    phase_done()

    phase("7. the mesh: K1 through its pixel-id operand, and ranks that share the card")
    mesh_record = mesh_phase(records, (k0, k1, root), card)
    phase_done()

    phase("8. the session at the main path's width: progress, abort, checkpoint, budget, CLI, "
          "native runtime, PNG split, live golden")
    session_record = session_phase(card)
    phase_done()

    check(not spilled, f"megakernel, probe or draws kernels spill: {spilled}")
    kernels = []
    for rec in records.values():
        fracs, errs = rec.pop("fracs"), rec.pop("errs")
        check(rec["launches"] > 0, f"{rec['name']} was not launched by its main path")
        check(None not in (rec["ms"], rec["plain_ms"], rec["bound_ms"]),
              f"{rec['name']} lacks a time")
        kernels.append({**rec, "min_fraction_within_tol": min(fracs), "max_abs_err": max(errs)})
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    print(card)
    print(json.dumps({"diff": diff_record}))
    print(json.dumps({"mesh": mesh_record}))
    print(json.dumps({"session": session_record}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:  # one rank of phase 7, started by spawn_ranks
        sys.exit(rank_main(int(sys.argv[2]), sys.argv[3]))
    if sys.argv[1:2] == ["--cold-split"]:  # one fresh process of phase 8g
        sys.exit(cold_split(sys.argv[2]))
    sys.exit(main())
