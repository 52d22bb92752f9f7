"""Traffic kind "frame": one closed-loop client rendering whole frames.

Each frame is one `cornelis_tpu_torch.render_scene(scene, RenderOptions(...))`,
as the command line renders one, with seed = (run seed + frame index) mod
2^32: a session built per frame, new samples every frame. The traffic file
gives `integrator`, `sampler`, `width`, `height`, `spp`, `max_depth` and
`png`: with `png` the frame is written to one PNG in the run's directory,
overwritten each frame; without it the image comes back as an array.
A frame's wall runs from the call to its return, the image on the host
and the PNG on disk.

Set-up renders one frame (the index -1) at the cell's shape. The traced
run also counts the frame's work with the frozen reference, warms up the
profiler, wraps `render.render_chunk` (the name RenderSession looks up)
and `Film.save_png` in spans, and profiles frames PROFILE_FROM to
PROFILE_FROM + PROFILE_FRAMES - 1 of the window.

The check: CHECK_PIXELS pixels of every frame, drawn from the run's seed
and the frame index, are kept as the frame returns them; after the window
the frozen reference traces CHECK_FRAMES of the frames (the first, the
last and one drawn from the seed between them) at those pixels, every
sample of each, and `radiance_rel_l1` is the summed absolute gap over the
summed reference radiance. With `png` the last frame's PNG is read back
and `png_count_gap` is its largest 8-bit gap from the reference's encode
of the image that frame returned.
"""

from __future__ import annotations

import contextlib
import gc
import time
import traceback

import numpy as np
import torch

from perfbench import tracing
from perfbench.harness import PEAK_BYTES, PEAK_FP32, Check, finite, power_limit
from perfbench.reference import compile as ref_compile
from perfbench.reference import description as ref_description
from perfbench.reference import frames as ref_frames
from perfbench.reference import lights as ref_lights
from perfbench.reference import png as ref_png
from perfbench.reference import work as ref_work
from perfbench.reference.lowp import rounded_to

CHECK_FRAMES = 3
CHECK_PIXELS = 512
PROFILE_FROM = 2
PROFILE_FRAMES = 4
# A run stops after this many frames that raised.
MAX_FAILED = 3
_MASK32 = (1 << 32) - 1


def frame_seed(run_seed: int, index: int) -> int:
    return (run_seed + index) & _MASK32


def check_pixels(run_seed: int, index: int, n_pixels: int, count: int) -> np.ndarray:
    """The pixels of frame `index` that the check compares, sorted."""
    rng = np.random.default_rng([run_seed & ((1 << 64) - 1), index])
    return np.sort(rng.choice(n_pixels, size=min(count, n_pixels), replace=False))


def checked_frames(run_seed: int, done: list) -> list:
    """Of the completed frame indices `done`, the first, the last and one
    drawn from the seed between them."""
    chosen = {done[0], done[-1]}
    if len(done) > 2:
        rng = np.random.default_rng([run_seed & ((1 << 64) - 1), 1 << 20])
        chosen.add(done[int(rng.integers(1, len(done) - 1))])
    return sorted(chosen)[:CHECK_FRAMES]


def setup(run) -> dict:
    import cornelis_tpu_torch as ct
    from cornelis_tpu_torch import render as ct_render
    from cornelis_tpu_torch.film import Film
    from cornelis_tpu_torch.ops import megakernel

    t = run.cell.traffic
    scene = ct.SceneDescription.from_dict(run.cell.config["scene"])
    png = str(run.out_dir / "perfbench-frame.png") if t["png"] else None

    def options(seed: int):
        return ct.RenderOptions(width=t["width"], height=t["height"], samples_aa=t["spp"],
                                max_depth=t["max_depth"], seed=seed, integrator=t["integrator"],
                                sampler=t["sampler"], output=png, device=run.device)

    ct.render_scene(scene, options(frame_seed(run.seed, -1)))
    state = dict(render_scene=ct.render_scene, scene=scene, options=options, png=png,
                 render_module=ct_render, film_class=Film, megakernel=megakernel)
    if run.trace:
        tracing.warm_profiler(run.device)
        tables, lights = reference_scene(run)
        flops, nbytes, work = ref_work.frame_work(
            tables, lights, frame_seed(run.seed, 0), width=t["width"], height=t["height"],
            spp=t["spp"], max_depth=t["max_depth"], integrator=t["integrator"],
            sampler=t["sampler"])
        ops_ms, bytes_ms = flops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
        run.note(f"frame work (reference, {ref_work.SAMPLE_RAYS} rays scaled to the frame): "
                 f"{flops!r} float32 operations, {nbytes!r} bytes; counts {work}; least time "
                 f"{max(ops_ms, bytes_ms)!r} ms a frame, bound by "
                 f"{'operations' if ops_ms >= bytes_ms else 'bytes'} (67 TFLOP/s float32, "
                 f"3.35 TB/s at 700 W; this card: {power_limit()})")
        state["work"] = {"flops": flops, "bytes": nbytes}
        del tables, lights
        if torch.device(run.device).type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
    return state


def reference_scene(run):
    """The frozen reference's own tables and light table of the cell's
    scene, on the run's device."""
    desc = ref_description.SceneDescription.from_dict(run.cell.config["scene"])
    tables = ref_compile.compile_scene(desc, device=run.device)
    return tables, ref_lights.light_table(tables)


def window(state: dict, run) -> dict:
    t = run.cell.traffic
    n_pixels = t["width"] * t["height"]
    render_scene, scene, options = state["render_scene"], state["scene"], state["options"]
    spans = tracing.Spans() if run.trace else None
    profile: dict = {}
    frames, walls, values = [], [], {}
    attempted = failed = 0
    last_image = None
    with contextlib.ExitStack() as wrappers, contextlib.ExitStack() as profiler:
        if spans is not None:
            wrappers.enter_context(spans.wrap(state["render_module"], "render_chunk",
                                              "render_chunk"))
            wrappers.enter_context(spans.wrap(state["film_class"], "save_png", "save_png"))
        start = time.perf_counter()
        index = 0
        while True:
            if spans is not None and index == PROFILE_FROM:
                launches = state["megakernel"].LAUNCHES
                profiler.enter_context(tracing.profiled(profile, run.device))
            attempted += 1
            t0 = time.perf_counter()
            try:
                with spans.span("render_scene") if spans else contextlib.nullcontext():
                    result = render_scene(scene, options(frame_seed(run.seed, index)))
            except Exception:  # a request's boundary: count it, go on
                traceback.print_exc()
                failed += 1
                if failed >= MAX_FAILED:
                    break
            else:
                t1 = time.perf_counter()
                frames.append((index, t0, t1))
                walls.append(t1 - t0)
                pixels = check_pixels(run.seed, index, n_pixels, CHECK_PIXELS)
                values[index] = result.image.reshape(-1, 3)[pixels].copy()
                last_image = result.image
            index += 1
            if spans is not None and index == PROFILE_FROM + PROFILE_FRAMES:
                profiler.close()
                profile["frames"] = PROFILE_FRAMES
                profile["launches"] = state["megakernel"].LAUNCHES - launches
            if time.perf_counter() - start >= run.seconds:
                break
        window_s = time.perf_counter() - start
        if profile == {} and spans is not None and index > PROFILE_FROM:
            profiler.close()  # the window closed inside the slice
            profile["frames"] = index - PROFILE_FROM
            profile["launches"] = state["megakernel"].LAUNCHES - launches
    record = {
        "kind": "frame",
        "attempted": attempted,
        "failed": failed,
        "frames": len(walls),
        "window_s": window_s,
        "frame_walls_s": walls,
        "rays_per_frame": n_pixels * t["spp"],
        "check_values": values,
        "last_image": last_image,
    }
    if walls:
        q = np.quantile(walls, [0.0, 0.25, 0.5, 0.75, 0.95, 1.0])
        run.note(f"{len(walls)} frames in {window_s!r} s; frame wall min, quartiles, p95, max "
                 f"(ms): {[round(float(x) * 1e3, 3) for x in q]}")
    if spans is not None:
        chunks = spans.spans["render_chunk"]
        record["dispatch_s"] = [
            max(end for s, end in chunks if t0 <= s and end <= t1) - t0
            for _, t0, t1 in frames if any(t0 <= s and end <= t1 for s, end in chunks)
        ]
        record["png_s"] = [end - s for s, end in spans.spans["save_png"]]
        record["work"] = state["work"]
        if profile:
            record["profile"] = profile
            run.note(f"profiled frames {PROFILE_FROM}-{PROFILE_FROM + profile['frames'] - 1}: "
                     f"wall {profile['wall_s']!r} s, {profile['launches']} megakernel launches, "
                     f"kernels kept {[(n, k[0]) for n, k in profile['kernels'].items() if 'megakernel' in n]}, "
                     f"summary {profile['summary_s']!r} s")
    return record


def release(state: dict) -> None:
    state.clear()
    gc.collect()


def _pixel_gap(record: dict, run, lowp: bool) -> float:
    """radiance_rel_l1 of the frames `checked_frames` picks; with `lowp`
    the control: the reference in bfloat16 in the program's place."""
    t = run.cell.traffic
    tables, lights = reference_scene(run)
    done = sorted(record["check_values"])
    num = den = 0.0
    for index in checked_frames(run.seed, done):
        pixels = check_pixels(run.seed, index, t["width"] * t["height"], CHECK_PIXELS)
        kw = dict(width=t["width"], height=t["height"], spp=t["spp"], max_depth=t["max_depth"],
                  integrator=t["integrator"], sampler=t["sampler"])
        seed = frame_seed(run.seed, index)
        ref = ref_frames.pixel_means(tables, lights, seed, torch.from_numpy(pixels), **kw)
        ref = ref.double().cpu().numpy()
        if lowp:
            with rounded_to(torch.bfloat16):
                got = ref_frames.pixel_means(tables, lights, seed, torch.from_numpy(pixels), **kw)
            got = got.double().cpu().numpy()
        else:
            got = record["check_values"][index].astype(np.float64)
        got = np.where(np.isfinite(got), got, 0.0)  # a non-finite value reads as black
        num += float(np.abs(got - ref).sum())
        den += float(np.abs(ref).sum())
        run.note(f"frame {index} (seed {seed}): {len(pixels)} pixels x {t['spp']} spp against "
                 f"the reference{' in bfloat16' if lowp else ''}: gap {float(np.abs(got - ref).sum())!r} "
                 f"of {float(np.abs(ref).sum())!r}")
    return num / den if den > 0 else float("nan")


def _png_gap(record: dict, run, lowp: bool) -> float:
    """The largest 8-bit gap of the last frame's PNG from the reference's
    encode of the image that frame returned; with `lowp` the control's
    PNG, the reference's encode in bfloat16."""
    image = record["last_image"]
    want = ref_frames.srgb8(image).astype(np.int64)
    if lowp:
        with rounded_to(torch.bfloat16):
            got = ref_frames.srgb8(image)
    else:
        got = ref_png.read_png(str(run.out_dir / "perfbench-frame.png"))
    got = np.asarray(got).astype(np.int64)
    if got.shape != want.shape:
        return float("inf")
    return float(np.abs(got - want).max())


def _checks(record: dict, run, lowp: bool) -> list:
    if not record["check_values"]:
        return [Check("radiance_rel_l1", finite(float("nan")),
                      run.cell.limits["radiance_rel_l1"])]
    checks = [Check("radiance_rel_l1", finite(_pixel_gap(record, run, lowp)),
                    run.cell.limits["radiance_rel_l1"])]
    if run.cell.traffic["png"]:
        checks.append(Check("png_count_gap", finite(_png_gap(record, run, lowp)),
                            run.cell.limits["png_count_gap"]))
    return checks


def check(record: dict, run) -> list:
    return _checks(record, run, lowp=False)


def control(record: dict, run) -> list:
    """The numbers `check` compares, with the control in the program's
    place: the reference computed in bfloat16."""
    return _checks(record, run, lowp=True)
