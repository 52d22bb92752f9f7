"""Traffic kind "dynamic": one closed-loop client rendering an animation.

One `cornelis_tpu_torch.RenderSession` a run, made in set-up from frame
0's scene with seed = the run's seed (mod 2^32). Frame i is
`session.update_scene(scene_i)` and then `session.render()`: the edit
writes frame i's rows over the session's tables on the card, and the
frame renders them with the session's key (the same draws every frame).
The traffic file gives `integrator`, `sampler`, `width`, `height`, `spp`
and `max_depth` (`png` must be false: the image comes back as an array).
A frame's wall runs from the update call to the image on the host.

The motion is the configuration's `motion` (`frame_scene`): it builds
each frame's scene as a dict, and the program and the frozen reference
each compile it on their own. It repeats every `cycle` frames, whose
descriptions set-up builds, so the window does no client work but the
two calls.

Set-up renders frame -1 (its edit included). The traced run also counts
the work of frame PROFILE_FROM with the frozen reference (K3's light
table from reference/lights_dyn.py), warms up the profiler, wraps
`render.render_chunk_dynamic` (the name RenderSession looks up) in a
span, and profiles frames PROFILE_FROM to PROFILE_FROM + PROFILE_FRAMES
- 1 of the window with the program's own spans on
(`cornelis_tpu_torch.utils.trace.collect()`), from which
`scene_update_ms` reads the `ct.scene.update` spans. The untraced run
switches no span on.

The check has the frame kind's form: CHECK_PIXELS pixels of every frame,
drawn from the run's seed and the frame index, are kept as the frame
returns them; after the window the frozen reference traces CHECK_FRAMES
frames (the first, the last and one drawn from the seed between them) at
those pixels, every sample, on that frame's own tables and K3's table of
them, and `radiance_rel_l1` is the summed absolute gap over the summed
reference radiance. `control` puts the reference in bfloat16 in the
program's place; `stale_scene` plants the animation's own fault, each
frame rendered on the tables of the frame before it.
"""

from __future__ import annotations

import contextlib
import copy
import gc
import math
import time
import traceback

import numpy as np
import torch

from perfbench import tracing
from perfbench.harness import PEAK_BYTES, PEAK_FP32, Check, finite, power_limit
from perfbench.kinds.frame import CHECK_PIXELS, check_pixels, checked_frames, frame_seed
from perfbench.reference import compile as ref_compile
from perfbench.reference import description as ref_description
from perfbench.reference import frames as ref_frames
from perfbench.reference import lights_dyn as ref_lights_dyn
from perfbench.reference import work as ref_work
from perfbench.reference.lowp import rounded_to

PROFILE_FROM = 2
PROFILE_FRAMES = 4
# A run stops after this many frames that raised.
MAX_FAILED = 3


def frame_scene(config: dict, index: int) -> dict:
    """Frame `index`'s scene, as a dict of `SceneDescription.to_dict()`'s
    form: the configuration's scene moved by its `motion`, which repeats
    every `cycle` frames exactly (the index is taken modulo it first)."""
    m = config["motion"]
    index %= cycle(config)
    scene = copy.deepcopy(config["scene"])
    n = m["small_spheres"]
    for k, sphere in enumerate(scene["spheres"][:n]):
        phase = 2.0 * math.pi * (index / m["period_frames"] + k / n)
        sphere["center"][1] += m["lift"] * (1.0 + math.sin(phase)) / 2.0
    lit = m["first_sphere_material"] + index % m["sphere_materials"]
    scene["materials"][lit]["emissive"] = list(m["emission"])
    return scene


def cycle(config: dict) -> int:
    """Frames after which the motion repeats."""
    m = config["motion"]
    return math.lcm(m["period_frames"], m["sphere_materials"])


def _seed(run) -> int:
    return frame_seed(run.seed, 0)


def setup(run) -> dict:
    import cornelis_tpu_torch as ct
    from cornelis_tpu_torch import render as ct_render
    from cornelis_tpu_torch.ops import megakernel

    if not hasattr(ct.RenderSession, "update_scene"):
        raise RuntimeError("this program's RenderSession has no update_scene: it cannot edit "
                           "a session's scene, which this cell's frames do")
    t = run.cell.traffic
    if t["png"]:
        raise ValueError("the dynamic kind returns each image as an array (png false)")
    config = run.cell.config
    scenes = [ct.SceneDescription.from_dict(frame_scene(config, i)) for i in range(cycle(config))]
    options = ct.RenderOptions(width=t["width"], height=t["height"], samples_aa=t["spp"],
                               max_depth=t["max_depth"], seed=_seed(run),
                               integrator=t["integrator"], sampler=t["sampler"], output=None,
                               device=run.device)
    session = ct.RenderSession(scenes[0], options)
    session.update_scene(scenes[-1])  # frame -1
    session.render()
    state = dict(session=session, scenes=scenes, render_module=ct_render, megakernel=megakernel,
                 trace=None)
    if run.trace:
        from cornelis_tpu_torch.utils import trace

        state["trace"] = trace
        tracing.warm_profiler(run.device)
        tables, lights = reference_scene(run, PROFILE_FROM)
        flops, nbytes, work = ref_work.frame_work(
            tables, lights, _seed(run), width=t["width"], height=t["height"], spp=t["spp"],
            max_depth=t["max_depth"], integrator=t["integrator"], sampler=t["sampler"])
        ops_ms, bytes_ms = flops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
        run.note(f"frame {PROFILE_FROM} work (reference, K3's light table, "
                 f"{ref_work.SAMPLE_RAYS} rays scaled to the frame): {flops!r} float32 "
                 f"operations, {nbytes!r} bytes; counts {work}; least time "
                 f"{max(ops_ms, bytes_ms)!r} ms a frame, bound by "
                 f"{'operations' if ops_ms >= bytes_ms else 'bytes'} (67 TFLOP/s float32, "
                 f"3.35 TB/s at 700 W; this card: {power_limit()})")
        state["work"] = {"flops": flops, "bytes": nbytes}
        del tables, lights
        if torch.device(run.device).type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
    return state


def reference_scene(run, index: int):
    """The frozen reference's own tables of frame `index` and K3's light
    table of them, on the run's device."""
    desc = ref_description.SceneDescription.from_dict(frame_scene(run.cell.config, index))
    tables = ref_compile.compile_scene(desc, device=run.device)
    return tables, ref_lights_dyn.light_table_dyn(tables)


def window(state: dict, run) -> dict:
    t = run.cell.traffic
    n_pixels = t["width"] * t["height"]
    session, scenes, mk = state["session"], state["scenes"], state["megakernel"]
    spans = tracing.Spans() if run.trace else None
    profile: dict = {}
    kept_spans: list = []
    frames, walls, values = [], [], {}
    attempted = failed = 0

    def close_profile(profiled: int) -> None:
        profiler.close()
        profile["frames"] = profiled
        profile["launches"] = mk.LAUNCHES - counts[0]
        profile["dynamic_launches"] = mk.DYNAMIC_TABLE_LAUNCHES - counts[1]

    with contextlib.ExitStack() as wrappers, contextlib.ExitStack() as profiler:
        if spans is not None:
            wrappers.enter_context(spans.wrap(state["render_module"], "render_chunk_dynamic",
                                              "render_chunk_dynamic"))
        start = time.perf_counter()
        index = 0
        while True:
            if spans is not None and index == PROFILE_FROM:
                counts = (mk.LAUNCHES, mk.DYNAMIC_TABLE_LAUNCHES)
                profiler.enter_context(tracing.profiled(profile, run.device))
                kept_spans = profiler.enter_context(state["trace"].collect())
            scene = scenes[index % len(scenes)]
            attempted += 1
            t0 = time.perf_counter()
            try:
                with spans.span("frame") if spans else contextlib.nullcontext():
                    session.update_scene(scene)
                    result = session.render()
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
            index += 1
            if spans is not None and index == PROFILE_FROM + PROFILE_FRAMES:
                close_profile(PROFILE_FRAMES)
            if time.perf_counter() - start >= run.seconds:
                break
        window_s = time.perf_counter() - start
        if profile == {} and spans is not None and index > PROFILE_FROM:
            close_profile(index - PROFILE_FROM)  # the window closed inside the slice
    record = {
        "kind": "frame",
        "attempted": attempted,
        "failed": failed,
        "frames": len(walls),
        "window_s": window_s,
        "frame_walls_s": walls,
        "rays_per_frame": n_pixels * t["spp"],
        "check_values": values,
    }
    if walls:
        q = np.quantile(walls, [0.0, 0.25, 0.5, 0.75, 0.95, 1.0])
        run.note(f"{len(walls)} frames in {window_s!r} s; frame wall min, quartiles, p95, max "
                 f"(ms): {[round(float(x) * 1e3, 3) for x in q]}")
    if spans is not None:
        chunks = spans.spans["render_chunk_dynamic"]
        record["dispatch_s"] = [
            max(end for s, end in chunks if t0 <= s and end <= t1) - t0
            for _, t0, t1 in frames if any(t0 <= s and end <= t1 for s, end in chunks)
        ]
        record["scene_update_s"] = [(s.end_ns - s.start_ns) * 1e-9 for s in kept_spans
                                    if s.name == "ct.scene.update"]
        record["work"] = state["work"]
        if profile:
            record["profile"] = profile
            run.note(f"profiled frames {PROFILE_FROM}-{PROFILE_FROM + profile['frames'] - 1}: "
                     f"wall {profile['wall_s']!r} s, {profile['launches']} megakernel launches, "
                     f"{profile['dynamic_launches']} of them K3's, kernels kept "
                     f"{[(n, k[0]) for n, k in profile['kernels'].items() if 'megakernel' in n or 'stage' in n]}, "
                     f"ct.scene.update spans (ms) "
                     f"{[round(x * 1e3, 3) for x in record['scene_update_s']]}, "
                     f"summary {profile['summary_s']!r} s")
    return record


def release(state: dict) -> None:
    state.clear()
    gc.collect()


def _pixel_gap(record: dict, run, lowp: bool) -> float:
    """radiance_rel_l1 of the frames `checked_frames` picks; with `lowp`
    the control: the reference in bfloat16 in the program's place."""
    t = run.cell.traffic
    done = sorted(record["check_values"])
    num = den = 0.0
    kw = dict(width=t["width"], height=t["height"], spp=t["spp"], max_depth=t["max_depth"],
              integrator=t["integrator"], sampler=t["sampler"])
    for index in checked_frames(run.seed, done):
        tables, lights = reference_scene(run, index)
        pixels = torch.from_numpy(check_pixels(run.seed, index, t["width"] * t["height"],
                                               CHECK_PIXELS))
        ref = ref_frames.pixel_means(tables, lights, _seed(run), pixels, **kw)
        ref = ref.double().cpu().numpy()
        if lowp:
            with rounded_to(torch.bfloat16):
                got = ref_frames.pixel_means(tables, lights, _seed(run), pixels, **kw)
            got = got.double().cpu().numpy()
        else:
            got = record["check_values"][index].astype(np.float64)
        got = np.where(np.isfinite(got), got, 0.0)  # a non-finite value reads as black
        num += float(np.abs(got - ref).sum())
        den += float(np.abs(ref).sum())
        run.note(f"frame {index}: {len(pixels)} pixels x {t['spp']} spp against the reference"
                 f"{' in bfloat16' if lowp else ''}: gap {float(np.abs(got - ref).sum())!r} of "
                 f"{float(np.abs(ref).sum())!r}")
    return num / den if den > 0 else float("nan")


def _checks(record: dict, run, lowp: bool) -> list:
    value = _pixel_gap(record, run, lowp) if record["check_values"] else float("nan")
    return [Check("radiance_rel_l1", finite(value), run.cell.limits["radiance_rel_l1"])]


def check(record: dict, run) -> list:
    return _checks(record, run, lowp=False)


def control(record: dict, run) -> list:
    """The numbers `check` compares, with the control in the program's
    place: the reference computed in bfloat16."""
    return _checks(record, run, lowp=True)


@contextlib.contextmanager
def stale_scene():
    """The fault of an animation: within the block every
    `RenderSession.update_scene` applies the scene of the call before it
    on that session (the first call, its own), so frame i renders frame
    i - 1's tables. Calibration and the CPU tests plant it; a benchmark
    run never does."""
    from cornelis_tpu_torch.render import RenderSession

    original = RenderSession.update_scene
    previous = {}

    def update_scene(self, scene):
        stale = previous.get(id(self), scene)
        previous[id(self)] = scene
        return original(self, stale)

    RenderSession.update_scene = update_scene
    try:
        yield
    finally:
        RenderSession.update_scene = original
