"""The dynamic kind on the CPU (the look for a card skipped): the check
passes with the program's plain version and fails with the control (the
reference in bfloat16) and with the animation's own fault, each frame
rendered on the tables of the frame before it; the motion keeps the
spheres apart and above the ground; every new metric resolves to a
reader; and a program whose session cannot be edited fails at once.

The sizes are small: the cell's scene cut to sphere_grid(16) with its
motion, at 12x10, 4 spp and depth 4, and the cell's own 513 spheres once
at 6x5, 2 spp and depth 3."""

import json
import math
from pathlib import Path

import pytest

from cornelis_tpu_torch.scene.library import sphere_grid
from perfbench import harness

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELL = "sphere-grid-512.frame-dynamic"
SMALL = {"width": 12, "height": 10, "spp": 4, "max_depth": 4}
SEED = 2**31 + 5


def _small_config(config):
    """The configuration with sphere_grid(16) in place of its scene, and
    its motion fitted to it."""
    scene = json.loads(json.dumps(sphere_grid(16).to_dict()))
    motion = {**config["motion"], "small_spheres": 16, "sphere_materials": 2}
    return {**config, "scene": scene, "motion": motion}


def _cell(small_scene=True, **traffic):
    cell = harness.load_cell(SPEC, CELL)
    config = _small_config(cell.config) if small_scene else cell.config
    return cell._replace(config=config, traffic={**cell.traffic, **SMALL, **traffic})


def _run(cell, tmp_path, trace=False, seed=SEED):
    return harness.Run(cell=cell, seed=seed, seconds=0.0, trace=trace, device="cpu",
                       out_dir=tmp_path)


def _window(cell, run, fault=None):
    """Set-up, window (one frame, or the frames the traced slice needs)
    and release; the record."""
    import contextlib

    with fault() if fault else contextlib.nullcontext():
        state = cell.kind.setup(run)
        record = cell.kind.window(state, run)
    cell.kind.release(state)
    return record


def test_sound_run_is_correct(tmp_path):
    cell = _cell()
    result = harness.execute(cell, _run(cell, tmp_path))
    assert result["correct"] is True, result["checks"]
    # The plain versions of the program and the reference: the same bits.
    assert result["checks"]["radiance_rel_l1"]["value"] == 0.0


def test_the_cells_own_scene_is_correct_at_a_tiny_size(tmp_path):
    cell = _cell(small_scene=False, width=6, height=5, spp=2, max_depth=3)
    result = harness.execute(cell, _run(cell, tmp_path))
    assert result["correct"] is True, result["checks"]
    assert result["checks"]["radiance_rel_l1"]["value"] == 0.0


def test_control_fails(tmp_path):
    cell = _cell()
    run = _run(cell, tmp_path)
    record = _window(cell, run)
    checks = cell.kind.control(record, run)
    assert not all(c.ok for c in checks), checks


def test_stale_scene_fails(tmp_path):
    cell = _cell()
    run = _run(cell, tmp_path)
    record = _window(cell, run, fault=cell.kind.stale_scene)
    checks = cell.kind.check(record, run)
    assert not all(c.ok for c in checks), checks


def test_the_stale_fault_renders_the_frame_before(tmp_path):
    """Under the fault, frame i's pixels are those of a session updated to
    frame i - 1."""
    cell = _cell()
    run = _run(cell, tmp_path)
    stale = _window(cell, run, fault=cell.kind.stale_scene)["check_values"][0]
    state = cell.kind.setup(run)
    session, scenes = state["session"], state["scenes"]
    session.update_scene(scenes[-1])
    image = session.render().image.reshape(-1, 3)
    cell.kind.release(state)
    pixels = cell.kind.check_pixels(SEED, 0, 12 * 10, cell.kind.CHECK_PIXELS)
    assert (image[pixels] == stale).all()


def test_motion_keeps_spheres_apart_and_above_the_ground():
    cell = harness.load_cell(SPEC, CELL)
    config, kind = cell.config, cell.kind
    m = config["motion"]
    assert m["small_spheres"] == len(config["scene"]["spheres"]) - 1 == 512
    assert kind.cycle(config) == 64
    base = config["scene"]
    for index in (-1, 0, 1, 5, 63, 64):
        scene = kind.frame_scene(config, index)
        small = scene["spheres"][:512]
        lifts = [s["center"][1] - b["center"][1] for s, b in zip(small, base["spheres"])]
        assert all(0.0 <= x <= m["lift"] for x in lifts)
        assert scene["spheres"][512] == base["spheres"][512]  # the sky
        assert all(s["center"][1] - s["radius"] >= 0.0 for s in small)
        lit = [i for i, mat in enumerate(scene["materials"]) if mat["emissive"] == [20.0] * 3]
        assert lit == [2 + index % 64]
        assert scene["materials"][66]["emissive"] == [8.0] * 3
    # Grid pitch 3, radii at most 0.75: no two spheres meet at any lift.
    assert max(s["radius"] for s in base["spheres"][:512]) <= 0.75
    xz = sorted((s["center"][0], s["center"][2]) for s in base["spheres"][:512])
    assert min(math.dist(a, b) for a, b in zip(xz, xz[1:])) > 1.5
    assert kind.frame_scene(config, 3) == kind.frame_scene(config, 3 + 64)


NEW_METRICS = ["kernel_ms.dyn", "megakernel_roofline.dyn", "frame_mfu.dyn",
               "device_idle_share.dyn", "dispatch_ms.dyn", "scene_update_ms.dyn"]


@pytest.mark.parametrize("name", NEW_METRICS)
def test_every_new_metric_resolves_to_a_reader(name):
    entry = next(m for m in SPEC["per_layer"] if m["name"] == name)
    assert entry["workloads"] == [CELL]
    assert harness.metric_file(name).is_file()


def test_a_traced_run_reads_the_programs_spans(tmp_path, monkeypatch):
    """On the CPU there are no device events: the traced run's readers of
    the session's spans and of the frame's work find numbers, the kernel's
    find none. (The profiled slice starts at frame 0 here, so that a
    one-frame window holds it.)"""
    cell = _cell()
    monkeypatch.setattr(cell.kind, "PROFILE_FROM", 0)
    run = _run(cell, tmp_path, trace=True)
    state = cell.kind.setup(run)
    record = cell.kind.window(state, run)
    cell.kind.release(state)
    loaded = harness.load_cell(SPEC, CELL)
    got = harness.read_metrics(loaded.per_layer, record)
    assert {"frame_mfu.dyn", "dispatch_ms.dyn", "scene_update_ms.dyn"} <= set(got)
    assert len(record["scene_update_s"]) == record["profile"]["frames"] == 1
    assert got["scene_update_ms.dyn"]["value"] > 0.0
    assert record["profile"]["dynamic_launches"] == 0  # the CPU's plain version launches nothing


def test_a_reader_of_a_program_without_the_span_returns_nothing():
    reader = harness.load_module(harness.metric_file("scene_update_ms.dyn"), "probe_update")
    assert reader.read({"kind": "frame"}) is None
    assert reader.read({"kind": "frame", "scene_update_s": []}) is None


def test_a_program_that_cannot_edit_its_session_fails_at_once(tmp_path, monkeypatch):
    from cornelis_tpu_torch.render import RenderSession

    monkeypatch.delattr(RenderSession, "update_scene")
    cell = _cell()
    with pytest.raises(RuntimeError, match="update_scene"):
        cell.kind.setup(_run(cell, tmp_path))
