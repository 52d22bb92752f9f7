"""The comparison that decides `correct` can fail: on the CPU, at a size a
test run holds, a run goes through set-up, window, release and check (the
look for a card skipped), and `correct` comes out false with the control
(the reference in bfloat16) in the program's place, and with each fault
that a cell can have planted under the timed path. Without a fault it
comes out true."""

import json
from pathlib import Path

import pytest

from perfbench import faults, harness

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
SMALL = {"frame": {"width": 12, "height": 10, "spp": 8, "max_depth": 8},
         "inverse": {"width": 12, "height": 10, "spp": 4, "max_depth": 4}}
FRAME_CELLS = ["cornell.frame-png", "sdf-gallery.frame-nee", "cornell.frame"]


def _small(name):
    cell = harness.load_cell(SPEC, name)
    return cell._replace(traffic={**cell.traffic, **SMALL[cell.traffic["kind"]]})


def _run(cell, tmp_path, seed=2**31 + 5):
    return harness.Run(cell=cell, seed=seed, seconds=0.0, trace=False, device="cpu",
                       out_dir=tmp_path)


def _execute(name, tmp_path):
    cell = _small(name)
    return harness.execute(cell, _run(cell, tmp_path))


@pytest.mark.parametrize("name", FRAME_CELLS + ["cornell.inverse"])
def test_sound_run_is_correct(name, tmp_path):
    result = _execute(name, tmp_path)
    assert result["correct"] is True, result["checks"]
    assert all(c["value"] == 0.0 for c in result["checks"].values())


@pytest.mark.parametrize("name", FRAME_CELLS + ["cornell.inverse"])
def test_control_fails(name, tmp_path):
    cell = _small(name)
    run = _run(cell, tmp_path)
    state = cell.kind.setup(run)
    record = cell.kind.window(state, run)
    cell.kind.release(state)
    checks = cell.kind.control(record, run)
    assert not all(c.ok for c in checks), checks


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("name", FRAME_CELLS)
def test_frame_faults_fail(name, fault, tmp_path):
    with faults.frame_fault(fault):
        result = _execute(name, tmp_path)
    assert result["correct"] is False, (fault, result["checks"])


@pytest.mark.parametrize("fault", ["state unchanged", "answer altered"])
def test_inverse_faults_from_the_window_on_fail(fault, tmp_path):
    """A fault that starts after set-up's steps is caught by the replay of
    the window's last step, while the first steps still agree. ("half the
    batch" is the loss's pixel weight, fixed when the renderer is built:
    it starts with the first step, and the first steps catch it.)"""
    cell = _small("cornell.inverse")
    run = _run(cell, tmp_path)
    state = cell.kind.setup(run)
    with faults.inverse_fault(fault):
        record = cell.kind.window(state, run)
    cell.kind.release(state)
    checks = {c.name: c for c in cell.kind.check(record, run)}
    assert all(checks[n].ok for n in ("loss_gap", "grad_gap", "change_gap")), checks
    assert not all(checks[n].ok for n in ("last_loss_gap", "last_change_gap")), (fault, checks)


@pytest.mark.parametrize("fault", faults.FAULTS)
def test_inverse_faults_fail(fault, tmp_path):
    with faults.inverse_fault(fault):
        result = _execute("cornell.inverse", tmp_path)
    assert result["correct"] is False, (fault, result["checks"])
