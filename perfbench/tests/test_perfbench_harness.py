"""The harness on the CPU: BENCHMARK.json resolves to its files and keeps
the contract's names, units and pairings; a traced run's last line has its
shape; and the measurement path refuses to run without a card."""

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from perfbench import harness

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./\-]{1,200}$")
ONE_LINE = re.compile(r"^[^\t\n\r]{1,200}$")
RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _metrics():
    return SPEC["end_to_end"] + SPEC["per_layer"]


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_resolves(cell):
    loaded = harness.load_cell(SPEC, cell)
    assert loaded.kind.__name__.endswith(loaded.traffic["kind"])
    for fn in ("setup", "window", "release", "check", "control"):
        assert callable(getattr(loaded.kind, fn))
    assert loaded.limits, "every cell's check has limits"
    assert any(m["name"] == "setup_s" for m in loaded.end_to_end)
    assert len(loaded.end_to_end) >= 2 and loaded.per_layer


@pytest.mark.parametrize("missing, entry", [
    ("perfbench/configs/cornell.json", "config cornell"),
    ("perfbench/traffic/frame-nee.json", "traffic frame-nee"),
    ("perfbench/kinds/inverse.py", "traffic inverse"),
    ("perfbench/limits/cornell.frame.json", "workload cornell.frame"),
    ("perfbench/metrics/png_ms.py", "metric png_ms"),
])
def test_a_missing_file_names_its_entry(tmp_path, missing, entry):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".run"))
    (tmp_path / missing).unlink()
    cell = {"config cornell": "cornell.frame", "traffic frame-nee": "sdf-gallery.frame-nee",
            "traffic inverse": "cornell.inverse", "workload cornell.frame": "cornell.frame",
            "metric png_ms": "cornell.frame-png"}[entry]
    with pytest.raises(harness.SpecError, match=re.escape(entry)):
        harness.load_cell(SPEC, cell, root=tmp_path)


def test_top_level_keys_and_paths():
    assert list(SPEC) == ["command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"]
    assert 1 <= len(SPEC["paths"]) <= 16 and all(PATH.match(p) for p in SPEC["paths"])
    assert len(SPEC["command"]) <= 32 and all(ONE_LINE.match(w) for w in SPEC["command"])
    assert not any(w.startswith("/") or ".." in w for w in SPEC["command"])
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_one_line_fields():
    names = [c["name"] for c in SPEC["configs"]] + CELLS + [m["name"] for m in _metrics()]
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert ONE_LINE.match(c["source"]) and ONE_LINE.match(c["why"])
        assert c["file"].startswith("perfbench/") and (ROOT / c["file"]).is_file()
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4) and ONE_LINE.match(w["why"])
    for m in _metrics():
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert ONE_LINE.match(m.get("layer", "x"))


def test_end_to_end_bounds_and_sources():
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    setup = [m for m in SPEC["end_to_end"] if m["name"] == "setup_s"]
    assert setup and setup[0]["bound"] <= 0.25 and "workloads" not in setup[0]


def _reports(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_each_per_layer_metric_moves_one_metric_its_cells_report(metric):
    m = next(x for x in SPEC["per_layer"] if x["name"] == metric)
    assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    moved = next(x for x in SPEC["end_to_end"] if x["name"] == m["moves"])
    cells = [c for c in CELLS if _reports(m, c)]
    assert cells
    for cell in cells:
        assert _reports(moved, cell), (metric, cell)
    if m["unit"] == "%" and m["name"].endswith("_roofline"):
        assert m["better"] == "higher"


def test_layers_spelled_alike():
    layers = {}
    for m in SPEC["per_layer"]:
        layers.setdefault(m["layer"].split(" (")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values()), layers


def _traced_record():
    """A traced frame run's record as the frame kind fills it."""
    kernels = {"void megakernel<false, false, false, false>(Launch)": [30, 0.0711],
               "Memcpy DtoH (Device -> Pageable)": [4, 0.0004]}
    return {
        "kind": "frame", "attempted": 40, "failed": 0, "frames": 40, "window_s": 4.0,
        "frame_walls_s": [0.095 + 0.001 * i for i in range(40)],
        "rays_per_frame": 512 * 512 * 256, "setup_s": 9.5,
        "dispatch_s": [0.002] * 40, "png_s": [0.05] * 40,
        "work": {"flops": 1.2e11, "bytes": 8.05e8},
        "profile": {"wall_s": 0.38, "busy_s": 0.0715, "kernels": kernels, "frames": 4,
                    "launches": 32, "device_ops": [], "idle_gaps": []},
    }


def test_recorded_traced_line_has_the_cells_metrics():
    line = json.loads((Path(__file__).parent / "data" / "traced_line.json").read_text())
    cell = line.pop("_cell")  # which cell's run printed it
    assert list(line)[:5] == RESULT_KEYS and list(line)[-1] == "checks"
    assert set(line["metrics"]) == {m["name"] for m in SPEC["per_layer"] if _reports(m, cell)}
    for name, m in line["metrics"].items():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
        assert m["unit"] == next(x["unit"] for x in SPEC["per_layer"] if x["name"] == name)
    dev = line["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 1
    assert dev["busy_s"] > 0 and dev["window_s"] > 0 and dev["memory_peak_bytes"] > 0
    for key in ("device_ops", "idle_gaps"):
        assert len(line["breakdown"][key]) <= 10
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}


@pytest.mark.parametrize("cell, suffix", [("sdf-gallery.frame-nee", ""), ("cornell.frame", ".host")])
def test_metric_readers_on_a_traced_record(cell, suffix):
    cell = harness.load_cell(SPEC, cell)
    got = harness.read_metrics(cell.per_layer, _traced_record())
    assert set(got) == {m["name"] for m in cell.per_layer}
    kernel_ms = got["kernel_ms" + suffix]["value"]
    assert kernel_ms == pytest.approx(0.0711 / 30 * 32 / 4 * 1e3)
    least = max(1.2e11 / harness.PEAK_FP32, 8.05e8 / harness.PEAK_BYTES) * 1e3
    assert got["megakernel_roofline" + suffix]["value"] == pytest.approx(100 * least / kernel_ms)
    idle = got["device_idle_share" + (suffix or ".frame")]["value"]
    assert idle == pytest.approx(1 - 0.0715 / 0.38)
    e2e = harness.read_metrics(cell.end_to_end, _traced_record())
    rate = e2e["primary_mrays_per_s" + suffix]["value"]
    assert rate == pytest.approx(40 * 512 * 512 * 256 / 4.0 / 1e6)
    assert set(e2e) == {"primary_mrays_per_s" + suffix, "frame_ms_p95" + suffix, "setup_s"}


def test_metric_readers_of_the_png_cell():
    png = harness.load_cell(SPEC, "cornell.frame-png")
    got = harness.read_metrics(png.per_layer, _traced_record())
    assert set(got) == {"dispatch_ms.png", "png_ms", "kernel_ms.png", "megakernel_roofline.png",
                        "frame_mfu.png", "device_idle_share.png"}
    assert got["png_ms"]["value"] == pytest.approx(50.0)
    assert got["kernel_ms.png"]["value"] == pytest.approx(0.0711 / 30 * 32 / 4 * 1e3)
    e2e = harness.read_metrics(png.end_to_end, _traced_record())
    assert set(e2e) == {"primary_mrays_per_s.png", "setup_s"}


@pytest.mark.parametrize("name, file", [
    ("kernel_ms", "kernel_ms.py"),
    ("kernel_ms.png", "kernel_ms.py"),
    ("device_idle_share.inverse", "device_idle_share.py"),
    ("primary_mrays_per_s.host", "primary_mrays_per_s.py"),
])
def test_a_suffixed_metric_falls_back_to_its_base_reader(name, file):
    assert harness.metric_file(name) == ROOT / "perfbench" / "metrics" / file


def test_a_metric_with_no_reader_names_itself():
    with pytest.raises(harness.SpecError, match=re.escape("metric no_such_ms.png")):
        harness.metric_file("no_such_ms.png")


def test_a_reader_with_nothing_to_read_leaves_its_metric_out():
    cell = harness.load_cell(SPEC, "cornell.frame")
    record = _traced_record()
    del record["profile"], record["png_s"]
    got = harness.read_metrics(cell.per_layer, record)
    assert set(got) == {"dispatch_ms.host", "frame_mfu.host"}


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "cornelis_tpu_torch_fake", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert harness.forbidden_modules() == ["jax.numpy"]


def _run_cli(cwd, *extra):
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "cornell.frame", "--seed", "3",
         "--seconds", "1", "--trace", "0", *extra],
        capture_output=True, text=True, timeout=300, cwd=cwd)


def test_the_measurement_path_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: this test is of a machine without one")
    out = _run_cli(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "torch.cuda.is_available() is false" in out.stderr


def test_a_directory_with_only_the_benchmark_prints_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".run"))
    out = _run_cli(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.cuda
def test_a_short_run_on_the_card_is_correct():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = _run_cli(ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["failed"] == 0
    assert list(line)[:5] == RESULT_KEYS and list(line)[-1] == "checks"
