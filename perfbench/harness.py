"""The benchmark's entry: one run of one cell of BENCHMARK.json.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything about a cell is found by name, so a later change adds a cell,
a configuration, a traffic mix or a metric by adding files and entries:

  * the cell's entry in BENCHMARK.json names a configuration and a traffic
    mix;
  * `configs/<config>.json` holds the configuration (a frozen scene);
  * `traffic/<traffic>.json` holds the mix's parameters, among them its
    `kind`, the generator in `kinds/<kind>.py` that runs it;
  * `limits/<cell>.json` holds the limits of the numbers that decide
    `correct`;
  * `metrics/<metric>.py` reads one metric from a run's record. A metric
    kept apart per cell by a suffix (`kernel_ms.png`) that has no file of
    its own is read by the file of its name without the suffix
    (`metrics/kernel_ms.py`).

A kind module has four functions: `setup(run)` makes the program's
objects and warms up the cell's shapes (its seconds are `setup_s`);
`window(state, run)` drives the program for `run.seconds` and returns the
run's record; `release(state)` drops the program's objects; and
`check(record, run)`, called after the window, the memory reading and the
release, holds what the window produced against the frozen reference in
reference/ and returns the numbers compared.

The run measures only on a CUDA card: with none, or with fewer than the
cell asks for, it exits 2 and prints no result. It exits 3 and prints no
result if the program loaded JAX or the JAX package (`cornelis_tpu`,
compared by whole top-level name) into this process. The last lines of
standard error are the numbers compared, each beside its limit, and the
last line of standard output is the result: `correct`, `attempted`,
`failed`, `metrics`, `device`, with `--trace 1` `breakdown`, and last
`checks`.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, NamedTuple, Optional

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# Top-level module names that may not be loaded once the window has closed.
FORBIDDEN = ("jax", "jaxlib", "flax", "cornelis_tpu")
# The card's published peaks at 700 W (NVIDIA's H100 SXM data sheet): float32
# outside the tensor cores, and device memory bandwidth.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12


class SpecError(ValueError):
    """An entry of BENCHMARK.json that does not resolve to its files."""


class Check(NamedTuple):
    """One number compared with the reference, and its limit: the run is
    correct while value <= limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit  # NaN fails


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    kind: Any  # the kind module
    end_to_end: list  # BENCHMARK.json metric entries that this cell reports
    per_layer: list


@dataclass
class Run:
    """What a kind module is given: the cell, the run's arguments, where it
    may write, the clock its set-up started on, and the seconds of set-up
    that the frozen reference took to make the inputs (left out of
    `setup_s`)."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    out_dir: Path = field(default_factory=lambda: Path(os.environ.get("TMPDIR") or
                                                         BENCH_DIR / ".run"))
    started: float = field(default_factory=time.perf_counter)
    reference_s: float = 0.0

    def note(self, msg: str) -> None:
        print(f"[{self.cell.name}] {msg}", file=sys.stderr, flush=True)


def load_module(path: Path, name: str):
    """The module in file `path` (its name may hold dots)."""
    spec = importlib.util.spec_from_file_location(f"perfbench_{name}", path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module
    spec.loader.exec_module(module)
    return module


def read_json(path: Path, what: str) -> dict:
    if not path.is_file():
        raise SpecError(f"{what}: {path} is missing")
    with open(path) as f:
        return json.load(f)


def load_spec(root: Path = ROOT) -> dict:
    return read_json(root / "BENCHMARK.json", "BENCHMARK.json")


def _reports(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def load_cell(spec: dict, name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of `spec` with its files; SpecError names the entry
    whose file is missing."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SpecError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    entry = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    if entry["config"] not in configs:
        raise SpecError(f"workload {name}: no config {entry['config']!r}")
    config = read_json(root / configs[entry["config"]]["file"], f"config {entry['config']}")
    bench = root / "perfbench"
    traffic = read_json(bench / "traffic" / f"{entry['traffic']}.json",
                        f"workload {name}: traffic {entry['traffic']}")
    kind_path = bench / "kinds" / f"{traffic['kind']}.py"
    if not kind_path.is_file():
        raise SpecError(f"traffic {entry['traffic']}: kind file {kind_path} is missing")
    limits = read_json(bench / "limits" / f"{name}.json", f"workload {name}: limits")
    for metric in spec["end_to_end"] + spec["per_layer"]:
        if _reports(metric, name):
            metric_file(metric["name"], root)
    return Cell(
        name=name,
        chips=int(entry["chips"]),
        config=config,
        traffic=traffic,
        limits=limits,
        kind=load_module(kind_path, f"kind_{traffic['kind']}"),
        end_to_end=[m for m in spec["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in spec["per_layer"] if _reports(m, name)],
    )


def metric_file(name: str, root: Path = ROOT) -> Path:
    """The reader of metric `name`: `metrics/<name>.py`, or else the file of
    the name with its last `.suffix` taken off, and so on; SpecError names
    the metric where none is there."""
    base = name
    while True:
        path = root / "perfbench" / "metrics" / f"{base}.py"
        if path.is_file():
            return path
        if "." not in base:
            raise SpecError(f"metric {name}: perfbench/metrics/{name}.py is missing "
                            f"(nor is there a file of its name without a suffix)")
        base = base.rsplit(".", 1)[0]


def read_metrics(entries: List[dict], record: dict, root: Path = ROOT) -> Dict[str, dict]:
    """{name: {"value", "unit"}} of the metrics whose reader found something
    to read in `record`; a reader that finds nothing returns None and its
    metric is left out."""
    out = {}
    for entry in entries:
        reader = load_module(metric_file(entry["name"], root),
                             "metric_" + entry["name"].replace(".", "_"))
        value = reader.read(record)
        if value is not None:
            out[entry["name"]] = {"value": float(value), "unit": entry["unit"]}
    return out


def forbidden_modules() -> List[str]:
    """Loaded modules whose whole top-level name is forbidden."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them, or why not."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        )
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi failed: {exc}"
    return out.stdout.strip().splitlines()[0]


def require_cards(count: int) -> Optional[str]:
    """Why a run of a cell on `count` cards cannot measure, or None."""
    import torch

    if not torch.cuda.is_available():
        return "torch.cuda.is_available() is false: the benchmark measures only on a CUDA card"
    if torch.cuda.device_count() < count:
        return f"the cell asks for {count} cards and torch sees {torch.cuda.device_count()}"
    return None


def execute(cell: Cell, run: Run) -> dict:
    """Set-up, window, memory reading, release and check of one run; the
    result record (without the module check, which `main` makes)."""
    import torch

    on_cuda = torch.device(run.device).type == "cuda"
    run.out_dir.mkdir(parents=True, exist_ok=True)
    state = cell.kind.setup(run)
    if on_cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - run.started - run.reference_s
    record = cell.kind.window(state, run)
    record["setup_s"] = setup_s
    peak = 0
    if on_cuda:
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
    cell.kind.release(state)
    del state
    if on_cuda:
        torch.cuda.empty_cache()
    checks = cell.kind.check(record, run)
    failed = int(record.get("failed", 0))
    correct = failed == 0 and all(c.ok for c in checks)
    result = {
        "correct": correct,
        "attempted": int(record["attempted"]),
        "failed": failed,
        "metrics": read_metrics(cell.per_layer if run.trace else cell.end_to_end, record),
        "device": {
            "platform": "gpu" if on_cuda else "cpu",
            "kind": torch.cuda.get_device_name() if on_cuda else "cpu",
            "count": cell.chips,
            "memory_peak_bytes": int(peak),
        },
    }
    if run.trace and "profile" in record:
        prof = record["profile"]
        result["device"]["busy_s"] = prof["busy_s"]
        result["device"]["window_s"] = prof["wall_s"]
        result["breakdown"] = {"device_ops": prof["device_ops"], "idle_gaps": prof["idle_gaps"]}
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    return result


def main(argv=None, started: Optional[float] = None) -> int:
    started = time.perf_counter() if started is None else started
    parser = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json.")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    try:
        cell = load_cell(load_spec(), args.workload)
    except SpecError as exc:
        print(f"perfbench: {exc}", file=sys.stderr)
        return 2
    why = require_cards(cell.chips)
    if why:
        print(f"perfbench: {why}; no result", file=sys.stderr)
        return 2
    run = Run(cell=cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
              started=started)
    run.note(power_limit())
    try:
        result = execute(cell, run)
    except Exception:  # the run's boundary: report, print no result
        traceback.print_exc()
        print("perfbench: the run failed; no result", file=sys.stderr)
        return 1
    loaded = forbidden_modules()
    if loaded:
        print(f"perfbench: the run loaded {loaded}; no result", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


def percentile(values: List[float], q: int) -> float:
    """The q-th percentile of `values` (Python's inclusive quantiles)."""
    import statistics

    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]


def finite(x: float) -> float:
    """x, or 1e30 where it is NaN or infinite, so that such a reading fails
    its limit and prints as a JSON number."""
    return float(x) if math.isfinite(x) else 1e30
