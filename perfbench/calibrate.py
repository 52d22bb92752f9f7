#!/usr/bin/env python3
"""The readings that a cell's limits are set from, on the CUDA card.

    python3 perfbench/calibrate.py --workload <cell> --seeds 11 12 ... \
        [--control-seeds 21 22 23] [--fault "half the batch" --fault-seeds 31 32 33] \
        [--seconds 0.5]

For each of `--seeds`, in one process: the cell's set-up, a short window
at the cell's own sizes and load (long enough for the check to have its
frames or steps), and the numbers `check` compares: the lower readings.
For each of `--control-seeds` the same run, and the numbers with the
control in the program's place (the reference computed in bfloat16, the
kind's `control`): the upper readings. Prints one JSON line a seed, then
the largest lower and the smallest upper reading of each number beside
the cell's limit. With `--fault`, for each of `--fault-seeds` the same
run with that fault (faults.py) planted under the timed path, and its
numbers. Benchmark runs never run the control or plant a fault.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from perfbench import faults, harness  # noqa: E402


def readings(cell, seed: int, seconds: float, control: bool, device: str = "cuda") -> dict:
    """{"program": {name: value}, "control": {name: value} or None} of one
    seed: set-up, a window of `seconds`, release, check and control."""
    import torch

    run = harness.Run(cell=cell, seed=seed, seconds=seconds, trace=False, device=device)
    run.out_dir.mkdir(parents=True, exist_ok=True)
    state = cell.kind.setup(run)
    record = cell.kind.window(state, run)
    cell.kind.release(state)
    del state
    if device == "cuda":
        torch.cuda.empty_cache()
    out = {"program": {c.name: c.value for c in cell.kind.check(record, run)}, "control": None}
    if control:
        out["control"] = {c.name: c.value for c in cell.kind.control(record, run)}
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--control-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--fault", choices=faults.FAULTS)
    parser.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--seconds", type=float, default=0.5)
    args = parser.parse_args(argv)
    cell = harness.load_cell(harness.load_spec(), args.workload)
    why = harness.require_cards(cell.chips)
    if why:
        print(f"calibrate: {why}", file=sys.stderr)
        return 2
    print(harness.power_limit(), flush=True)
    lower, upper = {}, {}
    for seed in args.seeds + [s for s in args.control_seeds if s not in args.seeds]:
        t0 = time.perf_counter()
        out = readings(cell, seed, args.seconds, control=seed in args.control_seeds)
        print(json.dumps({"seed": seed, **out, "seconds": time.perf_counter() - t0}), flush=True)
        if seed in args.seeds:
            for name, v in out["program"].items():
                lower[name] = max(lower.get(name, v), v)
        for name, v in (out["control"] or {}).items():
            upper[name] = min(upper.get(name, v), v)
    fault = {}
    for seed in args.fault_seeds if args.fault else []:
        with faults.planted(cell.traffic["kind"], args.fault):
            out = readings(cell, seed, args.seconds, control=False)
        print(json.dumps({"seed": seed, "fault": args.fault, **out}), flush=True)
        for name, v in out["program"].items():
            fault[name] = min(fault.get(name, v), v)
    for name, limit in cell.limits.items():
        print(f"{cell.name} {name}: lower {lower.get(name)!r} (largest of {len(args.seeds)} "
              f"seeds), upper {upper.get(name)!r} (smallest of {len(args.control_seeds)} control "
              f"seeds), fault {args.fault!r} {fault.get(name)!r} (smallest of "
              f"{len(args.fault_seeds)} seeds), limit {limit!r}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
