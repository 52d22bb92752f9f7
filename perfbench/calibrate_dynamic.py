#!/usr/bin/env python3
"""The readings that a dynamic cell's limits are set from, with the
animation's own fault.

    python3 perfbench/calibrate_dynamic.py --workload sphere-grid-512.frame-dynamic \
        --seeds 11 12 13 --control-seeds 21 22 23 --fault-seeds 31 32 33 [--seconds 2]

calibrate.py's readings on the CUDA card (for each seed in one process:
set-up, a short window, the check; on `--control-seeds` also the control,
the reference in bfloat16), and for each of `--fault-seeds` the same run
with the kind's `stale_scene` planted: frame i rendered on the tables of
frame i - 1. Prints one JSON line a run, then the largest sound reading
and the smallest of the control and of the fault beside the cell's
limit. Benchmark runs never plant the fault.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from perfbench import calibrate, harness  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--control-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--seconds", type=float, default=2.0)
    args = parser.parse_args(argv)
    cell = harness.load_cell(harness.load_spec(), args.workload)
    why = harness.require_cards(cell.chips)
    if why:
        print(f"calibrate_dynamic: {why}", file=sys.stderr)
        return 2
    print(harness.power_limit(), flush=True)
    worst: dict = {}

    def keep(group, values, pick):
        for name, v in values.items():
            worst.setdefault(group, {})
            worst[group][name] = pick(worst[group].get(name, v), v)

    runs = [(s, "sound") for s in args.seeds] + [(s, "control") for s in args.control_seeds]
    runs += [(s, "stale scene") for s in args.fault_seeds]
    for seed, what in runs:
        t0 = time.perf_counter()
        if what == "stale scene":
            with cell.kind.stale_scene():
                out = calibrate.readings(cell, seed, args.seconds, control=False)
            keep("stale scene", out["program"], min)
        else:
            out = calibrate.readings(cell, seed, args.seconds, control=what == "control")
            keep("sound", out["program"], max)
            if out["control"]:
                keep("control", out["control"], min)
        print(json.dumps({"seed": seed, "run": what, **out,
                          "seconds": time.perf_counter() - t0}), flush=True)
    for name, limit in cell.limits.items():
        print(f"{cell.name} {name}: sound {worst.get('sound', {}).get(name)!r} (largest), control "
              f"{worst.get('control', {}).get(name)!r}, stale scene "
              f"{worst.get('stale scene', {}).get(name)!r} (smallest), limit {limit!r}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
